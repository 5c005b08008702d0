"""Offset-head inference stage of the port
(`egs/cityscape/local/offset_infer.py` is the reference): the offsets
come from the checkpoint (they are part of the model); writes
`<dir>/npy/<id>.offset.npy` probability maps and the offsets beside
them (`<dir>/npy/offsets.json`, which `segment` reads).

    python -m mergenet_tpu_torch.egs.cityscape.offset_infer --dir D \\
        --model D/model_best [flags]"""

import argparse

from ...data import DataLoader, OffsetDataset
from ...utils.inference_utils import offset_inference
from ..common import add_device_flag, load_model, write_offsets

parser = argparse.ArgumentParser(description="cityscape offset inference")
parser.add_argument("--dir", type=str, required=True)
parser.add_argument("--model", type=str, required=True,
                    help="checkpoint to load")
parser.add_argument("--img", type=str, default="data/val")
parser.add_argument(
    "--ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_val.json")
parser.add_argument("--arch", default="pspfpnet", type=str)
parser.add_argument("--num-offsets", default=10, type=int)
parser.add_argument("--batch-size", default=1, type=int)
parser.add_argument("--scale", default=1, type=int)
parser.add_argument("--limits", default=None, type=int)
parser.add_argument("--score", action="store_true")
parser.add_argument("--bf16", action="store_true",
                    help="bf16 net compute (float32 probs out)")
parser.add_argument("--job", type=int, default=0)
parser.add_argument("--num-jobs", type=int, default=1)
add_device_flag(parser)


def main(argv=None):
    args = parser.parse_args(argv)
    state, meta = load_model(0, args.num_offsets, args.arch, args.model,
                             args.device, args.bf16)
    offset_list = meta.get("offsets")
    if not offset_list:
        raise SystemExit("checkpoint is missing the offset list")
    print("offsets are: {}".format(offset_list))

    dataset = OffsetDataset(args.img, args.ann, offset_list,
                            scale=args.scale, mode="val",
                            limits=args.limits, job=args.job,
                            num_jobs=args.num_jobs)
    dataloader = DataLoader(dataset, batch_size=args.batch_size)
    offset_inference(dataloader, args.dir, state, offset_list,
                     args.batch_size, score=args.score)
    write_offsets(args.dir, offset_list)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
