"""Class-head inference stage of the port
(`egs/cityscape/local/class_infer.py` is the reference): loads a
checkpoint, runs the class head over the val/test set, writes
`<dir>/npy/<id>.class.npy` probability maps.

    python -m mergenet_tpu_torch.egs.cityscape.class_infer --dir D \\
        --model D/model_best [flags]"""

import argparse

import numpy as np
import torch

from ...data import ClassDataset, DataLoader
from ...models import tile_predict
from ...utils.inference_utils import class_inference
from ..common import add_device_flag, load_model

parser = argparse.ArgumentParser(description="cityscape class inference")
parser.add_argument("--dir", type=str, required=True,
                    help="experiment directory (output npys go to dir/npy)")
parser.add_argument("--model", type=str, required=True,
                    help="checkpoint to load")
parser.add_argument("--img", type=str, default="data/val")
parser.add_argument(
    "--ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_val.json")
parser.add_argument("--arch", default="pspfpnet", type=str)
parser.add_argument("--num-classes", default=9, type=int)
parser.add_argument("--batch-size", default=1, type=int)
parser.add_argument("--scale", default=1, type=int)
parser.add_argument("--limits", default=None, type=int)
parser.add_argument("--score", action="store_true")
parser.add_argument("--bf16", action="store_true",
                    help="bf16 net compute (float32 probs out)")
parser.add_argument("--caffe", action="store_true",
                    help="caffe-style preprocessing + tiled prediction")
parser.add_argument("--tile-size", default=None, type=int, nargs=2,
                    help="tile window (sx, sy) for tiled prediction")
parser.add_argument("--caffe-weights", default=None, type=str,
                    help="npz from convert_caffe_to_pytorch (released "
                         "PSPNet caffemodel); loads instead of --model")
parser.add_argument("--job", type=int, default=0)
parser.add_argument("--num-jobs", type=int, default=1)
add_device_flag(parser)


def main(argv=None):
    args = parser.parse_args(argv)
    num_classes = args.num_classes
    state, _ = load_model(num_classes, 0, args.arch,
                          None if args.caffe_weights else args.model,
                          args.device, args.bf16)
    if args.caffe_weights:
        from ...utils.weight_import import apply_caffe_weights
        apply_caffe_weights(state.model, np.load(args.caffe_weights),
                            layer=101 if args.arch == "pspnet" else 50)

    dataset = ClassDataset(args.img, args.ann, scale=args.scale,
                           caffe=args.caffe, mode="val",
                           limits=args.limits, job=args.job,
                           num_jobs=args.num_jobs)
    dataloader = DataLoader(dataset, batch_size=args.batch_size)

    tile_fn = None
    if args.tile_size:
        net = state.model.eval()

        @torch.no_grad()
        def tile_fn(img):
            return tile_predict(net, img, num_classes,
                                tuple(args.tile_size))

    class_inference(dataloader, args.dir, state, num_classes,
                    args.batch_size, score=args.score,
                    class_nms=dataset.catNms, tile_predict_fn=tile_fn)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
