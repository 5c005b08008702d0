"""One-shot end-to-end inference of the port
(`egs/cityscape/local/infer_e2e.py` is the reference): net forward and
the card's merge decode per batch, no npy handoff between stages.

Requires an 'all'-mode checkpoint (class and offset heads in one
model).  Writes the same per-image COCO-result pkls as the staged
stages, so evaluate and submit work unchanged.  `--data-parallel`
under `torchrun` with more than one rank shards each batch over the
ranks (`serving.build_serving_pipeline(mesh=...)`); rank 0 writes.

    python -m mergenet_tpu_torch.egs.cityscape.infer_e2e --dir D \\
        --model D/model_best [flags]"""

import argparse
import os
import pickle

import numpy as np
import torch.distributed as dist

from ...data import AllDataset, DataLoader
from ...e2e import build_e2e_infer, masks_to_results
from ..common import (add_device_flag, compute_dtype, finish_distributed,
                      init_distributed, load_model)

parser = argparse.ArgumentParser(description="end-to-end inference")
parser.add_argument("--dir", type=str, required=True)
parser.add_argument("--model", type=str, required=True,
                    help="'all'-mode checkpoint")
parser.add_argument("--img", type=str, default="data/val")
parser.add_argument(
    "--ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_val.json")
parser.add_argument("--arch", default="pspfpnet", type=str)
parser.add_argument("--num-classes", default=9, type=int)
parser.add_argument("--num-offsets", default=10, type=int)
parser.add_argument("--batch-size", default=1, type=int)
parser.add_argument("--segment", type=str, default="segment")
parser.add_argument("--decode-size", default=None, type=int, nargs=2,
                    help="(h, w) decode resolution; default half input")
parser.add_argument("--object-merge-factor", type=float, default=1.0)
parser.add_argument("--same-different-bias", type=float, default=0.0)
parser.add_argument("--merge-logprob-bias", type=float, default=0.03)
parser.add_argument("--bf16", action="store_true",
                    help="bf16 net compute")
parser.add_argument("--limits", default=None, type=int)
parser.add_argument("--job", type=int, default=0)
parser.add_argument("--num-jobs", type=int, default=1)
parser.add_argument("--data-parallel", action="store_true",
                    help="under torchrun, shard batches over the ranks "
                         "(the batch size must divide by their count)")
add_device_flag(parser)


def main(argv=None):
    args = parser.parse_args(argv)
    mesh, device = None, args.device
    if args.data_parallel and init_distributed(args.device) \
            and dist.get_world_size() > 1:
        from ...parallel import make_mesh
        mesh = make_mesh(device=args.device if args.device == "cpu"
                         else None)
        device = mesh.device
    state, meta = load_model(args.num_classes, args.num_offsets, args.arch,
                             args.model, device)
    offset_list = meta.get("offsets")
    if not offset_list:
        raise SystemExit("checkpoint is missing the offset list")
    print("offsets are: {}".format(offset_list))

    dataset = AllDataset(args.img, args.ann, args.num_classes, offset_list,
                         mode="test", limits=args.limits, job=args.job,
                         num_jobs=args.num_jobs)
    loader = DataLoader(dataset, batch_size=args.batch_size)
    kw = dict(decode_size=tuple(args.decode_size) if args.decode_size
              else None, dtype=compute_dtype(args.bf16),
              same_different_bias=args.same_different_bias,
              object_merge_factor=args.object_merge_factor,
              merge_logprob_bias=args.merge_logprob_bias)
    n_dev, primary = 1, True
    if mesh is not None:
        from ...serving import build_serving_pipeline
        n_dev, primary = mesh.world, mesh.rank == 0
        infer = build_serving_pipeline(state.model, args.num_classes,
                                       offset_list, mesh=mesh, **kw)
    else:
        infer = build_e2e_infer(state.model, args.num_classes, offset_list,
                                device=args.device, **kw)

    pkl_dir = os.path.join(args.dir, args.segment, "pkl")
    os.makedirs(pkl_dir, exist_ok=True)
    exist = set(next(os.walk(pkl_dir))[2])
    for image_ids, imgs, sizes in loader:
        if all(str(int(i)) + ".pkl" in exist for i in image_ids):
            continue
        n_real = imgs.shape[0]
        if n_real % n_dev:
            # pad the final partial batch to the rank multiple; the
            # padded outputs are dropped below
            pad = n_dev - n_real % n_dev
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)], 0)
        masks, inst_classes = infer(imgs)
        if not primary:
            continue
        results = masks_to_results(masks[:n_real], inst_classes[:n_real],
                                   image_ids, dataset.catIds)
        by_img = {}
        for r in results:
            by_img.setdefault(r["image_id"], []).append(r)
        for i in image_ids:
            with open(os.path.join(pkl_dir,
                                   "{}.pkl".format(int(i))), "wb") as fh:
                pickle.dump(by_img.get(int(i), []), fh)
    print("Done; results in {}".format(pkl_dir))
    finish_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
