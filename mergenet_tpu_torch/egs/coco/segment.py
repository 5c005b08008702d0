"""COCO merge-decode stage of the port (`egs/coco/local/segment.py` is
the reference), with the oracle mode: decode the ground-truth
class/offset maps and check that the decoder gives back the annotated
instances.  The default object_merge_factor is 1/num_offsets; the
default decoder is the reference-faithful Python greedy.

    python -m mergenet_tpu_torch.egs.coco.segment --dir D --mode oracle \\
        [flags]"""

import argparse
import os
import pickle
import random

import numpy as np

from ... import io
from ...data import COCODataset, DataLoader, imgproc
from ...utils import generate_offsets
from ...utils.visualization import visualize_mask
from ..common import add_device_flag, convert_to_coco_result, decode

parser = argparse.ArgumentParser(description="coco segmentation")
parser.add_argument("--dir", type=str, required=True)
parser.add_argument("--mode", type=str, default="val",
                    choices=["val", "oracle"])
parser.add_argument("--class-dir", type=str, default=None)
parser.add_argument("--offset-dir", type=str, default=None)
parser.add_argument("--img", type=str, default="data/val2017")
parser.add_argument("--ann", type=str,
                    default="data/annotations/instances_val2017.json")
parser.add_argument("--segment", type=str, default="segment")
parser.add_argument("--num-classes", default=81, type=int)
parser.add_argument("--num-offsets", default=10, type=int)
parser.add_argument("--scale", default=2, type=int)
parser.add_argument("--limits", default=None, type=int)
parser.add_argument("--object-merge-factor", type=float, default=None)
parser.add_argument("--same-different-bias", type=float, default=0.0)
parser.add_argument("--merge-logprob-bias", type=float, default=0.0)
parser.add_argument("--prune-threshold", type=float, default=200.0)
parser.add_argument("--decoder", type=str, default="python",
                    choices=["device", "device-exact", "cpp", "python"])
parser.add_argument("--job", type=int, default=0)
parser.add_argument("--num-jobs", type=int, default=1)
parser.add_argument("--visualize", action="store_true")
add_device_flag(parser)


def main(argv=None):
    random.seed(0)
    np.random.seed(0)
    args = parser.parse_args(argv)
    offset_list = generate_offsets(80 / args.scale, args.num_offsets)
    print("offsets are: {}".format(offset_list))
    if args.object_merge_factor is None:
        args.object_merge_factor = 1.0 / len(offset_list)
    dataset = COCODataset(args.img, args.ann, args.num_classes, offset_list,
                          scale=args.scale, mode=args.mode,
                          limits=args.limits, job=args.job,
                          num_jobs=args.num_jobs)
    segment(args, DataLoader(dataset, batch_size=1),
            os.path.join(args.dir, args.segment), args.num_classes,
            offset_list, dataset.catIds)
    return 0


def segment(args, dataloader, segment_dir, num_classes, offset_list, catIds):
    img_dir = os.path.join(segment_dir, "img")
    pkl_dir = os.path.join(segment_dir, "pkl")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pkl_dir, exist_ok=True)
    exist_ids = set(next(os.walk(pkl_dir))[2])

    for batch in dataloader:
        if args.mode == "oracle":
            image_id, ori_img, size, target = batch
            target = np.asarray(target[0])  # (H, W, C+O)
            class_mask = np.moveaxis(target[..., :num_classes], -1, 0)
            bound_mask = np.moveaxis(target[..., num_classes:], -1, 0)
            img = ori_img[0]
        else:
            image_id, img, size = batch
            class_mask = np.load("{}/npy/{}.class.npy".format(
                args.class_dir, int(image_id[0])))
            bound_mask = np.load("{}/npy/{}.offset.npy".format(
                args.offset_dir, int(image_id[0])))
            img = img[0]
        image_id = int(image_id[0])
        if str(image_id) + ".pkl" in exist_ids:
            continue

        mask, object_class = decode(
            args.decoder, class_mask, bound_mask, num_classes, offset_list,
            args.same_different_bias, args.object_merge_factor,
            args.merge_logprob_bias, args.device,
            prune_threshold=args.prune_threshold)
        oh, ow = int(size[0][0]), int(size[0][1])
        if mask.shape != (oh, ow):
            mask = imgproc.resize(mask.astype(np.int32), (ow, oh),
                                  interpolation=imgproc.INTER_NEAREST)
        if args.visualize:
            io.write_png("{}/{}.png".format(img_dir, image_id),
                         visualize_mask(img, mask, transparency=0.3))
        result = convert_to_coco_result(mask, object_class, image_id,
                                        catIds)
        with open("{}/{}.pkl".format(pkl_dir, image_id), "wb") as fh:
            pickle.dump(result, fh)


if __name__ == "__main__":
    raise SystemExit(main())
