"""Merge-decode stage of the port (`egs/cityscape/local/segment.py` is
the reference): loads each image's class/offset npys, resizes them to
`--seg-size`, decodes instances, writes overlay PNGs (`--visualize`)
and COCO-result pkls.  Decoders: 'device' (the card's hierarchical
decode, default), 'device-exact', 'cpp' (the host C++ greedy), 'python'
(the reference-faithful greedy).  The resizes are cv2's
(`data/imgproc.py`); the overlay is written as RGB PNG (the reference
converts to BGR for `cv2.imwrite`, which stores RGB on disk: the same
file pixels).

The decode's offsets are the offset net's training offsets, which
`offset_infer` writes beside its maps (`<offset-dir>/npy/offsets.json`),
scaled by the seg-size over the maps' size (`decode_offsets`).  The
reference hard-codes `generate_offsets(40, n)`: the training distance
80 of 1024x2048 Cityscapes maps decoded at 512x1024, which this gives.

Idempotent across --job/--num-jobs shards: images with an existing pkl
are skipped.

    python -m mergenet_tpu_torch.egs.cityscape.segment --dir D \\
        --class-dir C --offset-dir O [flags]"""

import argparse
import os
import pickle
import random

import numpy as np

from ... import io
from ...data import AllDataset, DataLoader, imgproc
from ...utils import generate_offsets
from ...utils.visualization import visualize_mask
from ..common import (add_device_flag, convert_to_coco_result, decode,
                      read_offsets)

parser = argparse.ArgumentParser(
    description="cityscapes instance segmentation (PyTorch port)")
parser.add_argument("--dir", type=str, required=True)
parser.add_argument("--class-dir", type=str, required=True,
                    help="directory of class output numpy arrays")
parser.add_argument("--offset-dir", type=str, required=True,
                    help="directory of offset output numpy arrays")
parser.add_argument("--img", type=str, default="data/val")
parser.add_argument(
    "--ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_val.json")
parser.add_argument("--segment", type=str, default="segment")
parser.add_argument("--num-classes", default=9, type=int)
parser.add_argument("--num-offsets", default=10, type=int)
parser.add_argument("--limits", default=None, type=int)
parser.add_argument("--seg-size", default=None, type=int, nargs=2,
                    help="decode at this (W, H); default 1024 512")
parser.add_argument("--object-merge-factor", type=float, default=None)
parser.add_argument("--same-different-bias", type=float, default=0.0)
parser.add_argument("--merge-logprob-bias", type=float, default=0.0)
parser.add_argument("--prune-threshold", type=float, default=0.0)
parser.add_argument("--decoder", type=str, default="device",
                    choices=["device", "device-exact", "cpp", "python"],
                    help="device = the card's hierarchical decode (the "
                         "serving path); device-exact = the exact mode; "
                         "cpp/python = host greedy")
parser.add_argument("--job", type=int, default=0)
parser.add_argument("--num-jobs", type=int, default=1)
parser.add_argument("--visualize", action="store_true")
add_device_flag(parser)


def main(argv=None):
    random.seed(0)
    np.random.seed(0)
    args = parser.parse_args(argv)
    offset_list = read_offsets(args.offset_dir)
    if len(offset_list) != args.num_offsets:
        parser.error("--num-offsets %d, but the offset net has %d offsets"
                     % (args.num_offsets, len(offset_list)))
    print("training offsets are: {}".format(offset_list))
    testset = AllDataset(args.img, args.ann, args.num_classes, offset_list,
                         mode="test", limits=args.limits, job=args.job,
                         num_jobs=args.num_jobs)
    print("Total samples in the dataset to be segmented: {0}".format(
        len(testset)))
    seg_size = tuple(args.seg_size) if args.seg_size else (1024, 512)
    segment(args, DataLoader(testset, batch_size=1),
            os.path.join(args.dir, args.segment), args.num_classes,
            offset_list, seg_size, testset.catIds)
    return 0


def resize_maps(maps, seg_size):
    """(C, H, W) float32 maps resized to `seg_size` (W, H) as the
    reference's `cv2.resize` of the channel-last array."""
    out = imgproc.resize(np.moveaxis(maps, 0, -1), seg_size)
    if out.ndim == 2:  # one channel: cv2 drops the axis
        out = out[..., None]
    return np.ascontiguousarray(np.moveaxis(out, -1, 0))


def decode_offsets(train_offsets, map_hw, seg_size):
    """The offsets of a decode at `seg_size` (W, H) of maps of `map_hw`
    (H, W) from a net trained at `train_offsets`: those offsets at the
    identity size, else `generate_offsets` at the training distance
    scaled by seg-size over map size (the spiral of the reference's
    recipes; another list cannot be rescaled)."""
    (h, w), (sw, sh) = map_hw, seg_size
    train_offsets = [tuple(o) for o in train_offsets]
    if (sw, sh) == (w, h):
        return train_offsets
    if sw * h != sh * w:
        raise ValueError("--seg-size %dx%d scales the %dx%d maps unequally "
                         "in width and height: the offsets cannot follow"
                         % (sw, sh, w, h))
    n = len(train_offsets)
    dist = max(max(abs(x), abs(y)) for x, y in train_offsets)
    if generate_offsets(dist, n) != train_offsets:
        raise ValueError("offsets %s are not generate_offsets(%d, %d): "
                         "only that spiral can be rescaled to --seg-size"
                         % (train_offsets, dist, n))
    return generate_offsets(dist * sw / w, n)


def segment(args, dataloader, segment_dir, num_classes, offset_list,
            seg_size, catIds):
    img_dir = os.path.join(segment_dir, "img")
    pkl_dir = os.path.join(segment_dir, "pkl")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pkl_dir, exist_ok=True)
    exist_ids = set(next(os.walk(pkl_dir))[2])
    omf = args.object_merge_factor if args.object_merge_factor is not None \
        else 1.0  # the original segment.py hardcodes 1
    mlb = args.merge_logprob_bias or 0.03
    shown = None

    for image_id, img, size in dataloader:
        image_id = int(image_id[0])
        if str(image_id) + ".pkl" in exist_ids:
            continue
        class_mask = np.load("{}/npy/{}.class.npy".format(
            args.class_dir, image_id))
        bound_mask = np.load("{}/npy/{}.offset.npy".format(
            args.offset_dir, image_id))
        offsets = decode_offsets(offset_list, bound_mask.shape[1:],
                                 seg_size)
        if offsets != shown:
            print("offsets are: {}".format(offsets))
            shown = offsets
        if seg_size:
            class_mask = resize_maps(class_mask, seg_size)
            bound_mask = resize_maps(bound_mask, seg_size)

        mask, object_class = decode(
            args.decoder, class_mask, bound_mask, num_classes, offsets,
            args.same_different_bias, omf, mlb, args.device)

        if seg_size:
            oh, ow = int(size[0][0]), int(size[0][1])
            mask = imgproc.resize(mask.astype(np.int32), (ow, oh),
                                  interpolation=imgproc.INTER_NEAREST)
        if args.visualize:
            io.write_png("{}/{}.png".format(img_dir, image_id),
                         visualize_mask(img[0], mask, transparency=0.3))

        result = convert_to_coco_result(mask, object_class, image_id,
                                        catIds)
        with open("{}/{}.pkl".format(pkl_dir, image_id), "wb") as fh:
            pickle.dump(result, fh)


if __name__ == "__main__":
    raise SystemExit(main())
