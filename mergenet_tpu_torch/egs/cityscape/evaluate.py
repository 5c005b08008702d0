"""Evaluation stage of the port (`egs/cityscape/local/evaluate.py` is
the reference): collect the per-image result pkls, drop zero-area RLEs,
print COCO-style mask AP; optional class subsetting via a subclass file
and single-image debugging via --imgid.

    python -m mergenet_tpu_torch.egs.cityscape.evaluate --segment-dir S \\
        --val-ann ANN"""

import argparse
import os

from ..common import COCO, evaluate

parser = argparse.ArgumentParser(description="scoring script")
parser.add_argument("--segment-dir", type=str, required=True,
                    help="directory holding the pkl/ subdir of results")
parser.add_argument(
    "--val-ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_val.json")
parser.add_argument("--class-subset", type=str, default=None,
                    help="text file of class names to restrict scoring to")
parser.add_argument("--imgid", type=int, default=None,
                    help="evaluate a single image id")


def main(argv=None):
    args = parser.parse_args(argv)
    coco = COCO(args.val_ann)
    catIds = None
    if args.class_subset and os.path.exists(args.class_subset):
        with open(args.class_subset) as f:
            class_nms = [line.strip() for line in f if line.strip()]
        catIds = coco.getCatIds(catNms=class_nms)
        print("Evaluating on a subset: {}".format(class_nms))
    evaluate(coco, args.segment_dir, catIds, args.imgid)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
