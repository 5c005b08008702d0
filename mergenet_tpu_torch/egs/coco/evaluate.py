"""COCO evaluation stage of the port (`egs/coco/local/evaluate.py` is
the reference): collect the result pkls and print COCO-style mask AP.

    python -m mergenet_tpu_torch.egs.coco.evaluate --segment-dir S \\
        --val-ann ANN"""

import argparse

from ..common import COCO, evaluate

parser = argparse.ArgumentParser(description="coco scoring")
parser.add_argument("--segment-dir", type=str, required=True)
parser.add_argument("--val-ann", type=str,
                    default="data/annotations/instances_val2017.json")
parser.add_argument("--imgid", type=int, default=None)


def main(argv=None):
    args = parser.parse_args(argv)
    evaluate(COCO(args.val_ann), args.segment_dir, imgid=args.imgid)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
