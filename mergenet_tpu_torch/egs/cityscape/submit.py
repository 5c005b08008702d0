"""Submission stage of the port (`egs/cityscape/local/submit.py` is the
reference): convert result pkls into the Cityscapes submission format,
a txt per image listing per-instance grayscale mask PNGs with labelIDs
and confidences.

    python -m mergenet_tpu_torch.egs.cityscape.submit --segment-dir S \\
        --result-dir R --ann ANN"""

import argparse
import os
import pickle

import numpy as np

from ... import io
from ...data import rle as maskUtils
from ..common import COCO

# class id (ours) -> Cityscapes labelID
LABEL_IDS = [0, 24, 25, 26, 27, 28, 31, 32, 33]

parser = argparse.ArgumentParser(description="cityscapes submission")
parser.add_argument("--segment-dir", type=str, required=True)
parser.add_argument("--result-dir", type=str, required=True)
parser.add_argument(
    "--ann", type=str,
    default="data/annotations/instancesonly_filtered_gtFine_test.json")


def main(argv=None):
    args = parser.parse_args(argv)
    coco = COCO(args.ann)
    catIds = [0] + coco.getCatIds()
    os.makedirs(args.result_dir, exist_ok=True)
    pkl_dir = os.path.join(args.segment_dir, "pkl")
    for fname in sorted(os.listdir(pkl_dir)):
        if not fname.endswith(".pkl"):
            continue
        image_id = int(fname[:-4])
        with open(os.path.join(pkl_dir, fname), "rb") as fh:
            result = pickle.load(fh)
        img_name = coco.loadImgs(image_id)[0]["file_name"].split(".")[0]
        img_name = os.path.basename(img_name)
        txt_path = os.path.join(args.result_dir, img_name + ".txt")
        with open(txt_path, "w") as fh:
            for k, ann in enumerate(result, start=1):
                b_mask = maskUtils.decode(ann["segmentation"]) * 255
                png_name = "{}_{}.png".format(img_name, k)
                io.write_png(os.path.join(args.result_dir, png_name),
                             b_mask.astype(np.uint8))
                class_id = catIds.index(ann["category_id"])
                fh.write("{} {} {}\n".format(
                    png_name, LABEL_IDS[class_id], ann.get("score", 1.0)))
    print("Wrote submission files to {}".format(args.result_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
