"""Cityscapes gtFine -> COCO instance-segmentation json, without cv2
(`egs/cityscape/local/convert_cityscapes_to_coco.py` is the reference;
the same flags and the same files, byte for byte).

    python -m mergenet_tpu_torch.egs.cityscape.convert_cityscapes_to_coco \\
        --dataset-dir data/cityscapes_download --out-dir data/annotations \\
        [--polygons]

Walks `gtFine_trainvaltest/gtFine/{val,train,test}`, keeps the 8
Cityscapes instance classes and writes
`instancesonly_filtered_gtFine_{val,train,test}.json`.

The reference looks for an image's id png at `<stem>_instanceIds.png`
(`seg_file_name`, `:125-131`), where Cityscapes names it
`<stem>_gtFine_instanceIds.png` (`<stem>` = city_seq_frame); on a
Cityscapes tree it therefore finds none and silently writes the polygon
outlines.  The port reads the png under the reference's name, else under
Cityscapes' own: wherever the reference reads a png the port reads the
same one and writes the same bytes, and on a Cityscapes tree it writes
what the reference writes once the pngs are renamed to the name it
looks for.  `seg_file_name` keeps the reference's value.  Two extraction
modes:
  * instance ids (default): each `*_gtFine_instanceIds.png` (16-bit,
    read by `io.read_png_gray`) holds labelID * 1000 + k for the pixels
    of instance k; each instance's visible mask is traced to polygons
    by `data/contours.py::find_contours_external` (cv2's RETR_EXTERNAL,
    CHAIN_APPROX_NONE; contours of 2 points or fewer dropped).  The
    polygon label file is used where the png is absent;
  * --polygons: the raw `*_polygons.json` outlines (occluded parts
    included; `...group` labels become crowd regions)."""

import argparse
import json
import os

import numpy as np

from ... import io
from ...data.contours import find_contours_external
from . import cityscapes_labels as csl

CATEGORY_INSTANCESONLY = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]


def poly_to_bbox(poly):
    xs = poly[0::2]
    ys = poly[1::2]
    x0, y0 = min(xs), min(ys)
    return [x0, y0, max(xs) - x0, max(ys) - y0]


def poly_area(poly):
    """Shoelace area of a flat [x0, y0, x1, y1, ...] polygon."""
    xs = poly[0::2]
    ys = poly[1::2]
    n = len(xs)
    s = 0.0
    for i in range(n):
        j = (i + 1) % n
        s += xs[i] * ys[j] - xs[j] * ys[i]
    return abs(s) / 2.0


def instances_from_png(png_path):
    """The visible instances of an `*_instanceIds.png`, in increasing id
    order: [(label_name, polygons, area, bbox)].  Ids >= 1000 encode
    labelID * 1000 + instance index; each mask is traced on its bounding
    box, which gives the same contours as the whole image."""
    ids_img = io.read_png_gray(png_path)
    out = []
    for inst_id in np.unique(ids_img):
        if inst_id < 1000:
            continue
        label = csl.id2label.get(int(inst_id) // 1000)
        if label is None or not label.hasInstances:
            continue
        ys, xs = np.nonzero(ids_img == inst_id)
        x0, y0 = int(xs.min()), int(ys.min())
        crop = ids_img[y0:int(ys.max()) + 1, x0:int(xs.max()) + 1] == inst_id
        polys = [(c + np.int32([x0, y0])).reshape(-1).astype(float).tolist()
                 for c in find_contours_external(crop) if c.size > 4]
        if not polys:
            continue
        bbox = [float(xs.min()), float(ys.min()),
                float(xs.max() - xs.min() + 1),
                float(ys.max() - ys.min() + 1)]
        out.append((label.name, polys, float(ys.size), bbox))
    return out


def convert_cityscapes_instance_only(data_dir, out_dir, polygons_only=False):
    sets = ["gtFine_val", "gtFine_train", "gtFine_test"]
    ann_dirs = [
        "gtFine_trainvaltest/gtFine/val",
        "gtFine_trainvaltest/gtFine/train",
        "gtFine_trainvaltest/gtFine/test",
    ]
    json_name = "instancesonly_filtered_%s.json"
    ends_in = "%s_polygons.json"
    img_id = 0
    ann_id = 0

    category_dict = {name: i + 1
                     for i, name in enumerate(CATEGORY_INSTANCESONLY)}

    for data_set, ann_dir in zip(sets, ann_dirs):
        print("Starting %s" % data_set)
        images = []
        annotations = []
        ann_dir = os.path.join(data_dir, ann_dir)
        suffix = ends_in % data_set.split("_")[0]
        for root, _, files in os.walk(ann_dir):
            for filename in sorted(files):
                if not filename.endswith(suffix):
                    continue
                if len(images) % 50 == 0:
                    print("Processed %s images, %s annotations" % (
                        len(images), len(annotations)))
                with open(os.path.join(root, filename)) as f:
                    json_ann = json.load(f)
                image = {
                    "id": img_id,
                    "width": json_ann["imgWidth"],
                    "height": json_ann["imgHeight"],
                    "file_name": filename[:-len(suffix)] +
                    "leftImg8bit.png",
                    "seg_file_name": filename[:-len(suffix)] +
                    "instanceIds.png",
                }
                img_id += 1
                images.append(image)

                png_path = os.path.join(root, image["seg_file_name"])
                if not os.path.exists(png_path):  # Cityscapes' own name
                    png_path = os.path.join(root, filename[:-len(
                        "polygons.json")] + "instanceIds.png")
                if not polygons_only and os.path.exists(png_path):
                    # occlusion-correct visible masks from the id png
                    for name, polys, area, bbox in \
                            instances_from_png(png_path):
                        if name not in category_dict:
                            continue
                        annotations.append({
                            "id": ann_id,
                            "image_id": image["id"],
                            "category_id": category_dict[name],
                            "segmentation": polys,
                            "area": area,
                            "bbox": bbox,
                            "iscrowd": 0,
                        })
                        ann_id += 1
                    continue

                for obj in json_ann.get("objects", []):
                    label = obj["label"]
                    if label.endswith("group"):
                        # group labels become crowd regions of the base class
                        base = label[:-len("group")]
                        if base not in category_dict:
                            continue
                        iscrowd = 1
                        label = base
                    elif label in category_dict:
                        iscrowd = 0
                    else:
                        continue
                    poly = [float(v) for pt in obj["polygon"] for v in pt]
                    if len(poly) < 6:
                        continue
                    annotations.append({
                        "id": ann_id,
                        "image_id": image["id"],
                        "category_id": category_dict[label],
                        "segmentation": [poly],
                        "area": poly_area(poly),
                        "bbox": poly_to_bbox(poly),
                        "iscrowd": iscrowd,
                    })
                    ann_id += 1

        ann_dict = {
            "images": images,
            "categories": [{"id": cid, "name": name}
                           for name, cid in category_dict.items()],
            "annotations": annotations,
        }
        print("Num categories: %s" % len(ann_dict["categories"]))
        print("Num images: %s" % len(images))
        print("Num annotations: %s" % len(annotations))
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, json_name % data_set), "w") as f:
            json.dump(ann_dict, f)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert Cityscapes dataset to COCO format")
    parser.add_argument("--dataset-dir", required=True,
                        help="root of the Cityscapes download")
    parser.add_argument("--out-dir", required=True,
                        help="output directory for the json files")
    parser.add_argument("--polygons", action="store_true",
                        help="use raw gtFine polygon outlines instead of "
                             "the instanceIds.png visible masks")
    args = parser.parse_args(argv)
    convert_cityscapes_instance_only(args.dataset_dir, args.out_dir,
                                     polygons_only=args.polygons)


if __name__ == "__main__":
    main()
