"""Synthetic street-like instance-segmentation dataset in COCO format, the
port's copy of `egs/cityscape/local/make_synthetic_data.py`: the same
`np.random.RandomState` stream draw for draw, so a seed gives the same
images pixel for pixel and the same annotation json key for key.  PNGs
go through `io.write_png` (cv2 is not used), RLE through the port's
`data/rle.py`.

Scenes: textured background + coloured rectangles and ellipses per class
with occlusion, colour jitter and noise; class identity is colour-coded
so the task is learnable but not trivial.

    python -m mergenet_tpu_torch.data.synthetic --out-dir DIR \\
        [--train-images 60 --val-images 12 --height 256 --width 512 \\
         --num-classes 9 --max-objects 8 --seed 0]

writes DIR/{train,val}/<split>_NNNNN.png and
DIR/annotations/instancesonly_{train,val}.json; the val split draws from
seed + 1.  The certification workload (`certify.py`) uses seed 100,
60 train and 50 val images of 512x1024 and 9 classes."""

import argparse
import colorsys
import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

from .. import io
from . import rle as maskUtils

# per-class base colors (RGB), class ids 1..8
CLASS_COLORS = [
    (200, 60, 60), (60, 200, 60), (60, 60, 200), (200, 200, 60),
    (200, 60, 200), (60, 200, 200), (230, 140, 40), (140, 90, 40),
]


def class_color(cls, num_classes):
    """Base RGB for class id `cls` (1..num_classes-1): the hand-picked
    table for the first 8 classes, then a deterministic HSV wheel."""
    if cls - 1 < len(CLASS_COLORS):
        return np.array(CLASS_COLORS[cls - 1], np.float32)
    k = cls - 1 - len(CLASS_COLORS)
    n_extra = max(1, num_classes - 1 - len(CLASS_COLORS))
    h = (k / n_extra + 0.07) % 1.0
    v = 0.55 + 0.35 * ((k % 3) / 2.0)
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, v)
    return np.array([r * 255, g * 255, b * 255], np.float32)


def make_scene(rng, H, W, num_classes, max_objects):
    """One (H, W, 3) uint8 RGB scene and its [(class, (H, W) uint8 visible
    mask)], drawing from `rng` in the reference's order."""
    img = np.zeros((H, W, 3), np.float32)
    # background: smooth gradient + texture
    gy = np.linspace(0, 1, H)[:, None]
    gx = np.linspace(0, 1, W)[None, :]
    img[..., 0] = 40 + 30 * gy
    img[..., 1] = 40 + 30 * gx
    img[..., 2] = 50 + 20 * gy * gx
    img += rng.normal(0, 6, img.shape)

    inst = np.zeros((H, W), np.int32)
    anns = []
    n_obj = rng.randint(3, max_objects + 1)
    for k in range(1, n_obj + 1):
        cls = rng.randint(1, num_classes)
        color = class_color(cls, num_classes) + rng.normal(0, 12, 3)
        h = rng.randint(H // 8, H // 2)
        w = rng.randint(W // 10, W // 3)
        y = rng.randint(0, H - h)
        x = rng.randint(0, W - w)
        m = np.zeros((H, W), np.uint8)
        if rng.rand() < 0.5:
            m[y:y + h, x:x + w] = 1
        else:
            yy, xx = np.ogrid[:H, :W]
            cy, cx = y + h // 2, x + w // 2
            m[((yy - cy) / (h / 2)) ** 2 +
              ((xx - cx) / (w / 2)) ** 2 <= 1.0] = 1
        # later objects occlude earlier ones
        inst[m > 0] = k
        img[m > 0] = color + rng.normal(0, 5, img[m > 0].shape)
        anns.append((cls, k))

    # per-instance visible masks after occlusion; fully occluded dropped
    out_anns = []
    for cls, inst_id in anns:
        m = (inst == inst_id).astype(np.uint8)
        if m.sum() < 16:
            continue
        out_anns.append((cls, m))
    img = np.clip(img + rng.normal(0, 4, img.shape), 0, 255)
    return img.astype(np.uint8), out_anns


def write_split(out_dir, split, n_images, H, W, num_classes, max_objects,
                seed):
    """Write one split's PNGs and its `instancesonly_<split>.json`;
    returns the number of annotations.  The PNGs are compressed on a
    second thread while the next scene is drawn."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, split)
    os.makedirs(img_dir, exist_ok=True)
    images, annotations, written = [], [], []
    with ThreadPoolExecutor(1) as writer:
        for i in range(n_images):
            img, anns = make_scene(rng, H, W, num_classes, max_objects)
            fname = "{}_{:05d}.png".format(split, i)
            written.append(writer.submit(
                io.write_png, os.path.join(img_dir, fname), img))
            images.append({"id": i, "file_name": fname, "height": H,
                           "width": W})
            for cls, m in anns:
                r = maskUtils.encode(np.asfortranarray(m))
                annotations.append({
                    "id": len(annotations) + 1, "image_id": i,
                    "category_id": cls,
                    "segmentation": {"size": r["size"],
                                     "counts": r["counts"].decode("ascii")},
                    "area": int(m.sum()), "iscrowd": 0,
                    "bbox": [0, 0, 1, 1]})
    for w in written:  # a failed write raises here
        w.result()
    cats = [{"id": c, "name": "class{}".format(c)}
            for c in range(1, num_classes)]
    ann_dir = os.path.join(out_dir, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    with open(os.path.join(
            ann_dir, "instancesonly_{}.json".format(split)), "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)
    print("{}: {} images, {} annotations".format(
        split, len(images), len(annotations)))
    return len(annotations)


def generate(out_dir, train_images=60, val_images=12, height=256,
             width=512, num_classes=9, max_objects=8, seed=0):
    """Both splits as the reference CLI writes them (val from seed + 1),
    each in a process of its own when both have images (each split is one
    random stream, so the files are the same as written one after the
    other); returns the seconds taken."""
    t = time.perf_counter()
    jobs = [("train", train_images, seed), ("val", val_images, seed + 1)]
    if train_images > 0 and val_images > 0:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(2, mp_context=ctx) as pool:
            for f in [pool.submit(write_split, out_dir, split, n, height,
                                  width, num_classes, max_objects, s)
                      for split, n, s in jobs]:
                f.result()
    else:
        for split, n, s in jobs:
            write_split(out_dir, split, n, height, width, num_classes,
                        max_objects, s)
    return time.perf_counter() - t


def main(argv=None):
    p = argparse.ArgumentParser(description="synthetic dataset generator")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--train-images", type=int, default=60)
    p.add_argument("--val-images", type=int, default=12)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num-classes", type=int, default=9,
                   help="incl. background")
    p.add_argument("--max-objects", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    generate(a.out_dir, a.train_images, a.val_images, a.height, a.width,
             a.num_classes, a.max_objects, a.seed)


if __name__ == "__main__":
    main()
