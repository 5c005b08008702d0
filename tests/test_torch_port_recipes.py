"""The port's decode-side recipes (`mergenet_tpu_torch/egs/cityscape/
{segment,evaluate,submit}.py`) against the JAX recipes
(`egs/cityscape/local/*.py`, run in this process through their `main`,
with cv2) on the same seeded inputs, and the coco twins of segment (its
oracle mode) and evaluate against `egs/coco/local/*.py`.

Two 64x96 images with four rectangle instances of two categories; the
class and offset maps (C=3, O=5) are made from the instance masks with
seeded noise and a few wrong pixels, and written as the inference
stages write them (`<id>.{class,offset}.npy`, (C, H, W) float32), with
the offset net's training offsets beside them as the port's
`offset_infer` records them.  For the identity seg-size the maps are
of the distance-40 offsets; for the exact 2x shrink (`--seg-size 48
32`) of the distance-80 offsets, as a net trained at 80 makes them.
Either way the port's `segment` derives the `generate_offsets(40, 5)`
that the JAX recipe hard-codes.  At the 2x shrink the 5-channel offset
maps take cv2's area-fast route and the 3-channel class maps its `fma`
route (`data/imgproc.py`).  `segment` decodes them with 'device' (the
hierarchical decode), 'device-exact' and 'python': the pkls must hold
the same results up to instance renaming (sets of (category_id, RLE
counts)), and the overlay PNGs the same pixels.  `evaluate` prints the
same AP tables from those pkls and from a mixed set; `submit` writes
the same txt lines and PNG pixels."""

import contextlib
import importlib.util
import io as _io
import json
import os
import pickle
import sys

import cv2
import numpy as np
import pytest
import torch

from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.core import generate_offsets
from mergenet_tpu_torch.data import rle
from mergenet_tpu_torch.egs.cityscape import evaluate as P_evaluate
from mergenet_tpu_torch.egs.cityscape import segment as P_segment
from mergenet_tpu_torch.egs.cityscape import submit as P_submit
from mergenet_tpu_torch.egs.common import write_offsets

EGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "egs")
H, W, C, O = 64, 96, 3, 5
CATS = [{"id": 11, "name": "car"}, {"id": 12, "name": "person"}]


def jax_recipe(name, dataset="cityscape"):
    """The JAX recipe module `egs/<dataset>/local/<name>.py`."""
    spec = importlib.util.spec_from_file_location(
        "jax_recipe_%s_%s" % (dataset, name),
        os.path.join(EGS, dataset, "local", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(name, argv, dataset="cityscape"):
    """Run the JAX recipe's main() with `argv`; returns its stdout."""
    mod = jax_recipe(name, dataset)
    old = sys.argv
    sys.argv = [name + ".py"] + list(argv)
    out = _io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return out.getvalue()


def run_port(mod, argv):
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(list(argv)) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipes")
    rng = np.random.default_rng(4)
    offsets = generate_offsets(40, O)
    images, anns = [], []
    for i in range(2):
        img = rng.integers(30, 60, (H, W, 3)).astype(np.uint8)
        inst = np.zeros((H, W), np.int32)
        cls = {}
        for k in range(1, 5):
            h, w = (int(v) for v in rng.integers(10, 30, 2))
            y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
            inst[y:y + h, x:x + w] = k
            cls[k] = 1 + k % 2
        for k, c in cls.items():
            m = (inst == k).astype(np.uint8)
            if not m.any():
                continue
            img[m > 0] = (200, 80, 60) if c == 1 else (60, 80, 200)
            r = rle.encode(np.asfortranarray(m))
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": CATS[c - 1]["id"],
                         "segmentation": {"size": r["size"], "counts":
                                          r["counts"].decode("ascii")},
                         "area": int(m.sum()), "iscrowd": 0,
                         "bbox": [0, 0, 1, 1]})
        cv2.imwrite(str(root / ("img%d.png" % i)),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        images.append({"id": 100 + i, "file_name": "img%d.png" % i,
                       "height": H, "width": W})
        # maps: near one-hot classes and sameness from the instances,
        # with noise and a few flipped pixels
        klass = np.zeros((H, W), np.int32)
        for k, c in cls.items():
            klass[inst == k] = c
        cp = np.where(np.arange(C)[:, None, None] == klass, 0.9, 0.05)
        cp = cp + rng.random((C, H, W)) * 0.05
        maps = {"cls": ("class", cp)}
        for d, offs in (("ofs", offsets), ("ofs2x", generate_offsets(80, O))):
            sp = np.empty((O, H, W))
            for o, (di, dj) in enumerate(offs):
                nb = np.full((H, W), -1, np.int32)  # -1: off the image
                if abs(di) < H and abs(dj) < W:
                    ys = slice(max(0, -di), min(H, H - di))
                    xs = slice(max(0, -dj), min(W, W - dj))
                    nb[ys, xs] = inst[max(0, di):min(H, H + di),
                                      max(0, dj):min(W, W + dj)]
                sp[o] = np.where(nb == inst, 0.95, 0.05)
            sp = sp + rng.random((O, H, W)) * 0.04
            flip = rng.random((H, W)) < 0.01
            sp[:, flip] = 1 - sp[:, flip]
            maps[d] = ("offset", sp)
        for d, (name, arr) in maps.items():
            os.makedirs(root / d / "npy", exist_ok=True)
            np.save(root / d / "npy" / ("%d.%s.npy" % (100 + i, name)),
                    arr.astype(np.float32))
    write_offsets(str(root / "ofs"), offsets)
    write_offsets(str(root / "ofs2x"), generate_offsets(80, O))
    ann = root / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": anns,
                               "categories": CATS}))
    return root


def _segment_argv(data, out, decoder, seg_size):
    ofs = "ofs" if seg_size == (W, H) else "ofs2x"
    return ["--dir", str(out), "--class-dir", str(data / "cls"),
            "--offset-dir", str(data / ofs), "--img", str(data),
            "--ann", str(data / "ann.json"), "--num-classes", str(C),
            "--num-offsets", str(O), "--seg-size", *map(str, seg_size),
            "--decoder", decoder, "--visualize"]


def _results(seg_dir, image_id):
    with open(seg_dir / "pkl" / ("%d.pkl" % image_id), "rb") as f:
        res = pickle.load(f)
    return {(r["category_id"], r["segmentation"]["counts"]) for r in res}


@pytest.fixture(scope="module")
def segmented(data):
    """Both packages' segment outputs per (decoder, seg-size)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for decoder in ("device", "device-exact", "python"):
            for seg_size in ((W, H), (W // 2, H // 2)):
                key = (decoder, seg_size)
                tag = "%s_%d" % (decoder, seg_size[0])
                argv = _segment_argv(data, data / "jax", decoder, seg_size)
                run_jax("segment", argv + ["--segment", tag])
                argv = _segment_argv(data, data / "port", decoder, seg_size)
                run_port(P_segment, argv + ["--segment", tag,
                                            "--device", "cpu"])
                out[key] = (data / "jax" / tag, data / "port" / tag)
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("decoder", ["device", "device-exact", "python"])
@pytest.mark.parametrize("shrink", [1, 2])
def test_segment_equals_the_jax_recipe(segmented, decoder, shrink):
    jdir, pdir = segmented[(decoder, (W // shrink, H // shrink))]
    found = 0
    for image_id in (100, 101):
        got, ref = _results(pdir, image_id), _results(jdir, image_id)
        assert got == ref, (image_id, len(got), len(ref))
        found += len(ref)
        np.testing.assert_array_equal(
            TIO.read_png_rgb(str(pdir / "img" / ("%d.png" % image_id))),
            cv2.cvtColor(cv2.imread(str(jdir / "img" / (
                "%d.png" % image_id))), cv2.COLOR_BGR2RGB))
    assert found >= 4  # the decode found instances


def test_segment_derives_the_decode_offsets():
    """The decode's offsets from the offset net's: the Cityscapes
    geometry (1024x2048 maps trained at 80, decoded at 1024x512) gives
    the reference's hard-coded 40; the identity keeps any list; an
    unequal scaling or a list that is not the spiral cannot be
    rescaled."""
    derive = P_segment.decode_offsets
    assert derive(generate_offsets(80, 10), (1024, 2048), (1024, 512)) \
        == generate_offsets(40, 10)
    assert derive(generate_offsets(80, 10), (512, 1024), (1024, 512)) \
        == generate_offsets(80, 10)
    odd = [(1, 0), (0, 1), (-2, 3)]
    assert derive(odd, (H, W), (W, H)) == odd
    with pytest.raises(ValueError, match="unequally"):
        derive(generate_offsets(80, 10), (H, W), (W // 2, H))
    with pytest.raises(ValueError, match="spiral"):
        derive(odd, (H, W), (W // 2, H // 2))
    with pytest.raises(SystemExit, match="offsets.json"):
        run_port(P_segment, ["--dir", "x", "--class-dir", "x",
                             "--offset-dir", "/nonexistent", "--device",
                             "cpu"])


def _ap_lines(text):
    return [ln for ln in text.splitlines() if "Average" in ln
            or "detections" in ln]


def test_evaluate_prints_the_jax_recipes_table(data, segmented):
    # besides the decodes (AP 1 at the identity size, below 1 at the 2x
    # shrink), a mixed set: image 100's ground truth as detections,
    # image 101's device decode at the 2x shrink
    mixed = data / "mixed"
    os.makedirs(mixed / "pkl", exist_ok=True)
    anns = json.loads((data / "ann.json").read_text())["annotations"]
    gt = [{"image_id": 100, "score": 1, "category_id": a["category_id"],
           "segmentation": {"size": a["segmentation"]["size"],
                            "counts": a["segmentation"]["counts"].encode()}}
          for a in anns if a["image_id"] == 100]
    with open(mixed / "pkl" / "100.pkl", "wb") as f:
        pickle.dump(gt, f)
    with open(segmented[("device", (W // 2, H // 2))][0] / "pkl" /
              "101.pkl", "rb") as f:
        decoded = f.read()
    (mixed / "pkl" / "101.pkl").write_bytes(decoded)
    aps = []
    for jdir, pdir in (segmented[("device", (W, H))],
                       segmented[("python", (W // 2, H // 2))],
                       (mixed, mixed)):
        ref = run_jax("evaluate", ["--segment-dir", str(jdir), "--val-ann",
                                   str(data / "ann.json")])
        got = run_port(P_evaluate, ["--segment-dir", str(pdir), "--val-ann",
                                    str(data / "ann.json")])
        assert len(_ap_lines(ref)) == 13
        assert _ap_lines(got) == _ap_lines(ref)
        assert int(_ap_lines(ref)[0].split()[1]) > 0  # detections
        aps.append(float(_ap_lines(ref)[1].split("=")[-1]))
    assert aps[0] == 1 and 0 < aps[1] < 1 and 0 < aps[2] < 1


def test_submit_writes_the_jax_recipes_files(data, segmented):
    jdir, _ = segmented[("device", (W, H))]
    # the same pkls through both: the files must be the same
    run_jax("submit", ["--segment-dir", str(jdir), "--result-dir",
                       str(data / "sub_jax"), "--ann", str(data / "ann.json")])
    run_port(P_submit, ["--segment-dir", str(jdir), "--result-dir",
                        str(data / "sub_port"), "--ann",
                        str(data / "ann.json")])
    names = sorted(os.listdir(data / "sub_jax"))
    assert names == sorted(os.listdir(data / "sub_port"))
    assert sum(n.endswith(".png") for n in names) >= 4
    for n in names:
        a, b = data / "sub_jax" / n, data / "sub_port" / n
        if n.endswith(".txt"):
            assert a.read_text() == b.read_text()
        else:
            got = cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
            assert got.ndim == 2 and got.dtype == np.uint8  # grayscale
            np.testing.assert_array_equal(
                got, cv2.imread(str(a), cv2.IMREAD_UNCHANGED))


def test_coco_oracle_segment_and_evaluate_equal_the_jax_recipes(data):
    """`egs/coco` twins: segment's oracle mode (the ground-truth maps at
    scale 2 decoded by the Python greedy with pruning, the masks sized
    back) and evaluate, against the JAX coco recipes."""
    from mergenet_tpu_torch.egs.coco import evaluate as P_coco_evaluate
    from mergenet_tpu_torch.egs.coco import segment as P_coco_segment
    argv = ["--mode", "oracle", "--img", str(data), "--ann",
            str(data / "ann.json"), "--num-classes", str(C),
            "--num-offsets", str(O), "--visualize"]
    run_jax("segment", ["--dir", str(data / "coco_jax")] + argv, "coco")
    run_port(P_coco_segment, ["--dir", str(data / "coco_port"),
                              "--device", "cpu"] + argv)
    jdir = data / "coco_jax" / "segment"
    pdir = data / "coco_port" / "segment"
    for image_id in (100, 101):
        assert _results(pdir, image_id) == _results(jdir, image_id)
        assert _results(pdir, image_id)
        np.testing.assert_array_equal(
            TIO.read_png_rgb(str(pdir / "img" / ("%d.png" % image_id))),
            cv2.cvtColor(cv2.imread(str(jdir / "img" / (
                "%d.png" % image_id))), cv2.COLOR_BGR2RGB))
    ref = run_jax("evaluate", ["--segment-dir", str(jdir), "--val-ann",
                               str(data / "ann.json")], "coco")
    got = run_port(P_coco_evaluate, ["--segment-dir", str(pdir),
                                     "--val-ann", str(data / "ann.json")])
    assert _ap_lines(got) == _ap_lines(ref)
    assert len(_ap_lines(got)) == 13
