"""The port's Cityscapes converter against cv2 and the JAX package's:
`data/contours.py::find_contours_external` against
`cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)` (count, order and
every point), `io.read_png_gray` / 16-bit `io.write_png` against
`cv2.imread(IMREAD_UNCHANGED)` / `cv2.imwrite`, and
`egs/cityscape/convert_cityscapes_to_coco.py` against
`egs/cityscape/local/convert_cityscapes_to_coco.py`: byte-identical json
files and the same prints, in instance-id and polygon modes, on
`tests/test_converter.py`'s tree and on a tree rendered from
`data/synthetic.py` scenes.  Seeded with numpy; no JAX compile."""

import filecmp
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "egs", "cityscape", "local"))
import convert_cityscapes_to_coco as jax_convert  # noqa: E402
from test_converter import _make_tree  # noqa: E402

from mergenet_tpu_torch import io  # noqa: E402
from mergenet_tpu_torch.data import synthetic  # noqa: E402
from mergenet_tpu_torch.data.contours import find_contours_external  # noqa
from mergenet_tpu_torch.egs.cityscape import (  # noqa: E402
    convert_cityscapes_to_coco as port_convert)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("val", "train", "test")


def _cv2_contours(mask):
    return list(cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                                 cv2.CHAIN_APPROX_NONE)[0])


def _assert_same_contours(mask):
    got, ref = find_contours_external(mask), _cv2_contours(mask)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.int32 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    return got


def test_contours_first_cases():
    """A 3x3 square, a 1x3 line traced out and back, a lone pixel: the
    last start pixel in raster order first."""
    m = np.zeros((12, 12), np.uint8)
    m[2:5, 2:5] = 1
    m[8, 1:4] = 1
    m[1, 9] = 1
    got = _assert_same_contours(m)
    assert [c.reshape(-1, 2).tolist() for c in got] == [
        [[1, 8], [2, 8], [3, 8], [2, 8]],
        [[2, 2], [2, 3], [2, 4], [3, 4], [4, 4], [4, 3], [4, 2], [3, 2]],
        [[9, 1]]]


def test_contours_blob_in_ring_hole_is_dropped():
    m = np.zeros((20, 20), np.uint8)
    m[2:18, 2:18] = 1
    m[5:15, 5:15] = 0
    assert len(_assert_same_contours(m)) == 1
    m[8:11, 8:11] = 7  # any nonzero is foreground
    assert len(_assert_same_contours(m)) == 1
    m[6, 6] = 1  # a lone pixel in the hole, and a one-pixel-wide ring
    thin = np.zeros((9, 9), np.uint8)
    thin[1:8, 1:8] = 1
    thin[2:7, 2:7] = 0
    thin[4, 4] = 1
    for mask in (m, thin):
        assert len(_assert_same_contours(mask)) == 1


def _shape_masks():
    """(name, mask): lone pixels, lines, diagonals, blobs on every edge
    and corner, several components touching only diagonally."""
    out = []
    for H, W, y, x in ((1, 1, 0, 0), (5, 5, 2, 2), (3, 7, 0, 6)):
        m = np.zeros((H, W), np.uint8)
        m[y, x] = 1
        out.append(("lone %dx%d" % (H, W), m))
    for n in (1, 2, 3, 6):
        out.append(("1x%d" % n, np.ones((1, n), np.uint8)))
        out.append(("%dx1" % n, np.ones((n, 1), np.uint8)))
        m = np.zeros((5, n + 4), np.uint8)
        m[2, 2:2 + n] = 1
        out.append(("row %d" % n, m))
        out.append(("column %d" % n, np.ascontiguousarray(m.T)))
    for d in (np.eye(2, dtype=np.uint8), np.eye(2, dtype=np.uint8)[::-1],
              np.eye(5, dtype=np.uint8)):
        out.append(("diagonal %d" % len(d), np.ascontiguousarray(d)))
    for ys in (slice(0, 3), slice(3, 7), slice(7, 10)):
        for xs in (slice(0, 4), slice(4, 8), slice(8, 12)):
            m = np.zeros((10, 12), np.uint8)
            m[ys, xs] = 1
            m[ys.start, xs.start] = 0  # not a plain rectangle
            out.append(("blob %s %s" % (ys, xs), m))
    m = np.zeros((8, 8), np.uint8)
    m[1:3, 1:3] = m[3:5, 3:5] = m[5, 5] = m[6, 6] = m[0, 7] = m[1, 6] = 1
    out.append(("diagonal chain", m))
    m = np.zeros((9, 11), np.uint8)
    m[1:4, 1:4] = m[4:7, 4:6] = m[1:3, 7:10] = m[7, 0] = m[8, 10] = 1
    out.append(("several", m))
    out.append(("full", np.ones((4, 5), np.uint8)))
    out.append(("empty", np.zeros((4, 5), np.uint8)))
    return out


@pytest.mark.parametrize("name,mask", _shape_masks(),
                         ids=[n for n, _ in _shape_masks()])
def test_contours_shapes_equal_cv2(name, mask):
    _assert_same_contours(mask)


@pytest.mark.parametrize("seed", range(100))
def test_contours_random_masks_equal_cv2(seed):
    """Thresholded noise at 40x60: many components, holes, islands in
    holes and diagonal contacts; every third one smoothed into blobs."""
    rng = np.random.default_rng(seed)
    noise = rng.random((40, 60)).astype(np.float32)
    if seed % 3 == 0:
        noise = cv2.GaussianBlur(noise, (0, 0), 1.0 + seed % 4)
    mask = (noise < np.quantile(noise, 0.2 + 0.6 * rng.random()))
    _assert_same_contours(mask.astype(np.uint8) * (1 + seed % 200))


def test_read_png_gray_equals_cv2(tmp_path):
    rng = np.random.default_rng(0)
    cases = [rng.integers(0, 65536, (37, 53)).astype(np.uint16),
             rng.integers(0, 256, (37, 53)).astype(np.uint8),
             np.full((1, 1), 26001, np.uint16),
             (rng.integers(0, 4, (64, 96)) * 1000 + 24001).astype(np.uint16)]
    for k, a in enumerate(cases):
        path = str(tmp_path / ("cv2_%d.png" % k))
        cv2.imwrite(path, a)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = io.read_png_gray(path)
        assert got.dtype == ref.dtype == a.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        path = str(tmp_path / ("port_%d.png" % k))
        io.write_png(path, a)
        back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)
        np.testing.assert_array_equal(io.read_png_gray(path), a)
        np.testing.assert_array_equal(  # the RGB reader keeps the high byte
            io.read_png_rgb(path), cv2.imread(path)[..., ::-1])


def test_read_png_gray_refuses_other_types(tmp_path):
    path = str(tmp_path / "rgb.png")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="colour type 2 at bit depth 8"):
        io.read_png_gray(path)
    path = str(tmp_path / "interlaced.png")
    io.write_png(path, np.zeros((4, 4), np.uint16))
    data = bytearray(open(path, "rb").read())
    data[28] = 1  # IHDR interlace method: Adam7
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        io.read_png_gray(path)


#: Cityscapes label ids of the certification classes 1-8 (person ...
#: bicycle), and two that the converters skip: sky (no instances) and
#: caravan (an instance class outside the 8)
LABEL_IDS = [24, 25, 26, 27, 28, 31, 32, 33]
LABEL_NAMES = ["person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle"]


def _write_scene_tree(root, H=128, W=256):
    """A gtFine tree over two cities and the three splits from
    `synthetic.make_scene`, with Cityscapes' file names: instance-id
    PNGs (16-bit, cv2's writer), polygon files with one object per
    visible instance plus a group, a stuff label and a too-short
    polygon, and one image whose id PNG is absent.  Val's first aachen
    image holds a car whose visible mask is a ring around a person, with
    a car island inside the person."""
    rng = np.random.RandomState(3)
    for split in SPLITS:
        for city in ("aachen", "bonn"):
            d = os.path.join(root, "gtFine_trainvaltest", "gtFine", split,
                             city)
            os.makedirs(d)
            for i in range(2):
                _, anns = synthetic.make_scene(rng, H, W, 9, 6)
                ids = np.where(np.arange(H)[:, None] < H // 4, 23,
                               7).astype(np.uint16) * np.ones((1, W),
                                                              np.uint16)
                objs = []
                for k, (cls, m) in enumerate(anns):
                    ids[m > 0] = LABEL_IDS[cls - 1] * 1000 + k
                    ys, xs = np.nonzero(m)
                    x0, y0 = int(xs.min()), int(ys.min())
                    x1, y1 = int(xs.max()), int(ys.max())
                    objs.append({"label": LABEL_NAMES[cls - 1], "polygon": [
                        [x0, y0], [x1, y0], [x1, y1], [x0, y1]]})
                if split == "val" and city == "aachen" and i == 0:
                    ids[20:100, 40:200] = 26000 + 50       # the ring car
                    ids[40:80, 80:160] = 24000 + 51        # the person
                    ids[55:60, 110:115] = 26000 + 50       # the island
                    ids[0:3, 0:3] = 29000                  # a caravan
                objs += [{"label": "cargroup", "polygon": [
                    [0, H - 10], [30, H - 10], [30, H - 1], [0, H - 1]]},
                    {"label": "sky", "polygon": [[0, 0], [W - 1, 0],
                                                 [W - 1, 5]]},
                    {"label": "car", "polygon": [[1, 1], [5, 5]]}]
                stem = "%s_%06d_%06d_gtFine" % (city, i, 19)
                with open(os.path.join(d, stem + "_polygons.json"), "w") as f:
                    json.dump({"imgHeight": H, "imgWidth": W,
                               "objects": objs}, f)
                if not (split == "train" and i == 1):
                    cv2.imwrite(os.path.join(d, stem + "_instanceIds.png"),
                                ids)  # <stem> ends in _gtFine
                cv2.imwrite(os.path.join(d, stem + "_labelIds.png"),
                            (ids // 1000).astype(np.uint8))
    return root


def _reference_named(root, dst):
    """A copy of a gtFine tree with each `<stem>_gtFine_instanceIds.png`
    renamed to `<stem>_instanceIds.png`, the name the JAX converter looks
    for (its `seg_file_name`)."""
    shutil.copytree(root, dst)
    for d, _, files in os.walk(dst):
        for f in files:
            if f.endswith("_gtFine_instanceIds.png"):
                os.rename(os.path.join(d, f), os.path.join(
                    d, f.replace("_gtFine_instanceIds", "_instanceIds")))
    return dst


def _convert_both(jax_root, port_root, out, capsys, polygons):
    """Run both converters; assert the same prints and byte-identical
    json files; return the port's val json."""
    jax_convert.convert_cityscapes_instance_only(
        jax_root, os.path.join(out, "jax"), polygons_only=polygons)
    jax_out = capsys.readouterr().out
    port_convert.main(["--dataset-dir", port_root, "--out-dir",
                       os.path.join(out, "port")]
                      + (["--polygons"] if polygons else []))
    assert capsys.readouterr().out == jax_out
    names = ["instancesonly_filtered_gtFine_%s.json" % s for s in SPLITS]
    for name in names:
        assert filecmp.cmp(os.path.join(out, "jax", name),
                           os.path.join(out, "port", name), shallow=False)
    with open(os.path.join(out, "port", names[0])) as f:
        return json.load(f)


@pytest.mark.parametrize("polygons", [False, True])
def test_converter_json_equals_jax_on_test_converter_tree(tmp_path, capsys,
                                                          polygons):
    """`tests/test_converter.py`'s tree names its id png as Cityscapes
    does; the JAX converter reads it once renamed."""
    root = _make_tree(str(tmp_path / "tree"), with_png=True)
    ref = _reference_named(root, str(tmp_path / "ref"))
    for jax_root, port_root in ((ref, ref), (ref, root)):
        val = _convert_both(jax_root, port_root, str(tmp_path / "out"),
                            capsys, polygons)
        shutil.rmtree(str(tmp_path / "out"))
        if polygons:
            assert len(val["annotations"]) == 3
        else:
            names = sorted(a["category_id"] for a in val["annotations"])
            assert names == [1, 3, 3] and not any(
                a["iscrowd"] for a in val["annotations"])


@pytest.mark.parametrize("polygons", [False, True])
def test_converter_json_equals_jax_on_scene_tree(tmp_path, capsys,
                                                 polygons):
    """The port on the Cityscapes-named tree and both on the tree the JAX
    converter reads write the same bytes."""
    root = _write_scene_tree(str(tmp_path / "tree"))
    ref = _reference_named(root, str(tmp_path / "ref"))
    for jax_root, port_root in ((ref, ref), (ref, root)):
        val = _convert_both(jax_root, port_root, str(tmp_path / "out"),
                            capsys, polygons)
        shutil.rmtree(str(tmp_path / "out"))
    crowd = [a for a in val["annotations"] if a["iscrowd"]]
    if polygons:
        assert len(crowd) == 4
        return
    assert not crowd
    ring = [a for a in val["annotations"]
            if a["area"] == 80 * 160 - 40 * 80 + 25]
    assert len(ring) == 1 and len(ring[0]["segmentation"]) == 1  # no island
    assert ring[0]["bbox"] == [40.0, 20.0, 160.0, 80.0]


def test_jax_converter_misses_cityscapes_named_pngs(tmp_path, capsys):
    """The reference quirk the port does not keep: on a tree with
    Cityscapes' `*_gtFine_instanceIds.png` names the JAX converter's
    instance-id mode writes the polygon outlines."""
    root = _write_scene_tree(str(tmp_path / "tree"), H=32, W=64)
    for polygons in (False, True):
        jax_convert.convert_cityscapes_instance_only(
            root, str(tmp_path / str(polygons)), polygons_only=polygons)
    for s in SPLITS:
        name = "instancesonly_filtered_gtFine_%s.json" % s
        assert filecmp.cmp(str(tmp_path / "False" / name),
                           str(tmp_path / "True" / name), shallow=False)


def test_prepare_data_twin_converts_and_links(tmp_path):
    root = _write_scene_tree(str(tmp_path / "download"), H=32, W=64)
    for split in SPLITS:
        d = tmp_path / "download" / "leftImg8bit_trainvaltest" / \
            "leftImg8bit" / split / "aachen"
        d.mkdir(parents=True)
        io.write_png(str(d / "aachen_000000_000019_leftImg8bit.png"),
                     np.zeros((32, 64, 3), np.uint8))
    script = os.path.join(ROOT, "mergenet_tpu_torch", "egs", "cityscape",
                          "prepare_data.sh")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    proc = subprocess.run(["bash", script, "--dataset-dir", root,
                           "--out-dir", "data"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for split in SPLITS:
        assert (tmp_path / "data" / "annotations" / (
            "instancesonly_filtered_gtFine_%s.json" % split)).is_file()
        link = tmp_path / "data" / split / "aachen_000000_000019_leftImg8bit.png"
        assert link.is_symlink() and link.resolve().is_file()
    # a failed conversion fails the script before any link is made
    bad = tmp_path / "download" / "gtFine_trainvaltest" / "gtFine" / "val" / \
        "aachen" / "aachen_000000_000019_gtFine_polygons.json"
    bad.write_text("{")
    proc = subprocess.run(["bash", script, "--dataset-dir", root,
                           "--out-dir", "data2"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not (tmp_path / "data2" / "val").exists()


def test_coco_prepare_data_twin_links(tmp_path):
    for d in ("train2017", "val2017", "annotations"):
        (tmp_path / "coco" / d).mkdir(parents=True)
    script = os.path.join(ROOT, "mergenet_tpu_torch", "egs", "coco",
                          "prepare_data.sh")
    proc = subprocess.run(["bash", script, "--download-dir", "coco",
                           "--out-dir", "data"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for d in ("train2017", "val2017", "annotations"):
        assert (tmp_path / "data" / d).is_symlink()
