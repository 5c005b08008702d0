"""Mask-AP evaluation and core invariants of the PyTorch port against the
JAX package on the CPU: `data/rle.py` (encode, decode, area, iou, merge,
the LEB128 string codec, `frPyObjects` on RLE dicts), `data/coco.py` and
`data/cocoeval.py` on the golden cases of tests/test_cocoeval_golden.py
and on the committed C++ greedy masks of the 8 certification512
fixtures, `e2e.masks_to_results`, and `core/{offsets,config,types}.py`.

Both packages are the same numpy, so every output is required equal:
COCOeval stats bit for bit, RLE bytes and IoUs exactly."""

import contextlib
import copy
import io
import os

import numpy as np
import pytest
import torch

import test_cocoeval_golden as golden
from mergenet_tpu import core as jcore
from mergenet_tpu.core import types as jtypes
from mergenet_tpu.data import rle as jrle
from mergenet_tpu.data.coco import COCO as JCOCO
from mergenet_tpu.data.cocoeval import COCOeval as JCOCOeval
from mergenet_tpu.utils.e2e import masks_to_results as jmasks_to_results
from mergenet_tpu_torch import core as tcore
from mergenet_tpu_torch.core import types as ttypes
from mergenet_tpu_torch.data import COCO as TCOCO
from mergenet_tpu_torch.data import rle as trle
from mergenet_tpu_torch.data.cocoeval import COCOeval as TCOCOeval
from mergenet_tpu_torch.e2e import masks_to_results as tmasks_to_results
from torch_port_helpers import FIX512, JAX_AP, coco_stats

PACKAGES = {"jax": (JCOCO, JCOCOeval), "torch": (TCOCO, TCOCOeval)}


def _stats(pkg, dataset, results, img_ids=None):
    """COCOeval('segm') stats of `results` against the ground truth
    `dataset` with one package's COCO and COCOeval."""
    COCO, COCOeval = PACKAGES[pkg]
    gt = COCO()
    gt.dataset = copy.deepcopy(dataset)
    gt.createIndex()
    return np.asarray(coco_stats(gt, copy.deepcopy(results), img_ids,
                                 COCOeval))


GOLDEN_CASES = sorted(n for n in dir(golden) if n.startswith("test_"))


def test_golden_cases_are_all_here():
    assert len(GOLDEN_CASES) == 8


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_cocoeval_golden_case_matches_reference(case, monkeypatch):
    """Each golden scenario through both packages: stats equal bit for
    bit, and the scenario's own hand-derived asserts hold on them."""
    seen = []

    def both(gts, dts, H=32, W=32):
        imgs = sorted({g["image_id"] for g in gts})
        cat_ids = sorted({g["category_id"] for g in gts}
                         | {d["category_id"] for d in dts})
        dataset = {
            "images": [{"id": i, "height": H, "width": W} for i in imgs],
            "annotations": [dict(g, id=k + 1, area=float(jrle.area(
                g["segmentation"]))) for k, g in enumerate(gts)],
            "categories": [{"id": c, "name": "cat%d" % c} for c in cat_ids],
        }
        ref = _stats("jax", dataset, dts)
        got = _stats("torch", dataset, dts)
        np.testing.assert_array_equal(got, ref)
        seen.append(got)
        return got

    monkeypatch.setattr(golden, "_eval", both)
    getattr(golden, case)()
    assert len(seen) == 1


def _fixture_results(pkg):
    """The committed C++ greedy masks of the 8 fixtures as COCO results,
    through one package's masks_to_results."""
    fn = {"jax": jmasks_to_results, "torch": tmasks_to_results}[pkg]
    out = []
    for i in range(8):
        with np.load(os.path.join(FIX512, "cpp_mask_%d.npz" % i)) as cm:
            mask, cls = cm["mask"].astype(np.int32), cm["classes"]
        out += fn(mask[None], cls[None], [i], list(range(9)))
    return out


@pytest.mark.parametrize("procedure", ["a", "b"])
def test_cocoeval_on_committed_cpp_masks_matches_reference(procedure):
    """Procedure (a): every image of val_ann.json (the reference's
    certification); (b): the 8 fixture images only."""
    import json
    with open(os.path.join(FIX512, "val_ann.json")) as f:
        dataset = json.load(f)
    ids = None if procedure == "a" else range(8)
    ref = _stats("jax", dataset, _fixture_results("jax"), ids)
    got = _stats("torch", dataset, _fixture_results("torch"), ids)
    np.testing.assert_array_equal(got, ref)
    assert 0.05 < got[0] < 1 and got[1] >= got[0]


def test_jax_ap_figures_come_from_the_reference():
    """`JAX_AP`, which chip_smoke.py holds the card to, is what
    tests/jax_certification_ap.py computes with the JAX package: here
    the C++ rows under both procedures and hier over fixtures 0 and 1
    (the full table takes minutes: run the script)."""
    import json
    import jax_certification_ap as jca
    with contextlib.redirect_stdout(io.StringIO()):
        coco = JCOCO(os.path.join(FIX512, "val_ann.json"))
    cpp = [x for i in range(8) for x in jca.results("cpp", i)]
    assert jca.jax_ap(coco, cpp) == JAX_AP["a"]["cpp"]
    assert jca.jax_ap(coco, cpp, range(8)) == JAX_AP["b"]["cpp"]
    hier = jca.results("hier", 0) + jca.results("hier", 1)
    assert jca.jax_ap(coco, hier) == JAX_AP["a01"]["hier"]
    with open(os.path.join(FIX512, "val_ann.json")) as f:
        assert len(json.load(f)["images"]) == 50


def _random_masks(seed, n=6, H=37, W=53):
    rng = np.random.default_rng(seed)
    masks = (rng.random((n, H, W)) < rng.random((n, 1, 1))).astype(np.uint8)
    masks[0] = 0                      # empty
    masks[1] = 1                      # full
    masks[2, 0, 0] = 1                # starts with a one-run
    return masks


@pytest.mark.parametrize("seed", [0, 1])
def test_rle_matches_reference(seed):
    masks = _random_masks(seed)
    jr = [jrle.encode(np.asfortranarray(m)) for m in masks]
    tr = [trle.encode(np.asfortranarray(m)) for m in masks]
    assert tr == jr
    for m, r in zip(masks, tr):
        np.testing.assert_array_equal(trle.decode(r), m)
        np.testing.assert_array_equal(trle.decode(r), jrle.decode(r))
        assert trle.area(r) == jrle.area(r) == int(m.sum())
        as_str = dict(r, counts=r["counts"].decode("ascii"))
        np.testing.assert_array_equal(trle.decode(as_str), m)
    np.testing.assert_array_equal(
        trle.iou(tr[:4], tr[2:], [0, 1, 0, 1]),
        jrle.iou(jr[:4], jr[2:], [0, 1, 0, 1]))
    for intersect in (False, True):
        assert (trle.merge(tr[2:], intersect=intersect)
                == jrle.merge(jr[2:], intersect=intersect))
    assert trle.merge([]) == jrle.merge([])


def test_rle_string_codec_and_uncompressed_rle_match_reference():
    rng = np.random.default_rng(5)
    counts = [0] + rng.integers(1, 5000, 200).tolist()  # negative deltas too
    s = trle._leb_encode(counts)
    assert s == jrle._leb_encode(counts)
    assert trle._leb_decode(s) == jrle._leb_decode(s) == counts
    rle = {"size": [40, 50], "counts": [3, 10, 1987]}
    assert trle.frPyObjects(rle, 40, 50) == jrle.frPyObjects(rle, 40, 50)
    assert (trle.frPyObjects([rle, rle], 40, 50)
            == jrle.frPyObjects([rle, rle], 40, 50))
    assert trle.frPyObjects([], 40, 50) == []
    # polygons (filled by the port's cv2.fillPoly twin), a list and a
    # single flat one, with a vertex on a half and one past the border
    polys = [[1.0, 1.0, 9.0, 1.0, 9.0, 9.0], [3.5, 2.0, 52.0, 20.4, 7.0, 39.6]]
    assert trle.frPyObjects(polys, 40, 50) == jrle.frPyObjects(polys, 40, 50)
    assert (trle.frPyObjects(polys[1], 40, 50)
            == jrle.frPyObjects(polys[1], 40, 50))


def test_masks_to_results_matches_reference():
    rng = np.random.default_rng(2)
    masks = rng.integers(0, 5, (2, 24, 40)).astype(np.int32)
    masks[1][masks[1] == 4] = 0
    classes = np.array([[1, 3, -1, 2, -1], [2, 1, 1, -1, -1]], np.int32)
    cat_ids = [0, 11, 12, 13]
    ref = jmasks_to_results(masks, classes, [7, 9], cat_ids)
    assert len(ref) == 6
    for m, c in ((masks, classes),
                 (torch.from_numpy(masks), torch.from_numpy(classes))):
        assert tmasks_to_results(m, c, [7, 9], cat_ids) == ref


@pytest.mark.parametrize("max_offset,num_offsets", [
    (20, 10), (48, 10), (80, 10), (10, 5), (30, 16), (6, 3)])
def test_generate_offsets_matches_reference(max_offset, num_offsets):
    got = tcore.generate_offsets(max_offset, num_offsets)
    assert got == jcore.generate_offsets(max_offset, num_offsets)
    assert len(got) == num_offsets


@pytest.mark.parametrize("offsets", [
    [(1, 0), (0, 1)], [(1, 0), (0, 0)], [(1, 0), (1, 0)],
    [(1, 0), (-1, 0)], [], [(2, -3), (5, 5), (-5, 4)], [[1, 0]]])
def test_validate_offsets_matches_reference(offsets):
    def verdict(fn):
        try:
            return fn(offsets)
        except (AssertionError, TypeError) as e:
            return type(e).__name__
    assert verdict(tcore.validate_offsets) == verdict(jcore.validate_offsets)


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_core_config_round_trips_between_packages(tmp_path, writer, reader):
    pkgs = {"jax": jcore, "torch": tcore}
    c = pkgs[writer].CoreConfig()
    c.num_classes, c.num_colors, c.padding = 9, 3, 4
    c.offsets = [(1, 0), (0, 2), (-2, -1), (28, -10), (-80, 0)]
    path = tmp_path / "core.config"
    c.write(str(path))
    r = pkgs[reader].CoreConfig()
    r.read(str(path))
    assert (r.num_classes, r.num_colors, r.padding, r.offsets) == (
        9, 3, 4, c.offsets)


def test_type_validators_match_reference():
    cases = []
    for pkg, types, core in (("jax", jtypes, jcore), ("torch", ttypes,
                                                       tcore)):
        c = core.CoreConfig()
        c.num_classes, c.num_colors = 3, 3
        img = np.zeros((8, 10, 3), np.float32)
        mask = np.zeros((8, 10), np.int32)
        out = []
        for x in ({"img": img, "mask": mask, "object_class": [0, 2]},
                  {"img": img, "mask": mask, "object_class": [0, 3]},
                  {"img": img, "mask": mask[:4], "object_class": [1]},
                  {"img": img[..., 0], "mask": mask, "object_class": [1]},
                  {"img": img, "object_class": [1]}, [img]):
            try:
                out.append(types.validate_image_with_mask(x, c))
            except ValueError as e:
                out.append(str(e))
        dim = c.num_colors + c.num_classes + len(c.offsets)
        for x in (np.zeros((4, 5, dim), np.float32),
                  np.zeros((4, 5, dim + 1), np.float32),
                  np.zeros((4, 5), np.float32)):
            try:
                out.append(types.validate_combined_image(x, c))
            except ValueError as e:
                out.append(str(e))
        with pytest.raises(AssertionError):
            types.validate_config(object())
        cases.append(out)
    assert cases[0] == cases[1]
    assert cases[1][0] is None and cases[1][6] is None
    assert sum(isinstance(v, str) for v in cases[1]) == 7
