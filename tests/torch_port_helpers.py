"""Shared pieces of the `test_torch_port_*` tests and `chip_smoke.py`:
fixture paths, offset sets, random absorb planes, class widening,
label-grid comparison up to renaming, and the card check.  Imports no
JAX: the card-only tests and `chip_smoke.py` run where there is none."""

import os

import numpy as np
import pytest

FIX512 = os.path.join(os.path.dirname(__file__), "fixtures",
                      "certification512")
FIX19 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "certification19")

#: decode_hierarchical arguments of the served frame (bench.py)
SERVE_KW = dict(object_merge_factor=1.0, merge_logprob_bias=0.03)

#: the fixture's offsets (certification512/offsets.npy) and the survey's
#: default spiral (core/config.py), which reach past absorb's halo
FIXTURE_OFFSETS = ((1, 0), (0, 2), (-2, -1), (2, -4), (5, 5), (-9, 7),
                   (-9, -16), (28, -10), (9, 48), (-80, 0))
SPIRAL_OFFSETS = ((1, 0), (0, 1), (-2, -1), (1, -2), (3, 2), (-4, 3),
                  (-4, -7), (10, -4), (3, 15), (-21, 0))


def absorb_planes(rng, H, W, O, classes=4, frozen=0.05, ties=True,
                  size_hi=120, comp_lo=-2):
    """Random stage-2 planes of the absorb scan, drawn from `rng` in this
    order: comp ids in [comp_lo, 60) (some negative by default), size in
    [1, size_hi), argcls in [0, classes), frozen (int32, each pixel with
    probability `frozen`), log_odds (O, H, W) float32, quantised to
    halves when `ties` (ties in priority, as on trained maps)."""
    comp = rng.integers(comp_lo, 60, (H, W)).astype(np.int32)
    size = rng.integers(1, size_hi, (H, W)).astype(np.int32)
    argc = rng.integers(0, classes, (H, W)).astype(np.int32)
    froz = (rng.random((H, W)) < frozen).astype(np.int32)
    lo = rng.standard_normal((O, H, W)) * 4
    lo = (np.round(lo) / 2 if ties else lo).astype(np.float32)
    return comp, size, argc, froz, lo


def wide_classes(cp, C=19):
    """Class probabilities widened to C classes: background stays class
    0, class c >= 1 becomes C - c (past the packed stats' 4 class bits
    for c <= C - 16), and the new classes get a small probability."""
    k = cp.shape[-1]
    wide = np.full(cp.shape[:-1] + (C,), 1e-6, np.float32)
    scaled = cp * np.float32(1 - (C - k) * 1e-6)
    wide[..., 0] = scaled[..., 0]
    wide[..., C - np.arange(1, k)] = scaled[..., 1:]
    return wide


def assert_same_partition(a, b, classes_a=None, classes_b=None):
    """Two label grids are the same partition up to renaming of ids
    (a bijection between their ids); with instance-class tables, matched
    instances (ids >= 1) also carry the same class."""
    a = np.asarray(a).ravel().astype(np.int64)
    b = np.asarray(b).ravel().astype(np.int64)
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    assert len(pairs) == len(np.unique(a)) == len(np.unique(b)), (
        "partitions differ: %d id pairs for %d / %d ids, %d pixels differ"
        % (len(pairs), len(np.unique(a)), len(np.unique(b)),
           _pixels_differing(a, b)))
    if classes_a is not None:
        ca, cb = np.asarray(classes_a), np.asarray(classes_b)
        for i, j in pairs:
            if i >= 1 and j >= 1:
                assert ca[i - 1] == cb[j - 1], (i, j, ca[i - 1], cb[j - 1])


def _pixels_differing(a, b):
    K = int(b.max()) + 1
    u, cnt = np.unique(a * K + b, return_counts=True)
    best = {}
    for code, c in zip(u, cnt):
        i = int(code) // K
        best[i] = max(best.get(i, 0), int(c))
    return int(a.size - sum(best.values()))


def logit(p):
    p = p.astype(np.float32)
    return (np.log(p) - np.log1p(-p)).astype(np.float32)


@pytest.fixture
def cuda_device():
    """torch.device('cuda'), or a skip when there is no GPU (decided at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (on the card: MERGENET_TPU_TESTS=1 python -m "
                    "pytest tests/test_torch_port_cuda.py -m cuda)")
    return torch.device("cuda")


#: the 8 certification512 fixtures' mask-AP and AP50 as the JAX package
#: scores them on the CPU (served settings `SERVE_KW`; hier:
#: decode_hierarchical + relabel_mask, exact: run_segmentation_device's
#: default mode, cpp: the committed cpp_mask_*.npz), under procedure (a),
#: the reference's (every image of val_ann.json), and (b), the 8 fixture
#: images only; "a01" is hier over fixtures 0 and 1 under (a)
JAX_AP = {"a": {"hier": (0.09725247524752474, 0.11262376237623763),
                "exact": (0.09628712871287129, 0.11633663366336634),
                "cpp": (0.0927062706270627, 0.11633663366336634)},
          "b": {"hier": (0.7429826732673268, 0.8675742574257426),
                "exact": (0.7390057755775578, 0.8985148514851485),
                "cpp": (0.7088778877887789, 0.8985148514851485)},
          "a01": {"hier": (0.02524752475247525, 0.028465346534653466)}}


def coco_stats(coco, results, img_ids=None, cocoeval=None):
    """The 12 COCOeval('segm') stats of COCO `results` against the
    ground truth `coco` (stats[0] is AP, stats[1] AP50), with `cocoeval`
    (default: the port's COCOeval); `img_ids` replaces the evaluated
    image ids (None: every image of the ground truth)."""
    import contextlib
    import io
    if cocoeval is None:
        from mergenet_tpu_torch.data.cocoeval import COCOeval as cocoeval
    with contextlib.redirect_stdout(io.StringIO()):
        E = cocoeval(coco, coco.loadRes(results), "segm")
        if img_ids is not None:
            E.params.imgIds = list(img_ids)
        E.evaluate()
        E.accumulate()
        E.summarize()
    return [float(v) for v in E.stats]
