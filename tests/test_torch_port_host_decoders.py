"""The host greedy decoders of the PyTorch port against the JAX package's
on the CPU: the Python `ObjectSegmenter` and the C++ decoder behind
`csegment` (`run_segmentation`, `run_segmentation_batch`), on the cases
of tests/test_segmenter.py (both den_modes, both remerge_modes, do_prune
on and off, the aliased-delta offsets) and a 128x256 crop of the
committed certification fixture 0 at the served settings.

Both ports run the reference's arithmetic (the C++ source is a copy),
so the decodes are required to be the same partition with the same
classes, and the port's C++ to repeat itself exactly."""

import os

import numpy as np
import pytest

from helpers import make_instance_scene, oracle_probs
from mergenet_tpu.decoder import ObjectSegmenter as JSegmenter
from mergenet_tpu.decoder import SegmenterOptions as JOptions
from mergenet_tpu.decoder import csegment as jcseg
from mergenet_tpu_torch.decoder import ObjectSegmenter as TSegmenter
from mergenet_tpu_torch.decoder import SegmenterOptions as TOptions
from mergenet_tpu_torch.decoder import csegment as tcseg
from mergenet_tpu_torch.io import load_offsets, load_probs
from mergenet_tpu_torch.ops._build import BUILD_DIR
from torch_port_helpers import FIX512, SERVE_KW, assert_same_partition

OFFSETS = [(1, 0), (0, 1), (-2, -1), (1, -2), (3, 2)]
ALIASED = [(0, 30), (1, -34), (1, 0), (0, 1)]  # both +30 at W=64
C = 3


def _noisy(seed, H, W, offsets, amp, conf=0.8):
    """tests/test_segmenter.py's noisy scene: the oracle maps of the
    two-rectangle scene plus uniform noise of +-amp."""
    rng = np.random.RandomState(seed)
    inst, classes = make_instance_scene(H, W)
    inst = inst[:H, :W]
    cp, sp = oracle_probs(inst, classes, C, offsets, conf=conf)
    cp = np.clip(cp + rng.uniform(-amp, amp, cp.shape), 1e-4, 1 - 1e-4)
    sp = np.clip(sp + rng.uniform(-amp, amp, sp.shape), 1e-4, 1 - 1e-4)
    return cp.astype(np.float32), sp.astype(np.float32)


def _oracle():
    inst, classes = make_instance_scene()
    return oracle_probs(inst, classes, C, OFFSETS)


def _crop():
    cp, sp = load_probs(FIX512, 0)
    return tuple(np.ascontiguousarray(np.moveaxis(a[64:192, 640:896], -1, 0))
                 for a in (cp, sp))


FRAC = dict(object_merge_factor=1.0 / len(OFFSETS), do_prune=False)
NOISY = dict(object_merge_factor=0.2, merge_logprob_bias=0.01,
             do_prune=False)
#: name -> (inputs, offsets, options); inputs are made on first use
CASES = {
    "oracle-sum-eq": (_oracle, OFFSETS, FRAC),
    "oracle-product-ge": (_oracle, OFFSETS, dict(
        FRAC, den_mode="product", remerge_mode="ge")),
    "oracle-prune": (_oracle, OFFSETS, dict(FRAC, do_prune=True,
                                            prune_threshold=5.0)),
    "noisy-sum-eq": (lambda: _noisy(42, 12, 16, OFFSETS, 0.15), OFFSETS,
                     NOISY),
    "noisy-product-ge": (lambda: _noisy(42, 12, 16, OFFSETS, 0.15),
                         OFFSETS, dict(NOISY, den_mode="product",
                                       remerge_mode="ge")),
    "noisy-product-ge-prune": (lambda: _noisy(42, 12, 16, OFFSETS, 0.15),
                               OFFSETS, dict(NOISY, den_mode="product",
                                             remerge_mode="ge",
                                             do_prune=True,
                                             prune_threshold=1.0)),
    "aliased-deltas": (lambda: _noisy(3, 40, 64, ALIASED, 0.2), ALIASED,
                       dict(NOISY, object_merge_factor=0.25)),
    "prune-all": (_oracle, OFFSETS, dict(object_merge_factor=0.2,
                                         do_prune=True,
                                         prune_threshold=1e9)),
    "bias50": (_oracle, OFFSETS, dict(same_different_bias=50.0,
                                      object_merge_factor=10.0,
                                      do_prune=False)),
    "fixture0-crop": (_crop, load_offsets(FIX512), dict(SERVE_KW,
                                                        do_prune=False)),
}


def _same(a, b):
    """Two (mask, classes) decodes: the same partition, the same class
    per instance, the same background."""
    (ma, ca), (mb, cb) = a, b
    assert len(ca) == len(cb) == int(np.max(ma)) == int(np.max(mb))
    np.testing.assert_array_equal(np.asarray(ma) == 0, np.asarray(mb) == 0)
    assert_same_partition(ma, mb, ca, cb)


def _case(name):
    make, offsets, opts = CASES[name]
    cp, sp = make()
    return cp, sp, [tuple(o) for o in offsets], opts


@pytest.mark.parametrize("name", sorted(CASES))
def test_python_greedy_matches_reference(name):
    cp, sp, offsets, opts = _case(name)
    ref = JSegmenter(cp, sp, cp.shape[0], offsets, JOptions(**opts))
    got = TSegmenter(cp, sp, cp.shape[0], offsets, TOptions(**opts))
    assert got.compute_total_logprob() == ref.compute_total_logprob()
    r, g = ref.run_segmentation(), got.run_segmentation()
    _same(g, r)
    assert got.compute_total_logprob() == ref.compute_total_logprob()


@pytest.mark.parametrize("name", sorted(CASES))
def test_cpp_greedy_matches_reference(name):
    cp, sp, offsets, opts = _case(name)
    ref = jcseg.run_segmentation(cp, sp, cp.shape[0], offsets, **opts)
    got = tcseg.run_segmentation(cp, sp, cp.shape[0], offsets, **opts)
    again = tcseg.run_segmentation(cp, sp, cp.shape[0], offsets, **opts)
    _same(got, ref)
    np.testing.assert_array_equal(again[0], got[0])
    assert again[1] == got[1]
    assert got[0].dtype == np.int32 and got[0].shape == cp.shape[1:]


def test_cpp_batch_matches_reference():
    """B=3 noisy scenes in one call, one host thread each: equal to the
    reference's batch and to the port's one-image decodes."""
    scenes = [_noisy(s, 24, 32, OFFSETS, 0.15) for s in (1, 2, 3)]
    cp = np.stack([s[0] for s in scenes])
    sp = np.stack([s[1] for s in scenes])
    rm, rc = jcseg.run_segmentation_batch(cp, sp, C, OFFSETS, **NOISY)
    gm, gc = tcseg.run_segmentation_batch(cp, sp, C, OFFSETS, **NOISY)
    assert gm.shape == (3, 24, 32) and len(gc) == 3
    for b in range(3):
        _same((gm[b], gc[b]), (rm[b], rc[b]))
        one = tcseg.run_segmentation(cp[b], sp[b], C, OFFSETS, **NOISY)
        np.testing.assert_array_equal(one[0], gm[b])
        assert one[1] == gc[b]
    assert max(len(c) for c in gc) >= 2


def test_cpp_library_is_built_into_the_build_dir():
    path = tcseg.build()
    assert os.path.dirname(path) == BUILD_DIR
    assert os.path.basename(path).startswith("libmergenet_segment_")
    assert tcseg.build() == path == tcseg.library_path()


def test_cpp_build_failure_raises_with_compiler_stderr(tmp_path,
                                                       monkeypatch):
    bad = tmp_path / "segment.cc"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(tcseg, "_SRC", str(bad))
    os.makedirs(BUILD_DIR, exist_ok=True)
    before = set(os.listdir(BUILD_DIR))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tcseg.build()
    assert set(os.listdir(BUILD_DIR)) == before  # no partial library left


def test_cpp_rejects_mismatched_shapes():
    cp, sp = _oracle()
    with pytest.raises(ValueError, match="num_classes=4"):
        tcseg.run_segmentation(cp, sp, 4, OFFSETS)
    with pytest.raises(ValueError, match="4 offsets"):
        tcseg.run_segmentation(cp, sp, C, OFFSETS[:4])
