"""Shared pieces of the `test_torch_port_*` tests: fixture paths,
label-grid comparison up to renaming, and the card check."""

import os

import numpy as np
import pytest

FIX512 = os.path.join(os.path.dirname(__file__), "fixtures",
                      "certification512")
FIX19 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "certification19")

#: decode_hierarchical arguments of the served frame (bench.py)
SERVE_KW = dict(object_merge_factor=1.0, merge_logprob_bias=0.03)


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
