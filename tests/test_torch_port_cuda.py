"""Card-only tests of the port: each hand-written kernel against its
plain PyTorch version, and the decode on the card against the CPU's.
They skip without a GPU.  This file imports no JAX, so it also runs on
the GPU machine, which has none:

    MERGENET_TPU_TESTS=1 python -m pytest tests/test_torch_port_cuda.py -m cuda

(MERGENET_TPU_TESTS=1 keeps tests/conftest.py from importing JAX.)
Kernels: bit-equal.  Decode: the same partition as the CPU's up to
renaming; CUDA's log/exp may round one ulp away from the CPU's, which
these fixtures do not turn into a different merge."""

import numpy as np
import pytest
import torch

from mergenet_tpu_torch.decoder.device import (decode_hierarchical,
                                               decode_on_device,
                                               run_segmentation_device)
from mergenet_tpu_torch.io import load_offsets, load_probs
from mergenet_tpu_torch.ops import _build, absorb, floodscan, pgather, tgather
from torch_port_helpers import (FIX512, SERVE_KW, assert_same_partition,
                                cuda_device)  # noqa: F401

OFFSETS = ((1, 0), (0, 2), (-2, -1), (2, -4), (5, 5), (-9, 7), (-9, -16),
           (28, -10), (9, 48), (-80, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,s,t", [(61, 130, 2, 1), (512, 1024, 2, 1),
                                     (33, 7, 3, 5)])
def test_floodscan_kernel_matches_plain(cuda_device, H, W, s, t):
    rng = np.random.default_rng(H + W)
    h = torch.from_numpy(rng.random((H, W)) < 0.9).to(cuda_device)
    v = torch.from_numpy(rng.random((H, W)) < 0.9).to(cuda_device)
    for hh, vv in ((h, v), (h, None), (None, v)):
        assert torch.equal(floodscan.flood_scan(hh, vv, s, t, 3),
                           floodscan.flood_scan_plain(hh, vv, s, t, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,s,t,ccl", [
    (37, 1000, 3, 2, 3),     # widths that break the 16-byte path
    (512, 1024, 2, 1, 1),    # one sweep
    (1500, 40, 1, 2, 2),     # taller than a V strip: row tiles + carry
    (2100, 9, 1, 3, 2),      # row tiles, t=3, a partial strip
    (9, 5000, 2, 1, 2),      # wider than an H block: column tiles
    (3, 5000, 1300, 1, 1),   # stride over half a tile
    (2500, 24, 1, 700, 2),   # the same down the columns
    (40, 40, 50, 60, 2),     # strides past the grid: nothing links
])
def test_floodscan_kernel_tiles_and_strides(cuda_device, H, W, s, t, ccl):
    """Shapes that break the kernel's tiling, bit-equal to the plain
    version with both planes and with one plane None."""
    rng = np.random.default_rng(H * W + s)
    h = torch.from_numpy(rng.random((H, W)) < 0.93).to(cuda_device)
    v = torch.from_numpy(rng.random((H, W)) < 0.93).to(cuda_device)
    for hh, vv in ((h, v), (h, None), (None, v)):
        before = _build.LAUNCHES["floodscan"]
        got = floodscan.flood_scan(hh, vv, s, t, ccl)
        assert _build.LAUNCHES["floodscan"] == before + 1
        assert torch.equal(got, floodscan.flood_scan_plain(hh, vv, s, t,
                                                           ccl))


@pytest.mark.cuda
def test_floodscan_kernel_unaligned_planes(cuda_device):
    """Link planes that start off a 4-byte boundary take the scalar
    staging path."""
    rng = np.random.default_rng(5)
    H, W = 64, 256
    flat = torch.from_numpy(rng.random(2 * H * W + 1) < 0.9).to(cuda_device)
    h = flat[1:1 + H * W].view(H, W)
    v = flat[1 + H * W:].view(H, W)
    assert h.data_ptr() % 4 and h.is_contiguous()
    assert torch.equal(floodscan.flood_scan(h, v, 2, 1, 3),
                       floodscan.flood_scan_plain(h, v, 2, 1, 3))


@pytest.mark.cuda
def test_absorb_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(1)
    H, W = 77, 301
    comp = rng.integers(0, 60, (H, W)).astype(np.int32)
    size = rng.integers(1, 120, (H, W)).astype(np.int32)
    argc = rng.integers(0, 4, (H, W)).astype(np.int32)
    froz = (rng.random((H, W)) < 0.05).astype(np.int32)
    packed = (size << 5) | (argc << 1) | froz
    lo = (np.round(rng.standard_normal((len(OFFSETS), H, W)) * 4) / 2) \
        .astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (comp, packed, lo)]
    before = _build.LAUNCHES["absorb"]
    kp, kq = absorb.absorb_best_edges(*args, OFFSETS, 1.0, 64)
    pp, pq = absorb.absorb_plain(*args, OFFSETS, 1.0, 64)
    assert _build.LAUNCHES["absorb"] == before + 1
    assert torch.equal(kp, pp) and torch.equal(kq, pq)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 1000, 131072, 1 << 20])
def test_tgather_kernel_matches_plain(cuda_device, m):
    rng = np.random.default_rng(m)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, m)
                             .astype(np.int32)).to(cuda_device)
    idx = rng.integers(-m - 99, m + 99, (37, 1001)).astype(np.int32)
    idx.flat[:2] = [-2 ** 31, 2 ** 31 - 1]
    idx = torch.from_numpy(idx).to(cuda_device)
    assert torch.equal(tgather.table_gather(table, idx),
                       tgather.table_gather_plain(table, idx))


@pytest.mark.cuda
def test_decode_on_card_matches_cpu(cuda_device):
    cp, sp = load_probs(FIX512, 1)
    offsets = load_offsets(FIX512)
    kw = dict(SERVE_KW, relabel=True, return_stats=True)
    gm, gc, gs = decode_hierarchical(cp, sp, 9, offsets, **kw)
    assert gm.device.type == "cuda"
    cm, cc, cs = decode_hierarchical(cp, sp, 9, offsets, device="cpu", **kw)
    assert_same_partition(gm.cpu().numpy(), cm.numpy(), gc.cpu().numpy(),
                          cc.numpy())
    assert {k: int(v) for k, v in gs.items()} == \
        {k: int(v) for k, v in cs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8192, 58112, 58113, 65536, 200003,
                               1 << 20])
def test_pgather_kernel_matches_plain(cuda_device, m):
    """The int4 branch: in-range indices, plus out-of-range ones that
    clamp, N not a multiple of 4, tables from one entry to 4 MB."""
    rng = np.random.default_rng(m)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, m)
                             .astype(np.int32)).to(cuda_device)
    idx = rng.integers(0, m, 524288 + 77).astype(np.int32)
    idx[:4] = [-2 ** 31, -1, m, 2 ** 31 - 1]
    idx = torch.from_numpy(idx).to(cuda_device)
    before = _build.LAUNCHES["pgather"]
    got = pgather.pgather(table, idx)
    assert _build.LAUNCHES["pgather"] == before + 1
    assert torch.equal(got, pgather.pgather_plain(table, idx))


@pytest.mark.cuda
def test_exact_decode_on_card_matches_cpu(cuda_device):
    """run_segmentation_device(mode='exact') on a 256x512 crop of
    fixture 0 (int32 pair keys at this size; chip_smoke.py decodes the
    whole fixture, whose int64 keys this crop does not reach), and the
    capped decode_on_device, whose final lookup launches tgather."""
    cp, sp = load_probs(FIX512, 0)
    cp, sp = cp[:256, 256:768], sp[:256, 256:768]
    offsets = load_offsets(FIX512)
    cf, sf = np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0)
    before = _build.LAUNCHES["tgather"]
    gm, gc, gs = run_segmentation_device(cf, sf, 9, offsets,
                                         return_stats=True, **SERVE_KW)
    assert _build.LAUNCHES["tgather"] > before
    cm, cc, cs = run_segmentation_device(cf, sf, 9, offsets, device="cpu",
                                         return_stats=True, **SERVE_KW)
    assert_same_partition(gm, cm)
    assert gc == cc and gs == cs
    before = _build.LAUNCHES["tgather"]
    kw = dict(SERVE_KW, max_components=16384, max_edges=262144)
    g = decode_on_device(cp, sp, 9, offsets, **kw)
    assert _build.LAUNCHES["tgather"] == before + 1
    c = decode_on_device(cp, sp, 9, offsets, device="cpu", **kw)
    assert_same_partition(g[0].cpu().numpy(), c[0].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3001, 65536])
def test_pgather_kernel_unaligned_matches_plain(cuda_device, m):
    """Tensors 4 bytes off a 16-byte boundary take the kernel's scalar
    branch (one index per thread) instead of int4 quads."""
    rng = np.random.default_rng(m + 1)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, m + 1)
                             .astype(np.int32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(-m, 2 * m, 100004)
                           .astype(np.int32)).to(cuda_device)
    for t, i in ((table[1:], idx[1:]), (table[:m], idx[1:]),
                 (table[1:], idx[:-1])):
        assert torch.equal(pgather.pgather(t, i),
                           pgather.pgather_plain(t, i))
