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
from torch_port_helpers import (FIX512, JAX_AP, SERVE_KW,  # noqa: F401
                                SPIRAL_OFFSETS, absorb_planes,
                                assert_same_partition, coco_stats, cuda_device,
                                wide_classes)

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
@pytest.mark.parametrize("H,W,offsets,frozen,ties,size_hi,cap", [
    (77, 301, OFFSETS, 0.05, True, 120, 64),     # H, W off the 16x32 tile
    (7, 5, OFFSETS, 0.05, True, 120, 64),        # smaller than the halo
    (40, 130, ((3, -7),), 0.05, True, 120, 64),  # O=1
    (70, 260, SPIRAL_OFFSETS, 0.05, True, 120, 64),  # (-21, 0) is long
    (512, 1024, OFFSETS, 0.05, False, 120, 64),  # the served shape
    (96, 300, OFFSETS, 0.05, True, 3000, 64),    # warps that skip
    (100, 300, ((0, 40), (20, 0), (1, 1), (-30, 5), (5, -50), (40, 40),
                (2, -3)), 0.05, True, 120, 64),  # 5 long offsets
    (64, 256, OFFSETS, 1.0, True, 120, 64),      # every pixel frozen
    (60, 200, OFFSETS, 0.05, True, 1 << 26, (1 << 26) - 1),  # cap, packed max
    (60, 200, OFFSETS, 0.05, True, 120, -1),     # nothing under the cap
    # more row or column tiles than a grid's y dimension holds (65535)
    (1_100_000, 1, ((1, 0), (-20, 0), (300, 0)), 0.05, True, 120, 64),
    (1, 2_100_000, ((0, 1), (0, -40), (0, 3)), 0.05, True, 120, 64),
])
def test_absorb_kernel_tiles_and_layouts(cuda_device, H, W, offsets, frozen,
                                         ties, size_hi, cap):
    """Shapes and offsets that break the kernel's tiling, bit-equal to
    the plain version in the packed and the unpacked (C > 16) layout."""
    rng = np.random.default_rng(H * W)
    comp, size, argc, froz, lo = absorb_planes(rng, H, W, len(offsets),
                                                frozen=frozen, ties=ties,
                                                size_hi=size_hi)
    t = {k: torch.from_numpy(a).to(cuda_device) for k, a in dict(
        comp=comp, size=size, argc=argc, froz=froz, lo=lo).items()}
    packed = (t["size"] << 5) | (t["argc"] << 1) | t["froz"]
    before = _build.LAUNCHES["absorb"]
    kp, kq = absorb.absorb_best_edges(t["comp"], packed, t["lo"], offsets,
                                      1.0, cap)
    pp, pq = absorb.absorb_plain(t["comp"], packed, t["lo"], offsets, 1.0,
                                 cap)
    assert torch.equal(kp, pp) and torch.equal(kq, pq)
    up, uq = absorb.absorb_best_edges_unpacked(
        t["comp"], (t["argc"] << 1) | t["froz"], t["size"], t["lo"],
        offsets, 1.0, cap)
    pp, pq = absorb.absorb_plain_unpacked(t["comp"], t["argc"], t["size"],
                                          t["froz"] == 1, t["lo"], offsets,
                                          1.0, cap)
    assert torch.equal(up, pp) and torch.equal(uq, pq)
    assert _build.LAUNCHES["absorb"] == before + 2


@pytest.mark.cuda
def test_absorb_kernel_unpacked_wide_classes(cuda_device):
    """The unpacked layout at 19 classes with sizes past the packed
    layout's 2^26 clamp, on planes 4 bytes off a 16-byte boundary (the
    kernel's 4-byte staging)."""
    rng = np.random.default_rng(19)
    H, W = 90, 300
    comp, size, argc, froz, lo = absorb_planes(rng, H, W, len(OFFSETS),
                                                classes=19)
    size[::7] += 1 << 27
    t = {k: torch.from_numpy(np.concatenate([a.ravel()[:1], a.ravel()]))
         .to(cuda_device)[1:].view(a.shape)
         for k, a in dict(comp=comp, size=size, argc=argc, froz=froz,
                          lo=lo).items()}
    assert t["comp"].data_ptr() % 16
    got = absorb.absorb_best_edges_unpacked(
        t["comp"], ((t["argc"] << 1) | t["froz"]).contiguous(), t["size"],
        t["lo"], OFFSETS, 0.5, 1 << 28)
    ref = absorb.absorb_plain_unpacked(t["comp"], t["argc"], t["size"],
                                       t["froz"] == 1, t["lo"], OFFSETS,
                                       0.5, 1 << 28)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_decode_c19_launches_absorb(cuda_device):
    """At C=19 the stats do not pack: stage 2 launches the absorb kernel
    on unpacked stats, and the card's decode equals the CPU's."""
    cp, sp = load_probs(FIX512, 1)
    cp, sp = wide_classes(cp[256:, :512]), sp[256:, :512]
    offsets = load_offsets(FIX512)
    kw = dict(SERVE_KW, relabel=True, return_stats=True)
    before = _build.LAUNCHES["absorb"]
    gm, gc, gs = decode_hierarchical(cp, sp, 19, offsets, **kw)
    assert _build.LAUNCHES["absorb"] > before
    cm, cc, cs = decode_hierarchical(cp, sp, 19, offsets, device="cpu",
                                     **kw)
    assert int(cm.max()) >= 2 and int(cc.max()) >= 16
    assert_same_partition(gm.cpu().numpy(), cm.numpy(), gc.cpu().numpy(),
                          cc.numpy())
    assert {k: int(v) for k, v in gs.items()} == \
        {k: int(v) for k, v in cs.items()}


@pytest.mark.cuda
def test_tgather_kernel_row_coherent_indices(cuda_device):
    """Indices as the decoder gives them: runs of one component id along
    each row, a few out of range, into a table of 65536."""
    rng = np.random.default_rng(3)
    H, W, m = 512, 1024, 65536
    starts = np.sort(rng.choice(W, (H, 40)), axis=1)
    runs = np.zeros((H, W), np.int64)
    runs[np.arange(H)[:, None], starts] = 1
    idx = (np.cumsum(runs.ravel()) * 7 % (m + 200) - 100).astype(np.int32)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, m)
                             .astype(np.int32)).to(cuda_device)
    idx = torch.from_numpy(idx.reshape(H, W)).to(cuda_device)
    before = _build.LAUNCHES["tgather"]
    got = tgather.table_gather(table, idx)
    assert _build.LAUNCHES["tgather"] == before + 1
    assert torch.equal(got, tgather.table_gather_plain(table, idx))
    assert torch.equal(tgather.table_gather(table, idx.reshape(-1)[1:]),
                       tgather.table_gather_plain(table,
                                                  idx.reshape(-1)[1:]))


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


@pytest.mark.cuda
def test_hier_certification_of_two_fixtures_on_card(cuda_device):
    """Fixtures 0 and 1 decoded on the card (decode_hierarchical +
    relabel_mask at the served settings): no overflow, and their mask-AP
    under the reference's procedure (every image of val_ann.json) within
    0.005 of the JAX package's on the CPU; then the port's C++ greedy
    builds into mergenet_tpu_torch/_build/."""
    import os
    from mergenet_tpu_torch.data import COCO
    from mergenet_tpu_torch.decoder import csegment
    from mergenet_tpu_torch.decoder.device import relabel_mask
    from mergenet_tpu_torch.e2e import masks_to_results
    offsets = load_offsets(FIX512)
    results = []
    for i in (0, 1):
        cp, sp = load_probs(FIX512, i)
        comp, rc, ii, st = decode_hierarchical(cp, sp, 9, offsets,
                                               return_stats=True, **SERVE_KW)
        assert comp.device.type == "cuda"
        for k in ("edges_dropped", "pairs_dropped", "n_frozen"):
            assert int(st[k]) == 0, (i, k, int(st[k]))
        mask, ic = relabel_mask(comp, rc, ii)
        results += masks_to_results(mask[None], ic[None], [i], list(range(9)))
    ap = coco_stats(COCO(os.path.join(FIX512, "val_ann.json")), results)[0]
    assert abs(ap - JAX_AP["a01"]["hier"][0]) <= 0.005, ap
    path = csegment.build()
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)


@pytest.mark.cuda
def test_compact_train_step_on_card_matches_cpu(cuda_device):
    """One `build_train_step_compact` step of PSPFPNet(layer=50,
    fpn_dim=32) from `init_model`'s weights at 64x64, batch 2, alpha 20,
    TF32 off, on the card and on the CPU: loss rtol 1e-3, running
    statistics atol 1e-3, each parameter's update within 0.25 in
    relative L2 norm (float32 gradients of train-mode batch norm over a
    few values per channel move ~5% per leaf between summation orders;
    tests/test_torch_port_train.py).  No decode kernel launches."""
    import copy
    from mergenet_tpu_torch.models import PSPFPNet
    from mergenet_tpu_torch.parallel import train as T
    rng = np.random.default_rng(12)
    mask = np.repeat(np.repeat(rng.integers(0, 6, (2, 8, 8)), 8, 1), 8, 2)
    mask = mask.astype(np.int32)
    img = (mask[..., None] * np.array([40, 25, 10])
           + rng.integers(0, 40, (2, 64, 64, 3))).astype(np.uint8)
    oc = rng.integers(0, 5, (2, 16)).astype(np.int32)
    oc[:, 0] = 0
    step = T.build_train_step_compact(5, SPIRAL_OFFSETS, alpha=20.0)
    model = PSPFPNet(15, fpn_dim=32)
    out = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dev in ("cpu", cuda_device):
            state = T.create_train_state(copy.deepcopy(model),
                                         T.make_optimizer(), seed=3,
                                         device=dev)
            old = {k: v.detach().double().cpu().clone()
                   for k, v in state.model.named_parameters()}
            _build.reset_launches()
            state, m = step(state, img, mask, oc)
            assert not any(_build.LAUNCHES.values())
            out[str(dev)] = (float(m["loss"]), {
                k: v.detach().double().cpu()
                for k, v in state.model.state_dict().items()})
    (l_cpu, s_cpu), (l_card, s_card) = out["cpu"], out[str(cuda_device)]
    assert abs(l_card - l_cpu) <= 1e-3 * abs(l_cpu)
    for k, v in s_cpu.items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(s_card[k], v, atol=1e-3, rtol=1e-3)
        elif k in old:
            du = v - old[k]
            if float(du.abs().max()) >= 1e-6:
                rel = float((s_card[k] - old[k] - du).norm() / du.norm())
                assert rel <= 0.25, (k, rel)
