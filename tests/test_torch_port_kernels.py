"""The three kernel functions of the port against the JAX reference.

floodscan: `decoder/device.py::_scan_sweeps` vs the plain PyTorch
segmented scan and the CPU wrapper; absorb: the reference's stage-2 jnp
plane loop vs the plain PyTorch loop and the CPU wrappers, on packed
and on unpacked (C > 16) stats; tgather: the Pallas
`table_gather(interpret=True)` vs the plain wrap/clamp gather.  All
integer or compare/select work: required exactly equal.

`test_torch_port_cuda.py` holds each hand-written kernel against its
plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.decoder import device as D
from mergenet_tpu.ops.pallas.tgather import table_gather as jax_tgather
from mergenet_tpu_torch.decoder import device as T
from mergenet_tpu_torch.ops import _build, absorb, floodscan, tgather
from torch_port_helpers import absorb_planes

OFFSETS = ((1, 0), (0, 2), (-2, -1), (2, -4), (5, 5), (-9, 7), (-9, -16),
           (28, -10), (9, 48), (-80, 0))


def _links(rng, H, W, density):
    return rng.random((H, W)) < density


@pytest.mark.parametrize("H,W,s,t,has_h,has_v", [
    (64, 128, 2, 1, True, True),   # the served frame's strides
    (30, 42, 3, 2, True, True),    # no TPU alignment
    (17, 40, 4, 1, True, False),
    (24, 9, 1, 3, False, True),
])
@pytest.mark.parametrize("density", [0.6, 0.97])
def test_flood_scan_matches_scan_sweeps(H, W, s, t, has_h, has_v, density):
    rng = np.random.default_rng(H * W + int(density * 100))
    h = _links(rng, H, W, density) if has_h else None
    v = _links(rng, H, W, density) if has_v else None
    iota = np.arange(H * W, dtype=np.int32).reshape(H, W)
    ref = np.asarray(jax.jit(lambda lab, h, v: D._scan_sweeps(
        lab, None if h is None else (h, s), None if v is None else (v, t),
        3))(jnp.asarray(iota), None if h is None else jnp.asarray(h),
            None if v is None else jnp.asarray(v)))
    th = None if h is None else torch.from_numpy(h)
    tv = None if v is None else torch.from_numpy(v)
    plain = floodscan.flood_scan_plain(th, tv, s, t, 3).numpy()
    np.testing.assert_array_equal(plain, ref)
    before = dict(_build.LAUNCHES)
    np.testing.assert_array_equal(floodscan.flood_scan(th, tv, s, t, 3)
                                  .numpy(), ref)
    assert dict(_build.LAUNCHES) == before  # CPU tensors: no launch
    # the contract the decode's fixed-point pass relies on
    assert (ref <= iota).all()


def _jnp_absorb(comp2d, packed_own, log_odds, offsets, theta, size_cap):
    """The stage-2 plane loop of decode_hierarchical
    (decoder/device.py:1716-1747) on packed stats."""
    return _jnp_absorb_unpacked(
        comp2d, (packed_own >> 1) & 15, packed_own >> 5,
        (packed_own & 1) == 1, log_odds, offsets, theta, size_cap)


def _jnp_absorb_unpacked(comp2d, arg_own, size_own, froz_own, log_odds,
                         offsets, theta, size_cap):
    """The same loop on unpacked stats, as the reference runs it when
    they do not pack (C > 16), on the reference's own helpers."""
    H, W = comp2d.shape
    best_pri = jnp.full((H, W), D.NEG_INF, jnp.float32)
    best_partner = jnp.full((H, W), -1, jnp.int32)
    for oi, (di, dj) in enumerate(offsets):
        nbr = D._shift2d(comp2d, di, dj, -1)
        arg_nbr = D._shift2d(arg_own, di, dj, -2)
        size_nbr = D._shift2d(size_own, di, dj, 0)
        froz_nbr = D._shift2d(froz_own, di, dj, True)
        oml = log_odds[oi]
        small = jnp.minimum(size_own, size_nbr)
        ok = ((nbr >= 0) & (nbr != comp2d) & (arg_nbr == arg_own)
              & (small <= size_cap) & (oml >= theta) & ~froz_own
              & ~froz_nbr)
        up_fwd = (size_nbr > size_own) | ((size_nbr == size_own)
                                          & (nbr > comp2d))
        pri_f = jnp.where(ok & up_fwd, oml, D.NEG_INF)
        pri_b = jnp.where(ok & ~up_fwd, oml, D.NEG_INF)
        for p, q in ((pri_f, nbr),
                     (D._shift2d(pri_b, -di, -dj, D.NEG_INF),
                      D._shift2d(comp2d, -di, -dj, -1))):
            take = (p > best_pri) | ((p == best_pri) & (q > best_partner))
            best_pri = jnp.where(take, p, best_pri)
            best_partner = jnp.where(take, q, best_partner)
    return best_pri, best_partner


def _absorb_inputs(seed, H, W, O):
    comp, size, argc, froz, lo = absorb_planes(np.random.default_rng(seed),
                                               H, W, O, comp_lo=0)
    return comp, (size << 5) | (argc << 1) | froz, lo


@pytest.mark.parametrize("H,W,theta,cap,offsets,eligible", [
    pytest.param(96, 100, 1.0, 64, OFFSETS, 100, id="96-100-1.0-64"),
    pytest.param(40, 64, 0.5, 30, OFFSETS, 100, id="40-64-0.5-30"),
    # smaller than the largest offsets (and than the kernel's halo)
    pytest.param(7, 5, 1.0, 64, OFFSETS, 0, id="7-5-1.0-64"),
    pytest.param(40, 64, 0.5, 30, ((3, -7),), 19, id="40-64-0.5-30-O1"),
])
def test_absorb_matches_jnp_loop(H, W, theta, cap, offsets, eligible):
    comp, packed, lo = _absorb_inputs(H, H, W, len(offsets))
    rp, rq = jax.jit(_jnp_absorb, static_argnums=(3, 4, 5))(
        jnp.asarray(comp), jnp.asarray(packed), jnp.asarray(lo), offsets,
        theta, cap)
    args = (torch.from_numpy(comp), torch.from_numpy(packed),
            torch.from_numpy(lo), offsets, theta, cap)
    for pp, pq in (absorb.absorb_plain(*args),
                   absorb.absorb_best_edges(*args)):
        np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert (np.asarray(rp) > -1e38).sum() > eligible  # eligible edges exist


@pytest.mark.parametrize("H,W", [(64, 96), (9, 6)])
def test_absorb_unpacked_matches_jnp_loop(H, W):
    """The unpacked layout (C > 16): 19 classes and sizes past the packed
    layout's 2^26 clamp, through the CPU wrapper and its plain version,
    against the reference's jnp plane loop."""
    comp, size, argc, froz, lo = absorb_planes(
        np.random.default_rng(H + 19), H, W, len(OFFSETS), classes=19,
        comp_lo=0)
    size[::3] += 1 << 27
    cap = (1 << 27) + 60
    rp, rq = jax.jit(_jnp_absorb_unpacked, static_argnums=(5, 6, 7))(
        jnp.asarray(comp), jnp.asarray(argc), jnp.asarray(size),
        jnp.asarray(froz == 1), jnp.asarray(lo), OFFSETS, 1.0, cap)
    t = {k: torch.from_numpy(a) for k, a in dict(
        comp=comp, size=size, argc=argc, froz=froz, lo=lo).items()}
    before = dict(_build.LAUNCHES)
    for pp, pq in (
            absorb.absorb_plain_unpacked(t["comp"], t["argc"], t["size"],
                                         t["froz"] == 1, t["lo"], OFFSETS,
                                         1.0, cap),
            absorb.absorb_best_edges_unpacked(
                t["comp"], (t["argc"] << 1) | t["froz"], t["size"],
                t["lo"], OFFSETS, 1.0, cap)):
        np.testing.assert_array_equal(pp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert dict(_build.LAUNCHES) == before  # CPU tensors: no launch
    assert (np.asarray(rp) > -1e38).sum() > 0  # eligible edges exist


@pytest.mark.parametrize("m", [128, 8192, 65536])
@pytest.mark.parametrize("n", [128, 1000, 512 * 128 + 37])
def test_tgather_matches_pallas_interpret(m, n):
    rng = np.random.default_rng(m + n)
    table = rng.integers(-2 ** 31, 2 ** 31 - 1, m, dtype=np.int64) \
        .astype(np.int32)
    idx = rng.integers(-m - 50, m + 50, n).astype(np.int32)
    idx[:4] = [-2 ** 31, 2 ** 31 - 1, -m, m]
    ref = np.asarray(jax_tgather(jnp.asarray(table), jnp.asarray(idx),
                                 interpret=True))
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    np.testing.assert_array_equal(tgather.table_gather_plain(t, i).numpy(),
                                  ref)
    np.testing.assert_array_equal(tgather.table_gather(t, i).numpy(), ref)


def test_tgather_2d_index_shape():
    table = torch.arange(256, dtype=torch.int32) * 3
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        -300, 300, (48, 96)).astype(np.int32))
    out = tgather.table_gather(table, idx)
    assert out.shape == idx.shape
    ref = np.asarray(jnp.asarray(table.numpy())[jnp.asarray(idx.numpy())])
    np.testing.assert_array_equal(out.numpy(), ref)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        tgather.table_gather(torch.zeros(8, dtype=torch.int64),
                             torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        floodscan.flood_scan(None, None, 1, 1, 3)
    with pytest.raises(ValueError):
        absorb.absorb_best_edges(torch.zeros((4, 4), dtype=torch.int32),
                                 torch.zeros((4, 4), dtype=torch.int32),
                                 torch.zeros((2, 4, 4)), ((0, 1),), 1.0, 64)


def test_contract_raises_on_a_cycle():
    """A flood label breaking label[p] <= p would leave a cycle: the
    capped pointer-jump loop raises instead of running on."""
    parent = torch.tensor([1, 2, 0, 3], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="_contract"):
        T._contract(parent, two_cycle_break=False)
    ok = T._contract(torch.tensor([0, 0, 1, 2, 3, 4], dtype=torch.int32))
    assert ok.tolist() == [0] * 6

