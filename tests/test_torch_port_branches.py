"""Each data-dependent branch of the port's `decode_hierarchical`,
forced, against the JAX reference on a 256x512 crop of certification
fixture 0: the run-budget overflow (RUN_SLOTS), the live-prefix bound
(SMALL), and pair-capacity overflow.  Masks must be the same partition
up to renaming, with equal classes and equal `return_stats` counters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mergenet_tpu.decoder import device as D
from mergenet_tpu_torch.decoder import device as T
from mergenet_tpu_torch.io import load_offsets, load_probs
from torch_port_helpers import FIX512, SERVE_KW, assert_same_partition

KW = dict(SERVE_KW, relabel=True, return_stats=True)


@pytest.fixture(scope="module")
def crop():
    cp, sp = load_probs(FIX512, 0)
    return cp[128:384, 256:768].copy(), sp[128:384, 256:768].copy(), \
        load_offsets(FIX512)


def _compare(crop, ref_kw=None, **kw):
    cp, sp, offsets = crop
    rm, rc, rs = D.decode_hierarchical(jnp.asarray(cp), jnp.asarray(sp),
                                       9, offsets, **dict(KW, **(ref_kw or
                                                                 kw)))
    gm, gc, gs = T.decode_hierarchical(cp, sp, 9, offsets, device="cpu",
                                       **dict(KW, **kw))
    assert_same_partition(gm.numpy(), np.asarray(rm), gc.numpy(),
                          np.asarray(rc))
    stats = {k: int(v) for k, v in gs.items()}
    assert stats == {k: int(v) for k, v in rs.items()}
    return stats


@pytest.fixture
def run_slots(monkeypatch):
    """Lower the run budget on both sides (the reference binds it twice:
    the module constant and `_densify_stats_runs`' default)."""
    def force(n):
        monkeypatch.setattr(D, "RUN_SLOTS", n)
        monkeypatch.setattr(D._densify_stats_runs, "__defaults__", (n,))
        monkeypatch.setattr(T, "RUN_SLOTS", n)
        jax.clear_caches()
    yield force
    jax.clear_caches()  # drop traces made with the lowered budget


def test_run_budget_overflow_branch(crop, run_slots, monkeypatch):
    gathers = []
    real = T._tgather_op.table_gather
    monkeypatch.setattr(T._tgather_op, "table_gather",
                        lambda t, i: gathers.append(i.shape) or real(t, i))
    run_slots(512)  # the crop has a few thousand column runs
    _compare(crop)
    # packed stats, the fused stage-3 table and the relabel all gather
    assert len(gathers) == 3


def test_live_prefix_bound_branches(crop, monkeypatch):
    """SMALL below the stage-1 component count takes the full-size
    table path; outputs are identical to the reference's prefix path."""
    contracts = []
    real = T._contract
    monkeypatch.setattr(T, "_contract", lambda p, *a, **k: (
        contracts.append(p.shape[0]) or real(p, *a, **k)))
    monkeypatch.setattr(T, "SMALL", 64)
    _compare(crop)
    assert 65536 in contracts  # the absorb forest ran at full size M


def test_components_within_prefix_bound(crop):
    """max_components <= SMALL: no prefix branch at all (SMALL == M)."""
    _compare(crop, max_components=16384, pair_components=4096)


def test_pair_capacity_overflow(crop):
    stats = _compare(crop, pair_slots=8)
    assert stats["pairs_dropped"] > 0
