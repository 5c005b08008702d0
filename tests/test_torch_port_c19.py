"""`decode_hierarchical` branches reached by wider class sets and tight
dedup capacities, against the JAX reference: C=19 (certification19),
where the packed stats do not fit and stage 2 runs the unpacked plane
loop (`pack_stats=False`), and a `dedup_slots` below the rows' live run
counts, which takes the sorted `_block_dedup` fallback with whole-pair
drops.  Same partition up to renaming, equal classes, equal stats."""

import jax.numpy as jnp
import numpy as np

from mergenet_tpu.decoder import device as D
from mergenet_tpu_torch.decoder import device as T
from mergenet_tpu_torch.io import load_offsets, load_probs
from torch_port_helpers import (FIX19, FIX512, SERVE_KW,
                                assert_same_partition)

KW = dict(SERVE_KW, relabel=True, return_stats=True)


def _compare(cp, sp, offsets, **kw):
    C = cp.shape[-1]
    rm, rc, rs = D.decode_hierarchical(jnp.asarray(cp), jnp.asarray(sp), C,
                                       offsets, **KW, **kw)
    gm, gc, gs = T.decode_hierarchical(cp, sp, C, offsets, device="cpu",
                                       **KW, **kw)
    assert_same_partition(gm.numpy(), np.asarray(rm), gc.numpy(),
                          np.asarray(rc))
    stats = {k: int(v) for k, v in gs.items()}
    assert stats == {k: int(v) for k, v in rs.items()}
    return gm


def test_unpacked_stats_at_19_classes(monkeypatch):
    cp, sp = load_probs(FIX19, 0)
    calls = []
    real = T._absorb.absorb_plain_unpacked
    monkeypatch.setattr(T._absorb, "absorb_plain_unpacked",
                        lambda *a: calls.append(1) or real(*a))
    gm = _compare(cp[:256, :512], sp[:256, :512], load_offsets(FIX19))
    assert calls and int(gm.max()) >= 1


def test_block_dedup_fallback_with_row_overflow(monkeypatch):
    cp, sp = load_probs(FIX512, 1)
    calls = []
    real = T._block_dedup
    monkeypatch.setattr(T, "_block_dedup",
                        lambda *a: calls.append(1) or real(*a))
    _compare(cp[:256, :512], sp[:256, :512], load_offsets(FIX512),
             dedup_slots=4)
    assert calls


def test_mono_dedup_with_edge_slots():
    """edge_slots selects the one-sort mono dedup instead of the block
    dedup; a cap below the external-edge count drops edges (whole pairs
    at the cut)."""
    cp, sp = load_probs(FIX512, 1)
    offsets = load_offsets(FIX512)
    # 1 << 20 holds every external edge; 400000 of the crop's 421958
    # cuts the sorted key list inside a pair's run (edges_dropped 40983)
    for edge_slots in (1 << 20, 400000):
        gm = _compare(cp[:256, :512], sp[:256, :512], offsets,
                      edge_slots=edge_slots)
        assert int(gm.max()) >= 1
