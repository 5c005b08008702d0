"""`decode_hierarchical` of the PyTorch port against the JAX reference on
the committed trained 512x1024 certification fixtures (C=9, O=10), at
the served frame's settings.

Required: the masks are the same partition up to renaming of instance
ids, matched instances have the same class, and the `return_stats`
counters are equal.  (The port follows the reference's summation order,
so on the CPU the float sums, and with them every merge decision, agree.)
At most 2 fixtures per test, per the suite's time budget."""

import jax.numpy as jnp
import numpy as np
import pytest

from mergenet_tpu.decoder.device import decode_hierarchical as jax_decode
from mergenet_tpu_torch.decoder.device import decode_hierarchical
from mergenet_tpu_torch.io import load_offsets, load_probs
from torch_port_helpers import (FIX512, SERVE_KW, assert_same_partition,
                                logit)


def _stats(d):
    return {k: int(v) for k, v in d.items()}


@pytest.mark.parametrize("index,from_logits", [(0, False), (1, True)])
def test_decode_matches_reference_on_fixture(index, from_logits):
    cp, sp = load_probs(FIX512, index)
    if from_logits:  # the served frame decodes the net's raw logits
        cp, sp = logit(cp), logit(sp)
    offsets = load_offsets(FIX512)
    kw = dict(SERVE_KW, relabel=True, return_stats=True,
              from_logits=from_logits)
    rm, rc, rs = jax_decode(jnp.asarray(cp), jnp.asarray(sp), 9, offsets,
                            **kw)
    gm, gc, gs = decode_hierarchical(cp, sp, 9, offsets, device="cpu", **kw)
    assert gm.shape == (512, 1024) and str(gm.dtype) == "torch.int32"
    assert_same_partition(gm.numpy(), np.asarray(rm), gc.numpy(),
                          np.asarray(rc))
    assert int(gm.max()) == int(np.asarray(rm).max()) >= 2
    assert _stats(gs) == _stats(rs)
    assert _stats(gs)["pairs_dropped"] == 0


def test_decode_component_output_without_relabel_with_prune():
    """relabel=False returns (comp, root_class, is_instance_root): the
    per-pixel component partition, classes and instance flags agree,
    with the prune (weak components folded into background) composed
    into the component map."""
    cp, sp = load_probs(FIX512, 1)
    cp, sp = cp[:256, :512], sp[:256, :512]
    offsets = load_offsets(FIX512)
    kw = dict(SERVE_KW, do_prune=True)
    rc, rr, ri = (np.asarray(a) for a in jax_decode(
        jnp.asarray(cp), jnp.asarray(sp), 9, offsets, **kw))
    gc, gr, gi = (a.numpy() for a in decode_hierarchical(
        cp, sp, 9, offsets, device="cpu", **kw))
    assert_same_partition(gc, rc)
    np.testing.assert_array_equal(gr[gc], rr[rc])
    np.testing.assert_array_equal(gi[gc], ri[rc])


@pytest.mark.parametrize("settings", [
    dict(SERVE_KW, den_mode="product", object_merge_factor=0.1),
    dict(SERVE_KW, same_different_bias=0.2, do_prune=True),
], ids=["product-omf0.1", "bias0.2-prune"])
def test_decode_matches_reference_at_recipe_settings(settings):
    """Decoder options the recipes use, around the absorption scan: the
    product flood density with the recipes' small object_merge_factor,
    and a same/different bias with pruning (egs/coco)."""
    cp, sp = load_probs(FIX512, 2)
    cp, sp = cp[:256, :512], sp[:256, :512]
    offsets = load_offsets(FIX512)
    kw = dict(settings, relabel=True, return_stats=True)
    rm, rc, rs = jax_decode(jnp.asarray(cp), jnp.asarray(sp), 9, offsets,
                            **kw)
    gm, gc, gs = decode_hierarchical(cp, sp, 9, offsets, device="cpu", **kw)
    assert_same_partition(gm.numpy(), np.asarray(rm), gc.numpy(),
                          np.asarray(rc))
    assert int(gm.max()) == int(np.asarray(rm).max()) >= 1
    assert _stats(gs) == _stats(rs)
