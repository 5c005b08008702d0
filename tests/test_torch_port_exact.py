"""The exact-mode decoder of the PyTorch port against the JAX reference
on the CPU: `boruvka_rolls_round`, `_count_unique_pairs`,
`_pair_exact_finish` (int32 pair keys and the 2-key form as int64
keys), `decode_on_device` (uncapped, capped with whole-pair drops,
annealed), `decode_on_device_staged`, `decode_on_device_batch`,
`relabel_mask` and `run_segmentation_device` in its three modes, on
crops of the committed trained certification fixture 0 (C=9, O=10) and
on a seeded synthetic multi-instance scene.

Required: integer outputs equal; label grids the same partition up to
renaming with equal per-pixel classes and instance flags; stats
counters equal.  The port follows the reference's summation order, so
no float tolerance enters: every merge decision agrees."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.decoder import device as J
from mergenet_tpu_torch.decoder import device as T
from mergenet_tpu_torch.io import load_offsets, load_probs
from torch_port_helpers import FIX512, SERVE_KW, assert_same_partition

OFFSETS = load_offsets(FIX512)
CP0, SP0 = load_probs(FIX512, 0)
#: 128x256 crop of fixture 0 across two instances
CROP = (CP0[64:192, 640:896], SP0[64:192, 640:896])
#: 64x128 crop of fixture 0
SMALL = (CP0[64:128, 640:768], SP0[64:128, 640:768])


def scene(seed, H=64, W=128, C=9, n_inst=7):
    """A noisy multi-instance scene: rectangles of random classes with
    sameness high inside an instance and low across its border."""
    rng = np.random.RandomState(seed)
    inst = np.zeros((H, W), np.int32)
    cls = {0: 0}
    for k in range(1, n_inst + 1):
        r, c = rng.randint(0, H - H // 4), rng.randint(0, W - W // 4)
        inst[r:r + rng.randint(H // 8, H // 4),
             c:c + rng.randint(W // 8, W // 4)] = k
        cls[k] = rng.randint(1, C)
    cp = np.full((H, W, C), 0.02, np.float32)
    for k, c in cls.items():
        cp[inst == k, c] = 0.9
    sp = np.zeros((H, W, len(OFFSETS)), np.float32)
    for oi, (di, dj) in enumerate(OFFSETS):
        same = inst == np.roll(inst, (-di, -dj), (0, 1))
        sp[..., oi] = np.where(same, 0.92, 0.08)
    cp += rng.rand(H, W, C).astype(np.float32) * 0.05
    sp = np.clip(sp + (rng.rand(*sp.shape).astype(np.float32) - 0.5) * 0.1,
                 1e-4, 1 - 1e-4).astype(np.float32)
    return cp, sp


SCENE = scene(0)


def _assert_same_components(got, ref):
    """(comp, root_class, is_instance_root) of the port and the
    reference: the same partition, with equal class and instance flag
    at every pixel."""
    gc, gr, gi = (np.asarray(a) for a in got)
    rc, rr, ri = (np.asarray(a) for a in ref)
    assert_same_partition(gc, rc)
    np.testing.assert_array_equal(gr[gc], rr[rc])
    np.testing.assert_array_equal(gi[gc], ri[rc])


def test_boruvka_rolls_round_matches_reference():
    cp, sp = CROP
    rl, rn, re_ = J.boruvka_rolls_round(jnp.asarray(cp), jnp.asarray(sp), 9,
                                        OFFSETS, **SERVE_KW)
    gl, gn, ge = T.boruvka_rolls_round(cp, sp, 9, OFFSETS, device="cpu",
                                       **SERVE_KW)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    assert int(gn) == int(rn) > 1000
    assert int(ge) == int(re_) > 0
    flat = gl.numpy().ravel()
    assert (flat[flat] == flat).all()  # self-rooted root pixel ids


def test_count_unique_pairs_matches_reference():
    cp, sp = CROP
    label, _, _ = T.boruvka_rolls_round(cp, sp, 9, OFFSETS, device="cpu",
                                        **SERVE_KW)
    got = T._count_unique_pairs(label, OFFSETS)
    ref = J._count_unique_pairs(jnp.asarray(label.numpy()), OFFSETS)
    assert str(got.dtype) == "torch.int32"
    assert int(got) == int(ref) > 0


@pytest.mark.parametrize("crop,max_components,packed", [
    ((slice(64, 192), slice(640, 896)), 4096, True),
    # M2 = 65536 > 46339: the reference's 2-key sorts, int64 keys here
    ((slice(0, 256), slice(512, 768)), 65536, False)])
def test_pair_exact_finish_matches_reference(crop, max_components, packed):
    cp, sp = CP0[crop], SP0[crop]
    label, n_comp, n_ext = T.boruvka_rolls_round(cp, sp, 9, OFFSETS,
                                                 device="cpu", **SERVE_KW)
    n_pairs = int(T._count_unique_pairs(label, OFFSETS))
    M2 = min(max_components, label.numel())
    assert ((M2 + 1) ** 2 - 1 <= 2 ** 31 - 1) == packed
    assert int(n_comp) <= M2
    kw = dict(SERVE_KW, max_components=max_components,
              pair_slots=T._bucket(n_pairs + 2, 16384),
              edge_slots=T._bucket(int(n_ext) + 1, 16384), pair_rounds=48,
              anneal_start=8.0, anneal_halvings=8)
    ref = J._pair_exact_finish(jnp.asarray(cp), jnp.asarray(sp), 9, OFFSETS,
                               initial_labels=jnp.asarray(label.numpy()),
                               **kw)
    got = T._pair_exact_finish(cp, sp, 9, OFFSETS, initial_labels=label,
                               device="cpu", **kw)
    _assert_same_components(got, ref)


@pytest.mark.parametrize("data,kw", [
    ("scene", {}),
    ("scene", dict(anneal_start=8.0, anneal_halvings=4)),
    ("scene", dict(max_components=2048, max_edges=12000, do_prune=True)),
    ("small", {}),
    ("small", dict(max_components=2048, max_edges=20000)),
    # M = N = 65536 > 46339: int64 pair keys in phases 2 and 3
    ("wide", dict(max_edges=200000)),
])
def test_decode_on_device_matches_reference(data, kw):
    cp, sp = {"scene": SCENE, "small": SMALL,
              "wide": (CP0[:256, 512:768], SP0[:256, 512:768])}[data]
    kw = dict(SERVE_KW, **kw)
    ref = J.decode_on_device(jnp.asarray(cp), jnp.asarray(sp), 9, OFFSETS,
                             **kw)
    got = T.decode_on_device(cp, sp, 9, OFFSETS, device="cpu", **kw)
    _assert_same_components(got, ref)


@pytest.mark.parametrize("max_edges", [6, 4])
def test_decode_on_device_drops_the_straddling_pair_whole(max_edges):
    """The reference's scene for the capped edge compaction
    (tests/test_device_decoder.py): components {0,1}, {2}, {3,4} of a
    4x5 grid; a cut inside pair (1,2)'s edge run (6), or exactly at its
    start (4), drops that pair whole, so only pair (0,1) merges."""
    H, W, C = 4, 5, 2
    offsets = ((0, 1),)
    labels = np.tile(np.array([0, 0, 2, 3, 3], np.int32), (H, 1))
    cp = np.full((H, W, C), 0.5, np.float32)
    cp[..., 1] = 0.9
    sp = np.full((H, W, 1), 0.99, np.float32)
    kw = dict(object_merge_factor=1.0, merge_logprob_bias=0.0,
              initial_labels=labels)
    for k in (None, max_edges):
        ref = J.decode_on_device(jnp.asarray(cp), jnp.asarray(sp), C,
                                 offsets, max_edges=k, **kw)
        got = T.decode_on_device(cp, sp, C, offsets, max_edges=k,
                                 device="cpu", **kw)
        _assert_same_components(got, ref)
        comp = got[0].numpy()
        assert comp[0, 0] == comp[0, 2]
        assert (comp[0, 4] == comp[0, 2]) == (k is None)


def test_decode_on_device_raises_at_max_rounds():
    """A round cap reached unconverged raises instead of returning an
    unconverged decode."""
    cp, sp = SCENE
    with pytest.raises(RuntimeError, match="max_rounds=1"):
        T.decode_on_device(cp, sp, 9, OFFSETS, max_rounds=1, device="cpu",
                           **SERVE_KW)


def test_decode_on_device_staged_matches_reference():
    cp, sp = SCENE
    ref = J.decode_on_device_staged(jnp.asarray(cp), jnp.asarray(sp), 9,
                                    OFFSETS, **SERVE_KW)
    got = T.decode_on_device_staged(cp, sp, 9, OFFSETS, device="cpu",
                                    **SERVE_KW)
    _assert_same_components(got, ref)


def test_decode_on_device_batch_and_relabel_match_reference():
    cp = np.stack([SCENE[0], SMALL[0]])
    sp = np.stack([SCENE[1], SMALL[1]])
    rm, rc = J.decode_on_device_batch(jnp.asarray(cp), jnp.asarray(sp), 9,
                                      OFFSETS, **SERVE_KW)
    gm, gc = T.decode_on_device_batch(cp, sp, 9, OFFSETS, device="cpu",
                                      **SERVE_KW)
    assert gm.shape == (2, 64, 128) and gc.shape == (2, 4096)
    for b in range(2):
        assert_same_partition(gm[b].numpy(), np.asarray(rm[b]),
                              gc[b].numpy(), np.asarray(rc[b]))
        assert int(gm[b].max()) == int(np.asarray(rm[b]).max())
        np.testing.assert_array_equal(gc[b].numpy(), np.asarray(rc[b]))
    assert int(gm[0].max()) >= 5


def test_relabel_mask_matches_reference():
    rng = np.random.RandomState(3)
    M = 300
    label = rng.randint(0, M, (40, 50)).astype(np.int32)
    root_class = rng.randint(0, 5, M).astype(np.int32)
    is_inst = (rng.rand(M) < 0.4) & (root_class > 0)
    is_inst[M - 1] = True  # an instance in the slot non-instances clamp to
    rm, rc = J.relabel_mask(jnp.asarray(label), jnp.asarray(root_class),
                            jnp.asarray(is_inst))
    gm, gc = T.relabel_mask(*(torch.from_numpy(a) for a in
                              (label, root_class, is_inst)))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))


@pytest.mark.parametrize("mode", ["exact", "hier", "capped"])
def test_run_segmentation_device_matches_reference(mode):
    cp, sp = (np.moveaxis(a, -1, 0) for a in CROP)
    kw = dict(SERVE_KW, return_stats=True)
    if mode == "capped":
        kw.update(max_components=8192, max_edges=65536)
    else:
        kw["mode"] = mode
    rm, rc, rs = J.run_segmentation_device(cp, sp, 9, OFFSETS, **kw)
    gm, gc, gs = T.run_segmentation_device(cp, sp, 9, OFFSETS,
                                           device="cpu", **kw)
    assert isinstance(gm, np.ndarray) and gm.shape == (128, 256)
    assert_same_partition(gm, rm)
    assert gc == rc and gs == rs
    if mode != "capped":
        assert len(gc) >= 1 and gs["n_ext"] > 0


def test_run_segmentation_device_hier_rejects_caps():
    cp, sp = (np.moveaxis(a, -1, 0) for a in SMALL)
    with pytest.raises(ValueError, match="mode='hier'"):
        T.run_segmentation_device(cp, sp, 9, OFFSETS, mode="hier",
                                  max_edges=1024, device="cpu")


def test_bucket_matches_reference():
    for n, floor in ((0, 1), (1, 1), (4095, 4096), (4097, 4096),
                     (56530, 4096), (1578457, 16384)):
        assert T._bucket(n, floor) == J._bucket(n, floor)


def _tiny_pair_inputs(comp2d, cp, sp, offsets, M2):
    """Per-component tables of a given dense component grid, for
    `_pair_phase` in both frameworks."""
    C = cp.shape[-1]
    cls_lp_pix, log_odds = J._log_domain(jnp.asarray(cp), jnp.asarray(sp),
                                         0.0)
    flat = comp2d.reshape(-1)
    lp = np.asarray(cls_lp_pix).reshape(-1, C)
    cls_lp = np.stack([lp[flat == m].sum(0) for m in range(M2)])
    cls_lp = cls_lp.astype(np.float32)
    size = np.bincount(flat, minlength=M2).astype(np.int32)
    return cls_lp, size, np.array(log_odds)


@pytest.mark.parametrize("edge_slots", [None, 6, 4])
def test_pair_phase_2key_matches_reference(edge_slots):
    """`_pair_phase(packed=False)` (int64 keys) against the reference's
    2-key sorts on its whole-pair truncation scene
    (tests/test_device_decoder.py): 4x5 grid, columns [0,0,1,2,2];
    a cut inside pair (1,2)'s run (6) or at its start (4) drops it whole.
    The packed form gives the same result."""
    H, W, C, M2 = 4, 5, 2, 3
    offsets = ((0, 1),)
    comp2d = np.tile(np.array([0, 0, 1, 2, 2], np.int32), (H, 1))
    cp = np.full((H, W, C), 0.5, np.float32)
    cp[..., 1] = 0.9
    sp = np.full((H, W, 1), 0.99, np.float32)
    cls_lp, size, log_odds = _tiny_pair_inputs(comp2d, cp, sp, offsets, M2)
    frozen = np.zeros((M2,), bool)
    args = dict(pair_slots=64, pair_rounds=8, den_mode="sum",
                edge_slots=edge_slots)
    rtm, rcl, rsz, rst = J._pair_phase(
        jnp.asarray(comp2d), jnp.asarray(cls_lp), jnp.asarray(size),
        jnp.asarray(frozen), jnp.asarray(log_odds), offsets, M2,
        omf=jnp.float32(1.0), bias=jnp.float32(0.0), packed=False, **args)
    for packed in (False, True):
        gtm, gcl, gsz, gst = T._pair_phase(
            *(torch.from_numpy(a) for a in (comp2d, cls_lp, size, frozen,
                                            log_odds)),
            offsets, M2, omf=1.0, bias=0.0, packed=packed, **args)
        np.testing.assert_array_equal(gtm.numpy(), np.asarray(rtm))
        np.testing.assert_array_equal(gcl.numpy(), np.asarray(rcl))
        np.testing.assert_array_equal(gsz.numpy(), np.asarray(rsz))
        assert {k: int(v) for k, v in gst.items()} == \
            {k: int(v) for k, v in rst.items()}
    tm = gtm.numpy()
    assert tm[0] == tm[1] and (tm[2] == tm[1]) == (edge_slots is None)


#: 256x512 crop of fixture 2 (the crop of the hier decode's recipe-settings
#: test in test_torch_port_decode.py)
CP2, SP2 = (a[:256, :512] for a in load_probs(FIX512, 2))


@pytest.mark.parametrize("settings", [
    dict(SERVE_KW, den_mode="product", object_merge_factor=0.1),
    dict(SERVE_KW, same_different_bias=0.2, do_prune=True),
], ids=["product-omf0.1", "bias0.2-prune"])
@pytest.mark.parametrize("decoder", ["exact", "capped"])
def test_exact_and_capped_match_reference_at_recipe_settings(decoder,
                                                             settings):
    """Decoder options the recipes use (egs/cityscape: the product
    density with a small object_merge_factor; egs/coco: a same/different
    bias with pruning) through the exact mode and the capped single-pass
    decode."""
    if decoder == "exact":
        cp, sp = (np.moveaxis(a, -1, 0) for a in (CP2, SP2))
        kw = dict(settings, mode="exact", return_stats=True)
        rm, rc, rs = J.run_segmentation_device(cp, sp, 9, OFFSETS, **kw)
        gm, gc, gs = T.run_segmentation_device(cp, sp, 9, OFFSETS,
                                               device="cpu", **kw)
        assert_same_partition(gm, rm, gc, rc)
        assert gc == rc and gs == rs and len(gc) >= 1
    else:
        kw = dict(settings, max_components=32768, max_edges=300000)
        ref = J.decode_on_device(jnp.asarray(CP2), jnp.asarray(SP2), 9,
                                 OFFSETS, **kw)
        got = T.decode_on_device(CP2, SP2, 9, OFFSETS, device="cpu", **kw)
        _assert_same_components(got, ref)


def test_log_domain_and_fma_are_bit_equal_to_reference():
    """The probabilities' logs (`_log32`, `_log1p32`) and the priorities'
    multiply-add (`_fma32`) give XLA's CPU bits: on fixture 0's maps
    through `_log_domain`, on inputs spread over the float32 range, and
    on random products at object_merge_factor 0.1."""
    import jax
    gl, go = T._log_domain(torch.from_numpy(CP0), torch.from_numpy(SP0),
                           0.0)
    rl, ro = jax.jit(lambda c, s: J._log_domain(c, s, 0.0))(
        jnp.asarray(CP0), jnp.asarray(SP0))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(go.numpy(), np.asarray(ro))
    rng = np.random.default_rng(0)
    x = np.concatenate([np.logspace(-37.9, 38, 200001, dtype=np.float32),
                        rng.random(200000, dtype=np.float32)])
    x = x[np.isfinite(x) & (x > 0)]
    np.testing.assert_array_equal(T._log32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(x)))
    y = np.concatenate([-x[x < 1], x[x < 1e30]])
    np.testing.assert_array_equal(T._log1p32(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax.jit(jnp.log1p)(y)))
    a, c = (rng.standard_normal((2, 100000)) * 8).astype(np.float32)
    omf = np.float32(0.1)
    ref = np.asarray(jax.jit(lambda a, c: a * omf + c)(a, c))
    got = T._fma32(torch.from_numpy(a), float(omf), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (torch.from_numpy(a) * float(omf) + torch.from_numpy(c)
            != torch.from_numpy(ref)).any()  # two roundings differ
