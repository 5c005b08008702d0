"""The rest of the model zoo in the PyTorch port against the JAX package
on the CPU: FCN over ResNet and VGG16 (`models/fcn.py`, `models/vgg.py`),
UperNet and PSPNet with its aux head (`models/pspnet.py`), BasicBlock,
the deep stem and the dilated stages (`models/resnet.py`), the
space-to-depth stem (`models/layers.py`) and `models/tiling.py`.

Weights: seeded convs ~ N(0, 1/fan_in), batch norms with seeded
statistics and affine, conv biases seeded
(`torch_port_helpers.seeded_weights`), carried to the Flax trees by
`convert.state_dict_to_flax`; the same numpy inputs on both sides,
float32, eval mode.  Tolerances:
- logits: max abs error <= 1e-4 x max(1, largest |logit|) (seeded
  weights give logits of magnitude 0.5-8 here; measured 1.5e-7 to
  8.5e-6, i.e. at most 1.9e-6 of the largest logit: the same arithmetic
  in another summation order).  Tighter than the served PSPFPNet's 1e-3
  (`test_torch_port_net.py`), whose trained logits reach ~10;
- the s2d stem against the 7x7: 1e-5, as the reference's own test;
- tile_predict: 1e-6 on probabilities."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models import fcn as JF
from mergenet_tpu.models import get_model as jget_model
from mergenet_tpu.models import layers as JL
from mergenet_tpu.models import pspnet as JP
from mergenet_tpu.models import tiling as JT
from mergenet_tpu_torch.convert import state_dict_to_flax
from mergenet_tpu_torch.models import (FCNResNet, FCNVGG16, PSPFPNet, PSPNet,
                                       UperNet, get_model, init_model, layers,
                                       tile_predict, tiling)
from torch_port_helpers import seeded_weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers on the same
    cores, where torch's thread pool thrashes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(model, seed):
    return seeded_weights(model, seed).eval()


def _flax_vars(model):
    p, b = state_dict_to_flax(model)
    return {"params": p, "batch_stats": b}


# (id, JAX module, port module, input (H, W), call kwargs)
FORWARD_CASES = [
    ("fcn8_resnet18", lambda: JF.FCNResNet(7, scale=8, layer=18),
     lambda: FCNResNet(7, scale=8, layer=18), (64, 96), {}),
    ("fcn16_resnet18", lambda: JF.FCNResNet(7, scale=16, layer=18),
     lambda: FCNResNet(7, scale=16, layer=18), (64, 64), {}),
    ("fcn32_resnet18_output_size", lambda: JF.FCNResNet(7, scale=32,
                                                         layer=18),
     lambda: FCNResNet(7, scale=32, layer=18), (64, 64),
     {"output_size": (32, 48)}),
    ("fcn8_vgg16_same", lambda: JF.FCNVGG16(7, width_mult=0.125),
     lambda: FCNVGG16(7, width_mult=0.125), (64, 64), {}),
    ("fcn8_vgg16_ref_head", lambda: JF.FCNVGG16(7, ref_head=True,
                                                width_mult=0.125),
     lambda: FCNVGG16(7, ref_head=True, width_mult=0.125), (224, 224), {}),
    ("upernet_r18", lambda: JP.UperNet(7, layer=18, fpn_dim=32),
     lambda: UperNet(7, layer=18, fpn_dim=32), (64, 96), {}),
    ("pspnet_r18_aux", lambda: JP.PSPNet(7, layer=18),
     lambda: PSPNet(7, layer=18), (64, 64), {"with_aux": True}),
    ("pspnet_r50_aux", lambda: JP.PSPNet(7, layer=50),
     lambda: PSPNet(7, layer=50), (48, 64), {"with_aux": True}),
    ("pspfpnet_r18_s2d", lambda: JP.PSPFPNet(7, layer=18, fpn_dim=32,
                                             s2d_stem=True),
     lambda: PSPFPNet(7, layer=18, fpn_dim=32, s2d_stem=True), (64, 96),
     {}),
]


@pytest.mark.parametrize("case", FORWARD_CASES, ids=[c[0] for c in
                                                      FORWARD_CASES])
def test_zoo_forward_matches_flax(case):
    _, jmake, tmake, hw, kw = case
    tm = _seeded(tmake(), 1)
    x = np.random.default_rng(0).random((2,) + hw + (3,)).astype(np.float32)
    jm = jmake()
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False, **kw))(
        _flax_vars(tm), x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref) == (2 if kw.get("with_aux") else 1)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape
        tol = 1e-4 * max(1.0, float(np.abs(r).max()))
        assert np.abs(g.numpy() - r).max() <= tol


def test_pspnet_without_aux_returns_the_main_logits():
    """`with_aux=False` (the default, and `logits_at`'s call) returns the
    main head alone, equal to the main logits of a `with_aux` call."""
    tm = _seeded(PSPNet(5, layer=18), 3)
    x = torch.from_numpy(np.random.default_rng(4).random(
        (1, 48, 48, 3)).astype(np.float32))
    with torch.no_grad():
        main, aux = tm(x, with_aux=True)
        assert torch.equal(tm(x), main)
    assert aux.shape == main.shape == (1, 48, 48, 5)


def test_s2d_stem_equals_the_7x7_and_the_reference():
    """StemConv7(s2d=True): the port's space-to-depth conv against its
    own strided 7x7 and against the JAX package's s2d stem, on the same
    (7, 7, 3, 64) kernel; odd sizes take the strided conv, as there."""
    rng = np.random.default_rng(5)
    x = rng.random((1, 32, 48, 3)).astype(np.float32)
    stem = init_model(layers.StemConv7(3, 64), 6)
    s2d = layers.StemConv7(3, 64, s2d=True)
    s2d.load_state_dict(stem.state_dict())
    kernel = stem.weight.detach().numpy().transpose(2, 3, 1, 0)  # HWIO
    for xi in (x, x[:, :31, :47]):
        t = torch.from_numpy(np.ascontiguousarray(xi)).permute(0, 3, 1, 2)
        with torch.no_grad():
            want = stem(t).permute(0, 2, 3, 1).numpy()
            got = s2d(t).permute(0, 2, 3, 1).numpy()
        ref = np.asarray(JL.StemConv7(features=64, s2d=True).apply(
            {"params": {"kernel": kernel}}, xi))
        assert got.shape == ref.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    assert got.shape == (1, 16, 24, 64)
    kt = torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(
        layers._s2d_stem_kernel(kt).numpy().transpose(2, 3, 1, 0),
        np.asarray(JL._s2d_stem_kernel(jnp.asarray(kernel))))


def test_get_model_passes_model_kwargs_through():
    vgg = get_model(9, 10, "fcn16_vgg16", ref_head=True, width_mult=0.125)
    assert isinstance(vgg, FCNVGG16) and vgg.Conv_0.padding == (0, 0)
    assert vgg.Conv_0.out_channels == 512 and not hasattr(vgg, "score_8s")
    assert hasattr(vgg, "score_16s")
    vgg32 = get_model(9, 10, "fcn32_vgg16", width_mult=0.125)
    assert vgg32.Conv_0.padding == (3, 3)
    assert not hasattr(vgg32, "score_16s") and hasattr(vgg32, "score_32s")
    net = get_model(9, 10, "pspfpnet", s2d_stem=True)
    assert net.ResNetBackbone_0.Conv_0.s2d
    with pytest.raises(TypeError):  # as JAX's: the arch fixes the depth
        get_model(9, 10, "pspfpnet", layer=18)
    with pytest.raises(TypeError):
        jget_model(9, 10, "pspfpnet", layer=18, verbose=False)


# ------------------------------------------------------------ tile_predict

C_MODEL = 5


def _ramp_fns(seed):
    """A per-pixel linear head plus a column ramp (so a window and its
    flip differ), as a JAX and a torch function of (N, h, w, 3)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, C_MODEL)).astype(np.float32)
    v = rng.standard_normal(C_MODEL).astype(np.float32) / 8

    def jfn(x):
        ramp = jnp.arange(x.shape[2], dtype=jnp.float32)[None, None, :, None]
        return x @ w + ramp * v

    def tfn(x):
        ramp = torch.arange(x.shape[2], dtype=torch.float32)[None, None, :,
                                                             None]
        return x @ torch.from_numpy(w) + ramp * torch.from_numpy(v)
    return jfn, tfn


@pytest.fixture(scope="module")
def unet_fns():
    tm = _seeded(get_model(C_MODEL, 0, "unet_small"), 7)
    jm = jget_model(C_MODEL, 0, "unet_small", verbose=False)
    v = _flax_vars(tm)
    japply = jax.jit(lambda x: jm.apply(v, x, train=False))

    def tfn(x):
        with torch.no_grad():
            return tm(x)
    return japply, tfn


@pytest.mark.parametrize("head", ["ramp", "unet_small"])
@pytest.mark.parametrize("n_instance", [C_MODEL, 3])
@pytest.mark.parametrize("flip", [True, False])
def test_tile_predict_matches_reference(head, n_instance, flip, request):
    """A non-square 3 x 4 window grid (48x72 frames, 32x32 windows:
    rows [0, 8, 16], columns [0, 13, 26, 40]), flips on and off, with
    and without the background remap (5 model classes -> 3)."""
    jfn, tfn = (_ramp_fns(8) if head == "ramp"
                else request.getfixturevalue("unet_fns"))
    imgs = np.random.default_rng(9).random((2, 48, 72, 3)).astype(
        np.float32)
    kw = dict(n_model_classes=C_MODEL, include_flip_mode=flip)
    ref = np.asarray(JT.tile_predict(jfn, jnp.asarray(imgs), n_instance,
                                     (32, 32), **kw))
    got = tile_predict(tfn, torch.from_numpy(imgs), n_instance, (32, 32),
                       **kw)
    assert got.shape == ref.shape == (2, 48, 72, n_instance)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-6)


def test_tile_grid_is_the_reference_arithmetic():
    for full, side in ((1024, 713), (2048, 713), (48, 32), (72, 32),
                       (713, 713), (100, 7)):
        assert tiling._tile_grid(full, side) == JT._tile_grid(full, side)
    assert tiling._tile_grid(1024, 713) == [0, 155, 311]
    assert tiling._tile_grid(2048, 713) == [0, 445, 890, 1335]
