"""The port's weight importers against the JAX package's on the CPU:
`utils/caffe_import.py` (the caffemodel wire-format reader),
`utils/checkpoint.py::import_torch_checkpoint` and
`utils/weight_import.py` (reference torch checkpoints and the released
caffe PSPNet onto the port's models).

The JAX routes write Flax trees; `convert.flax_to_state_dict` carries
them to the port's state dict, which must equal the port's own route
bit for bit (both copy the same float32 values; the reference's HWIO
transposes and transposed-conv flip are exact and undone by the
conversion).  The checkpoints are `tests/torch_twin.py`'s models with
the reference's naming, randomised with their batch-norm buffers; the
imported port models reproduce the twins' forwards in torch within
1e-4 (rtol and atol, as the JAX package's own import tests)."""

import copy

import numpy as np
import pytest
import torch

import test_caffe_import as jcaffe_test
from mergenet_tpu.utils import caffe_import as JC
from mergenet_tpu.utils import weight_import as JW
from mergenet_tpu.utils.checkpoint import \
    import_torch_checkpoint as jimport_torch_checkpoint
from mergenet_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from mergenet_tpu_torch.models import (VALID_ARCHS, FCNVGG16, PSPFPNet,
                                       PSPNet, UNet, UperNet, get_model,
                                       init_model)
from mergenet_tpu_torch.utils import caffe_import as TC
from mergenet_tpu_torch.utils import weight_import as TW
from mergenet_tpu_torch.utils.checkpoint import import_torch_checkpoint
from torch_port_helpers import (caffe_layer, seeded_weights,
                                write_pspnet_caffemodel)
from torch_twin import TorchFCNVGG16, TorchPSPFPNet, TorchResNet, TorchUNet


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(model, seed):
    """Parameters ~ N(0, 0.05) and float buffers in [0.5, 1.5), as the
    JAX package's import tests draw them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for b in model.buffers():
            if b.dtype.is_floating_point:
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return model


def _assert_state_equal(model, sd):
    got = model.state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def _jax_route(model_init, fn):
    """Run a JAX-package loader `fn(params, batch_stats)` on the Flax
    trees of the port model `model_init` (which stays as it is) and
    carry its result back as a port state dict."""
    params, stats = state_dict_to_flax(model_init)
    out = fn(params, stats)
    return flax_to_state_dict(out[0], out[1])


# ------------------------------------------------------------ caffe import

def test_caffe_reader_matches_reference(tmp_path):
    """The hand-encoded caffemodel of tests/test_caffe_import.py through
    both readers: the same layers, blobs and npz archive."""
    path, _, _ = jcaffe_test._make_caffemodel(tmp_path)
    ref, got = JC.load_caffemodel(path), TC.load_caffemodel(path)
    assert [(l["name"], l["type"], l["convolution_param"]) for l in got] \
        == [(l["name"], l["type"], l["convolution_param"]) for l in ref]
    for lr, lg in zip(ref, got):
        assert len(lr["blobs"]) == len(lg["blobs"])
        for br, bg in zip(lr["blobs"], lg["blobs"]):
            np.testing.assert_array_equal(bg, br)
    assert TC.extract_weights(got).keys() == JC.extract_weights(ref).keys()
    names_t = TC.caffemodel_to_npz(path, str(tmp_path / "t.npz"))
    names_j = JC.caffemodel_to_npz(path, str(tmp_path / "j.npz"))
    assert names_t == names_j
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        for k in names_j:
            np.testing.assert_array_equal(t[k], j[k])
    # the helpers' writer encodes layers as the hand-encoded reference
    w = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    assert caffe_layer("c", "ConvolutionData", [w], bias_term=False) == \
        jcaffe_test._layer("c", "ConvolutionData", [w], bias_term=False)


@pytest.fixture(scope="module")
def pspnet50_caffe(tmp_path_factory):
    """A synthetic PSPNet-r50 caffemodel with the released naming, written
    from a seeded port model, and its npz (the converters' archives are
    the same file: `test_caffe_reader_matches_reference`)."""
    d = tmp_path_factory.mktemp("caffe")
    src = seeded_weights(PSPNet(5, layer=50), 31)
    write_pspnet_caffemodel(str(d / "psp.caffemodel"), src, 50)
    TC.caffemodel_to_npz(str(d / "psp.caffemodel"), str(d / "t.npz"))
    return src, d


def test_apply_caffe_weights_matches_reference(pspnet50_caffe):
    src, d = pspnet50_caffe
    fresh = PSPNet(5, layer=50)  # both routes start from its weights
    model = copy.deepcopy(fresh)
    with np.load(d / "t.npz") as tnpz:
        ref = _jax_route(fresh, lambda p, b: JW.apply_caffe_weights(
            p, b, tnpz, layer=50))
        report = TW.apply_caffe_weights(model, tnpz, layer=50)
    assert report["unused_npz_keys"] == [] and not report["skipped"]
    assert len(report["loaded"]) == len(TW.caffe_pspnet_mapping(50))
    _assert_state_equal(model, ref)
    _assert_state_equal(model, src.state_dict())  # every tensor, exactly


def test_apply_caffe_weights_skip_head_and_refusals(pspnet50_caffe):
    src, d = pspnet50_caffe
    model = PSPNet(7, layer=50)  # another number of outputs
    head = {k: v.clone() for k, v in model.state_dict().items()
            if k.split(".")[0] in ("Conv_1", "Conv_3")}
    with np.load(d / "t.npz") as tnpz:
        report = TW.apply_caffe_weights(model, tnpz, layer=50,
                                        skip_head=True)
        assert report["skipped"] == ["conv6", "conv6_1"]
        assert report["unused_npz_keys"] == ["conv6.0", "conv6.1",
                                             "conv6_1.0", "conv6_1.1"]
        for k, v in head.items():
            assert torch.equal(model.state_dict()[k], v), k
        assert torch.equal(model.Conv_0.weight, src.Conv_0.weight)
        with pytest.raises(ValueError, match="shape mismatch"):
            TW.apply_caffe_weights(model, tnpz, layer=50)
        partial = {k: tnpz[k] for k in tnpz.files if not k.startswith(
            "conv5_4.")}
    with pytest.raises(KeyError, match="conv5_4"):
        TW.apply_caffe_weights(model, partial, layer=50)
    params, stats = state_dict_to_flax(model)
    with pytest.raises(KeyError, match="conv5_4"):
        JW.apply_caffe_weights(params, stats, partial, layer=50)


# ---------------------------------------------------------- torch imports

def _save(tmp_path, model, name):
    path = str(tmp_path / name)
    torch.save({"model_state": model.state_dict(), "epoch": 3}, path)
    return path


def _twin_forward(twin, x):
    twin.eval()
    with torch.no_grad():
        return twin(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()


# (id, twin, checkpoint name, arch, port model, input (H, W))
TWINS = [
    ("pspfpnet", lambda: TorchPSPFPNet(5, (3, 4, 6, 3), fpn_dim=64),
     "ckpt.pth.tar", "pspfpnet", lambda: PSPFPNet(5, fpn_dim=64), (96, 96)),
    ("upernet_deep_stem", lambda: TorchPSPFPNet(4, (3, 4, 6, 3), fpn_dim=64,
                                                deep_stem=True),
     "ckpt.pth.tar", "upernet", lambda: UperNet(4, fpn_dim=64), (96, 96)),
    ("unet_small", lambda: TorchUNet(5, depth=3, start_filts=8),
     "unet.pth.tar", "unet_small", lambda: UNet(3, 2, depth=3,
                                                start_filts=8), (32, 32)),
    ("fcn8_vgg16_ref_head", lambda: TorchFCNVGG16(4, scale=8, width=0.125),
     "ckpt.pth.tar", "fcn8_vgg16",
     lambda: FCNVGG16(4, scale=8, ref_head=True, width_mult=0.125),
     (224, 224)),
]


@pytest.mark.parametrize("case", TWINS, ids=[c[0] for c in TWINS])
def test_load_pretrained_matches_reference_and_twin(case, tmp_path):
    _, make_twin, name, arch, make_model, hw = case
    twin = _randomize(make_twin(), 41)
    path = _save(tmp_path, twin, name)
    flat, meta = import_torch_checkpoint(path)
    jflat, jmeta = jimport_torch_checkpoint(path)
    assert meta == jmeta == {"epoch": 3} and flat.keys() == jflat.keys()
    for k, v in twin.state_dict().items():  # as torch stores them
        np.testing.assert_array_equal(flat[k], v.numpy())
    base = make_model()
    ref = _jax_route(base, lambda p, b: JW.load_pretrained(
        p, b, path, arch, verbose=False))
    model = TW.load_pretrained(copy.deepcopy(base), path, arch,
                               verbose=False)
    _assert_state_equal(model, ref)
    report = TW.apply_torch_weights(base, flat, TW.model_mapping(arch))
    assert report["unused_torch_keys"] == []
    x = np.random.default_rng(43).standard_normal((1,) + hw + (3,)).astype(
        np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _twin_forward(twin, x), rtol=1e-4,
                               atol=1e-4)


#: narrow widths where `get_model` takes them (the ResNet archs have
#: none)
NARROW = {"vgg16": dict(width_mult=0.125), "unet": dict(start_filts=4)}


@pytest.mark.parametrize("arch", VALID_ARCHS)
def test_bare_models_have_no_uninitialised_parameter(arch):
    """A bare `get_model(...)` draws every parameter from torch's global
    generator (torch's defaults until `init_model`): finite, and two
    builds after one `torch.manual_seed` have equal state dicts.  A
    weight made with `torch.empty` and never filled breaks both."""
    kw = next((v for k, v in NARROW.items() if arch.endswith(k)), {})
    builds = []
    for _ in range(2):
        torch.manual_seed(0)
        builds.append(get_model(9, 10, arch, **kw).state_dict())
    for k, v in builds[0].items():
        assert torch.isfinite(v.float()).all(), (arch, k)
        assert torch.equal(v, builds[1][k]), (arch, k)


def test_backbone_only_checkpoints_load_the_backbone(tmp_path, monkeypatch):
    """The `--pretrain` route: a plain torchvision-style ResNet-50 (and
    vgg16 `features.*`) state dict fills the backbone only, as JAX's."""
    twin = _randomize(TorchResNet((3, 4, 6, 3)), 44)
    path = _save(tmp_path, twin, "resnet50.pth.tar")
    before = init_model(PSPFPNet(5, fpn_dim=64), 45)
    ref = _jax_route(before, lambda p, b: JW.load_pretrained(
        p, b, path, "pspfpnet", verbose=False))
    model = TW.load_pretrained(copy.deepcopy(before), path, "pspfpnet",
                               verbose=False)
    _assert_state_equal(model, ref)
    for k, v in before.state_dict().items():
        if k.startswith("FPNModule_0"):
            assert torch.equal(model.state_dict()[k], v), k
    assert torch.equal(model.ResNetBackbone_0.Conv_0.weight,
                       twin.conv1.weight)
    feats = _twin_forward_feats(twin, model)
    for r, g in feats:
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)

    vgg = torch.nn.Module()
    layers, cin = [], 3
    for width, n in ((8, 2), (16, 2), (32, 3), (64, 3), (64, 3)):
        for _ in range(n):
            layers += [torch.nn.Conv2d(cin, width, 3, padding=1),
                       torch.nn.ReLU()]
            cin = width
        layers.append(torch.nn.MaxPool2d(2, 2))
    vgg.features = torch.nn.Sequential(*layers)
    vpath = _save(tmp_path, _randomize(vgg, 46), "vgg16.pth")
    base = FCNVGG16(4, width_mult=0.125)
    ref = _jax_route(base, lambda p, b: JW.load_pretrained(
        p, b, vpath, "fcn8_vgg16", verbose=False))
    _assert_state_equal(TW.load_pretrained(base, vpath, "fcn8_vgg16",
                                           verbose=False), ref)

    monkeypatch.setenv("MERGENET_PRETRAINED_DIR", str(tmp_path))
    assert TW.resolve_pretrained_path("pspfpnet", True) == path \
        == JW.resolve_pretrained_path("pspfpnet", True)
    assert TW.resolve_pretrained_path("upernet", "x.pth") == "x.pth"
    assert TW.resolve_pretrained_path("pspnet", False) is None


def _twin_forward_feats(twin, model):
    x = np.random.default_rng(48).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    twin.eval()
    with torch.no_grad():
        ref = twin(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = model.eval().ResNetBackbone_0(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    return [(r.numpy(), g.numpy()) for r, g in zip(ref, got)]


def test_refusals_match_reference(tmp_path):
    """What the JAX package refuses, the port refuses: a PSPNet torch
    checkpoint, an arch without a mapping, a required entry missing, a
    shape mismatch; optional downsample entries are skipped."""
    for pkg in (TW, JW):
        with pytest.raises(ValueError, match="caffemodel"):
            pkg.model_mapping("pspnet")
        with pytest.raises(ValueError, match="no torch mapping"):
            pkg.model_mapping("resnet50")
        with pytest.raises(ValueError, match="no backbone mapping"):
            pkg.backbone_mapping("unet")
    twin = _randomize(TorchPSPFPNet(5, (3, 4, 6, 3), fpn_dim=64), 49)
    path = _save(tmp_path, twin, "c.pth.tar")
    flat, _ = import_torch_checkpoint(path)
    jflat, _ = jimport_torch_checkpoint(path)  # convs HWIO
    mapping = TW.model_mapping("pspfpnet")
    assert mapping == JW.model_mapping("pspfpnet")
    model = PSPFPNet(5, fpn_dim=64)
    params, stats = state_dict_to_flax(model)
    gone = "fpn_module.final_conv.1."
    with pytest.raises(KeyError, match="final_conv.1"):
        TW.apply_torch_weights(copy.deepcopy(model), {
            k: v for k, v in flat.items() if not k.startswith(gone)},
            mapping)
    with pytest.raises(KeyError, match="final_conv.1"):
        JW.apply_torch_weights(params, stats, {
            k: v for k, v in jflat.items() if not k.startswith(gone)},
            mapping)
    wrong = "fpn_module.final_conv.3.weight"
    with pytest.raises(ValueError, match="shape mismatch"):
        TW.apply_torch_weights(copy.deepcopy(model), {
            **flat, wrong: np.zeros((6, 64, 1, 1), np.float32)}, mapping)
    with pytest.raises(ValueError, match="shape mismatch"):
        JW.apply_torch_weights(params, stats, {
            **jflat, wrong: np.zeros((1, 1, 64, 6), np.float32)}, mapping)
    report = TW.apply_torch_weights(model, flat, mapping)
    assert len(report["skipped_optional"]) == 2 * (16 - 4)
    assert report["unused_torch_keys"] == []
