"""Reference torch checkpoints and the released caffe PSPNet onto the
port's models (`mergenet_tpu.utils.weight_import` is the reference).

The original framework trains from torchvision / MIT-sceneparsing
pretrained ResNets and saves full-model state dicts; the released PSPNet
is a caffemodel.  The mappings are the reference's, generated from the
arch metadata: one (torch module prefix, module path, kind) entry per
conv or batch norm, the paths being the Flax names the port's modules
keep ("a/b" here is the submodule `a.b`).  Kinds ending in '?' are
optional (torch's downsample branches exist only on shape-changing
blocks).

The loaders copy into an `nn.Module` in place, with the reference's
strictness: a required entry missing from the checkpoint, a target the
model lacks and a shape mismatch raise.  Torch tensors load as torch
stores them (convs OIHW, transposed convs (in, out, kh, kw), which is
the port's own layout); the caffe archive of `caffe_import.
caffemodel_to_npz` holds HWIO convs, which go back to OIHW."""

import os

import numpy as np
import torch

from ..models.resnet import EXPANSION, STAGE_BLOCKS

_CONV_LEAVES = ("weight", "bias")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def resnet_mapping(layer, deep_stem=False, tpre="", fpre=""):
    """(torch prefix, module path, kind) entries for a ResNet backbone.

    torch naming follows torchvision (`conv1/bn1/layer{1..4}.{i}.conv{j}`)
    or the deep-stem variant (`conv1..3/bn1..3`); the module paths
    follow `models/resnet.py::ResNetBackbone` (blocks numbered flat
    across stages)."""
    m = []
    if deep_stem:
        for i in range(3):
            m.append((tpre + "conv{}".format(i + 1),
                      fpre + "Conv_{}".format(i), "conv"))
            m.append((tpre + "bn{}".format(i + 1),
                      fpre + "SyncBatchNorm_{}".format(i), "bn"))
    else:
        m.append((tpre + "conv1", fpre + "Conv_0", "conv"))
        m.append((tpre + "bn1", fpre + "SyncBatchNorm_0", "bn"))
    blocks = STAGE_BLOCKS[layer]
    basic = EXPANSION[layer] == 1
    block_name = "BasicBlock_{}" if basic else "Bottleneck_{}"
    n_conv = 2 if basic else 3
    j = 0
    for s in range(4):
        for i in range(blocks[s]):
            tb = tpre + "layer{}.{}.".format(s + 1, i)
            fb = fpre + block_name.format(j) + "/"
            for c in range(n_conv):
                m.append((tb + "conv{}".format(c + 1),
                          fb + "Conv_{}".format(c), "conv"))
                m.append((tb + "bn{}".format(c + 1),
                          fb + "SyncBatchNorm_{}".format(c), "bn"))
            m.append((tb + "downsample.0",
                      fb + "Conv_{}".format(n_conv), "conv?"))
            m.append((tb + "downsample.1",
                      fb + "SyncBatchNorm_{}".format(n_conv), "bn?"))
            j += 1
    return m


def _ppm_mapping(tpre="ppm.", fpre="PyramidPoolingModule_0/", n_pools=4):
    """torch `ppm.features.{k}` = Sequential(pool, conv, bn, relu)."""
    m = []
    for k in range(n_pools):
        m.append((tpre + "features.{}.1".format(k),
                  fpre + "Conv_{}".format(k), "conv"))
        m.append((tpre + "features.{}.2".format(k),
                  fpre + "SyncBatchNorm_{}".format(k), "bn"))
    return m


def _fpn_mapping(tpre="fpn_module.", fpre="FPNModule_0/", n_levels=4):
    """torch FPNModule naming (`fpn_in`, `fpn_out`, `final_conv`)."""
    m = []
    for k in range(n_levels):
        m.append((tpre + "fpn_in.{}.0".format(k),
                  fpre + "fpn_in_{}".format(k), "conv"))
        m.append((tpre + "fpn_out.{}.0".format(k),
                  fpre + "fpn_out_{}".format(k), "conv"))
    m.append((tpre + "final_conv.0", fpre + "Conv_0", "conv"))
    m.append((tpre + "final_conv.1", fpre + "SyncBatchNorm_0", "bn"))
    m.append((tpre + "final_conv.3", fpre + "Conv_1", "conv"))
    return m


def unet_mapping(depth=5):
    """Reference UNet naming (`down_convs.{i}` with conv1/conv2/bn1/bn2,
    `up_convs.{i}` with a transposed upconv + conv1/conv2/bn1/bn2,
    `conv_final`) onto `models/unet.py` (transpose and concat modes)."""
    m = []
    for i in range(depth):
        tb = "down_convs.{}.".format(i)
        fb = "DownConv_{}/".format(i)
        for c in (1, 2):
            m.append((tb + "conv{}".format(c),
                      fb + "Conv_{}".format(c - 1), "conv"))
            m.append((tb + "bn{}".format(c),
                      fb + "SyncBatchNorm_{}".format(c - 1), "bn"))
    for i in range(depth - 1):
        tb = "up_convs.{}.".format(i)
        fb = "UpConv_{}/".format(i)
        m.append((tb + "upconv", fb + "ConvTranspose_0", "convT"))
        for c in (1, 2):
            m.append((tb + "conv{}".format(c),
                      fb + "Conv_{}".format(c - 1), "conv"))
            m.append((tb + "bn{}".format(c),
                      fb + "SyncBatchNorm_{}".format(c - 1), "bn"))
    m.append(("conv_final", "Conv_0", "conv"))
    return m


_VGG16_BLOCK_CONVS = ((0, 2), (0, 2), (0, 2, 4), (0, 2, 4), (0, 2, 4))
# torchvision vgg16.features conv indices, used by the plain-backbone route
_VGG16_FEATURE_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def fcn_vgg16_mapping(scale=8):
    """Reference FCNVGG16 naming (vgg16.features sliced into `block{1..5}`
    Sequentials, head `score_32s` = Sequential(7x7 conv, relu, dropout,
    1x1 conv, relu, dropout, 1x1 conv), `score_16s`/`score_8s` 1x1
    convs) onto `models/fcn.py::FCNVGG16`; use it with `ref_head=True`
    for the reference's VALID 7x7."""
    m = []
    j = 0
    for b, convs in enumerate(_VGG16_BLOCK_CONVS):
        for i in convs:
            m.append(("block{}.{}".format(b + 1, i),
                      "VGG16Backbone_0/Conv_{}".format(j), "conv"))
            j += 1
    m.append(("score_32s.0", "Conv_0", "conv"))   # 7x7 fc-conv
    m.append(("score_32s.3", "Conv_1", "conv"))   # 1x1 4096
    m.append(("score_32s.6", "score_32s", "conv"))
    if scale <= 16:
        m.append(("score_16s", "score_16s", "conv"))
    if scale <= 8:
        m.append(("score_8s", "score_8s", "conv"))
    return m


def vgg16_backbone_mapping():
    """Plain torchvision vgg16 state dict (`features.{i}.*`) onto the
    VGG16Backbone (the `--pretrain` route of fcn*_vgg16)."""
    return [("features.{}".format(fi),
             "VGG16Backbone_0/Conv_{}".format(j), "conv")
            for j, fi in enumerate(_VGG16_FEATURE_CONVS)]


def model_mapping(arch, layer=None):
    """Full-model mapping for a reference checkpoint of `arch`."""
    if arch in ("unet", "unet_small"):
        return unet_mapping(5 if arch == "unet" else 3)
    if "fpnet" in arch:
        layer = layer or 50
        return (resnet_mapping(layer, False, "resnet.",
                               "ResNetBackbone_0/")
                + _ppm_mapping() + _fpn_mapping())
    if arch == "upernet":
        layer = layer or 50
        return (resnet_mapping(layer, True, "resnet.",
                               "ResNetBackbone_0/")
                + _ppm_mapping() + _fpn_mapping())
    if arch.startswith("fcn") and "vgg16" in arch:
        return fcn_vgg16_mapping(int(arch.split("_")[0][3:]))
    if arch.startswith("fcn") and "resnet" in arch:
        layer = layer or int(arch.split("resnet")[1])
        m = resnet_mapping(layer, False, "resnet.", "ResNetBackbone_0/")
        scale = int(arch.split("_")[0][3:])
        m.append(("score_32s", "score_32s", "conv"))
        if scale <= 16:
            m.append(("score_16s", "score_16s", "conv"))
        if scale <= 8:
            m.append(("score_8s", "score_8s", "conv"))
        return m
    if arch == "pspnet":
        # the original PSPNet torch checkpoints come from its caffemodel
        # converter and use caffe-derived module names, not `resnet.*`;
        # the supported route is the caffemodel itself
        raise ValueError(
            "arch 'pspnet': full torch checkpoints are not mapped; import "
            "the caffemodel directly (utils.caffe_import.caffemodel_to_npz "
            "+ weight_import.apply_caffe_weights). Plain ResNet-101 "
            "backbone state dicts load via backbone_mapping.")
    raise ValueError("no torch mapping for arch '{}'".format(arch))


def backbone_mapping(arch, layer=None):
    """Backbone-only mapping for a PLAIN torchvision-style state dict
    (keys `conv1...` with no `resnet.` prefix, or vgg16's `features.*`):
    the pretrained-weights format the original framework downloads."""
    if arch.startswith("fcn") and "vgg16" in arch:
        return vgg16_backbone_mapping()
    if "fpnet" in arch or arch.startswith("fcn"):
        layer = layer or (50 if "fpnet" in arch
                          else int(arch.split("resnet")[1]))
        return resnet_mapping(layer, False, "", "ResNetBackbone_0/")
    if arch in ("upernet", "pspnet"):
        layer = layer or (50 if arch == "upernet" else 101)
        return resnet_mapping(layer, True, "", "ResNetBackbone_0/")
    raise ValueError("no backbone mapping for arch '{}'".format(arch))


def _target(model, path, leaf):
    """The tensor `leaf` of the submodule at `path` ("a/b"); KeyError
    where the model has none."""
    try:
        mod = model.get_submodule(path.replace("/", "."))
    except AttributeError:
        raise KeyError("module {} not found".format(path)) from None
    t = getattr(mod, leaf, None)
    if not isinstance(t, torch.Tensor):
        raise KeyError("leaf {}/{} not found".format(path, leaf))
    return t


@torch.no_grad()
def _set(model, path, leaf, value):
    t = _target(model, path, leaf)
    if tuple(t.shape) != tuple(value.shape):
        raise ValueError("shape mismatch at {}/{}: model {} vs checkpoint {}"
                         .format(path, leaf, tuple(t.shape), value.shape))
    t.copy_(torch.from_numpy(np.ascontiguousarray(value)))


def apply_torch_weights(model, flat, mapping):
    """Copy `flat` (torch-keyed numpy arrays, as `utils.checkpoint.
    import_torch_checkpoint` returns them) into `model` in place.

    Returns a report: `loaded` and `skipped_optional` torch prefixes, and
    `unused_torch_keys` (never consumed; `fc.*` and
    `num_batches_tracked` aside).  Raises KeyError on a required entry
    missing from `flat` or a target missing from the model, ValueError
    on a shape mismatch."""
    used = set()
    loaded, skipped = [], []
    for tpre, path, kind in mapping:
        optional = kind.endswith("?")
        kind = kind.rstrip("?")
        leaves = _BN_LEAVES if kind == "bn" else _CONV_LEAVES
        if not any(tpre + "." + ln in flat for ln in leaves):
            if optional:
                skipped.append(tpre)
                continue
            raise KeyError("torch checkpoint is missing '{}.*'".format(tpre))
        for ln in leaves:
            tk = tpre + "." + ln
            if tk not in flat:
                continue  # e.g. a bias-free conv
            _set(model, path, ln, np.asarray(flat[tk]))
            used.add(tk)
        loaded.append(tpre)
    return {"loaded": loaded, "skipped_optional": skipped,
            "unused_torch_keys": sorted(
                k for k in flat
                if k not in used and not k.startswith("fc.")
                and ".num_batches_tracked" not in k)}


def load_pretrained(model, path, arch, layer=None, verbose=True):
    """Load a local torch checkpoint file into `model` in place and
    return it.  Keys starting with `resnet.` or `block1.` mean a full
    reference model checkpoint (`model_mapping`), `down_convs.` a UNet;
    anything else a plain torchvision-style backbone
    (`backbone_mapping`)."""
    from .checkpoint import import_torch_checkpoint
    flat, _ = import_torch_checkpoint(path)
    full = any(k.startswith("resnet.") or k.startswith("block1.")
               for k in flat)
    if arch in ("unet", "unet_small") or any(
            k.startswith("down_convs.") for k in flat):
        full = True
        mapping = model_mapping(arch if arch.startswith("unet")
                                else "unet")
    else:
        mapping = (model_mapping(arch, layer) if full
                   else backbone_mapping(arch, layer))
    report = apply_torch_weights(model, flat, mapping)
    if verbose:
        print("loaded {} torch modules from {} ({} mode); {} unused keys"
              .format(len(report["loaded"]), path,
                      "full-model" if full else "backbone",
                      len(report["unused_torch_keys"])))
    return model


def resolve_pretrained_path(arch, pretrain):
    """Pretrained-weights lookup: `pretrain` may be a path, or True to
    search `$MERGENET_PRETRAINED_DIR` and `./pretrained/` (the original
    framework's download cache dir)."""
    if isinstance(pretrain, str):
        return pretrain
    if not pretrain:
        return None
    layer = 50
    if "resnet" in arch:
        layer = int(arch.split("resnet")[1])
    elif arch == "pspnet":
        layer = 101
    names = ["{}.pth.tar".format(arch), "{}.pth".format(arch),
             "resnet{}.pth.tar".format(layer), "resnet{}.pth".format(layer)]
    dirs = [os.environ.get("MERGENET_PRETRAINED_DIR", ""), "./pretrained"]
    for d in dirs:
        if not d:
            continue
        for n in names:
            p = os.path.join(d, n)
            if os.path.exists(p):
                return p
    return None


def caffe_pspnet_mapping(layer=101):
    """(caffe conv-layer name, conv module path, batch-norm path | None)
    entries for the released caffe PSPNet (stem conv1_{1..3}, residual
    conv{2..5}_{i}_{1x1_reduce,3x3,1x1_increase}(+_1_1x1_proj), PPM
    conv5_3_pool{1,2,3,6}_conv, head conv5_4/conv6, aux conv4_{n+1}/
    conv6_1; every conv's batch norm is '<name>/bn')."""
    blocks = STAGE_BLOCKS[layer]
    rb = "ResNetBackbone_0/"
    m = []
    for i, cn in enumerate(("conv1_1_3x3_s2", "conv1_2_3x3",
                            "conv1_3_3x3")):
        m.append((cn, rb + "Conv_{}".format(i),
                  rb + "SyncBatchNorm_{}".format(i)))
    j = 0
    for s in range(4):
        prefix = "conv{}".format(s + 2)
        for i in range(1, blocks[s] + 1):
            fb = rb + "Bottleneck_{}/".format(j)
            m.append(("{}_{}_1x1_reduce".format(prefix, i),
                      fb + "Conv_0", fb + "SyncBatchNorm_0"))
            m.append(("{}_{}_3x3".format(prefix, i),
                      fb + "Conv_1", fb + "SyncBatchNorm_1"))
            m.append(("{}_{}_1x1_increase".format(prefix, i),
                      fb + "Conv_2", fb + "SyncBatchNorm_2"))
            if i == 1:
                m.append(("{}_1_1x1_proj".format(prefix),
                          fb + "Conv_3", fb + "SyncBatchNorm_3"))
            j += 1
    ppm = "PyramidPoolingModule_0/"
    for k, ps in enumerate((1, 2, 3, 6)):
        m.append(("conv5_3_pool{}_conv".format(ps),
                  ppm + "Conv_{}".format(k),
                  ppm + "SyncBatchNorm_{}".format(k)))
    m.append(("conv5_4", "Conv_0", "SyncBatchNorm_0"))
    m.append(("conv6", "Conv_1", None))
    m.append(("conv4_{}".format(blocks[2] + 1), "Conv_2",
              "SyncBatchNorm_1"))
    m.append(("conv6_1", "Conv_3", None))
    return m


def apply_caffe_weights(model, npz, layer=101, skip_head=False):
    """Load a `caffe_import.caffemodel_to_npz` archive (keys
    '<layer>.<i>', convs HWIO) into a `PSPNet` in place.  The BNData
    blob order is gamma, beta, running mean, running var.
    `skip_head=True` loads all but the two classifiers (for transfer to
    another number of outputs).  Returns a report: `loaded`, `skipped`
    and `unused_npz_keys`."""
    loaded, skipped = [], []
    used = set()
    for cname, cpath, bnpath in caffe_pspnet_mapping(layer):
        if skip_head and cpath in ("Conv_1", "Conv_3"):
            skipped.append(cname)
            continue
        wkey = cname + ".0"
        if wkey not in npz:
            raise KeyError("caffemodel is missing layer '{}'".format(cname))
        _set(model, cpath, "weight",
             np.asarray(npz[wkey]).transpose(3, 2, 0, 1))  # HWIO -> OIHW
        used.add(wkey)
        bkey = cname + ".1"
        if bnpath is None and bkey in npz:
            _set(model, cpath, "bias", np.asarray(npz[bkey]))
            used.add(bkey)
        if bnpath is not None:
            bn = cname + "/bn"
            for i, leaf in enumerate(_BN_LEAVES):
                _set(model, bnpath, leaf, np.asarray(npz[bn + ".%d" % i]))
                used.add(bn + ".%d" % i)
        loaded.append(cname)
    return {"loaded": loaded, "skipped": skipped,
            "unused_npz_keys": sorted(k for k in npz.keys()
                                      if k not in used)}
