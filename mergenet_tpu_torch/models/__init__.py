"""Model zoo of the port (`mergenet_tpu.models` is the reference):
PSPFPNet-r50 and UNet so far, built by the reference's arch names.

Models map an NHWC batch (N, H, W, 3) to float32 logits (N, H, W,
num_classes + num_offsets)."""

import math

import torch

from .layers import ConvTranspose2d, SyncBatchNorm, resize_bilinear
from .pspnet import FPNModule, PSPFPNet, PyramidPoolingModule  # noqa: F401
from .resnet import Bottleneck, ResNetBackbone  # noqa: F401
from .unet import DownConv, UNet, UpConv  # noqa: F401

VALID_ARCHS = (
    ["fcn{}_resnet{}".format(x, y)
     for x in [8, 16, 32] for y in [18, 34, 50, 101, 152]]
    + ["fcn{}_vgg16".format(x) for x in [8, 16, 32]]
    + ["unet", "unet_small", "pspnet", "pspfpnet", "upernet"]
)

#: the blocks `torch.utils.checkpoint` recomputes under `remat=True`
#: (parallel/train.py): each keeps only its inputs for the backward
REMAT_BLOCKS = (Bottleneck, PyramidPoolingModule, FPNModule, DownConv,
                UpConv)


def get_model(num_classes, num_offsets, arch, dtype=None, **model_kwargs):
    """Build a model by the reference's arch string.  `dtype` is the
    compute dtype (torch.bfloat16 for mixed precision: float32 params and
    batch-norm statistics, float32 logits).  The parameters are torch's
    defaults until `init_model` or a weight loader sets them."""
    if arch not in VALID_ARCHS:
        raise ValueError("Supported models are: {}\nbut given {}".format(
            VALID_ARCHS, arch))
    num_outputs = num_classes + num_offsets
    if arch == "unet":
        return UNet(num_classes, num_offsets, dtype=dtype, **model_kwargs)
    if arch == "unet_small":
        # lightweight variant for smoke tests and quick experiments
        return UNet(num_classes, num_offsets, depth=3, start_filts=8,
                    dtype=dtype, **model_kwargs)
    if arch == "pspfpnet":
        return PSPFPNet(num_outputs, layer=50, fpn_dim=256, dtype=dtype,
                        **model_kwargs)
    raise NotImplementedError(
        "arch %r is not ported yet (ROADMAP.md queue 1, item 5: the rest "
        "of the model zoo)" % arch)


@torch.no_grad()
def init_model(model, seed=0):
    """Initialise `model` in place as flax's `init` does, drawing from
    a `torch.Generator` seeded with `seed`: conv kernels lecun-normal (a
    normal truncated at +-2 standard deviations, scaled to variance
    1 / fan_in, fan_in = in * kh * kw), conv biases 0, batch norm scale
    1, bias 0, running mean 0, running var 1.  Returns the model."""
    gen = torch.Generator().manual_seed(int(seed))
    # flax's truncated normal has unit variance before the scale
    std_of_unit_truncnorm = 0.87962566103423978
    for mod in model.modules():
        if isinstance(mod, SyncBatchNorm):
            mod.weight.fill_(1)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1)
            continue
        w = dict(mod.named_parameters(recurse=False)).get("weight")
        if w is None:
            continue
        fan_in = (w.shape[0] if isinstance(mod, ConvTranspose2d)
                  else w.shape[1]) * w.shape[2] * w.shape[3]
        std = math.sqrt(1.0 / fan_in) / std_of_unit_truncnorm
        cpu = torch.empty(w.shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                    generator=gen)
        w.copy_(cpu)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    return model


def param_count(model):
    """Number of trainable parameters (batch-norm statistics excluded,
    as the reference counts its `params` tree)."""
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def logits_at(model, x, size):
    """float32 LOGITS (N, h, w, C+O) at spatial `size` for an NHWC batch
    `x`, emitted directly at that size (the serving fast path; paired
    with `decode_hierarchical(from_logits=True)`), or None for a model
    without `output_size` (UNet), whose maps go through `probs_at`.
    The model runs in eval mode (the reference's `train=False`)."""
    if not getattr(model, "takes_output_size", False):
        return None
    return model.eval()(x, output_size=tuple(size)).float()


@torch.no_grad()
def probs_at(model, x, size):
    """Sigmoid probabilities (N, h, w, C+O) at spatial `size` for an NHWC
    batch `x`: from logits emitted at that size, or, for a model
    without `output_size`, the full-size probabilities resized
    bilinearly (as `jax.image.resize`: antialiased when shrinking).
    The model runs in eval mode."""
    if getattr(model, "takes_output_size", False):
        return torch.sigmoid(logits_at(model, x, size))
    probs = torch.sigmoid(model.eval()(x).float())
    return resize_bilinear(probs.permute(0, 3, 1, 2), size).permute(
        0, 2, 3, 1)
