"""Shared building blocks of the PyTorch model port (`mergenet_tpu.models
.layers` is the reference).

Modules run NCHW tensors in `channels_last` memory format: an NHWC array
permuted to NCHW is already channels_last, so the JAX layout at the
public functions costs no copy.  Submodules keep the Flax module names
(`Conv_0`, `SyncBatchNorm_0`, ...) so `convert.py` maps a Flax parameter
tree onto the state dict by name."""

import torch
import torch.nn.functional as F
from torch import nn


def conv2d(cin, cout, k, stride=1, padding=0, dilation=1, bias=False):
    """A Conv2d as `nn.Conv` builds it in the reference, with the
    padding spelled out (torch pads symmetrically; the reference's
    strided convs use explicit symmetric padding for the same reason)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=bias)


class SyncBatchNorm(nn.Module):
    """Batch norm in eval mode: y = (x - mean) * scale / sqrt(var + eps)
    + bias, with the affine folded in float32 and applied in the input's
    dtype.  Only inference is ported; cross-replica statistics belong to
    training, which waits for a later slice."""

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        a = self.weight.float() * torch.rsqrt(self.running_var.float()
                                              + self.eps)
        b = self.bias.float() - self.running_mean.float() * a
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


class StemConv7(nn.Module):
    """The 7x7/stride-2 ResNet stem conv with symmetric padding 3 (the
    reference's space-to-depth rewrite is a TPU layout trick and is not
    ported)."""

    def __init__(self, cin=3, features=64):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, cin, 7, 7))

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), stride=2, padding=3)


class ConcatFusionConv(nn.Module):
    """3x3/SAME conv with bias over the channel concat of same-shape
    feature maps (the reference splits it into per-part partial convs,
    an HBM saving on the TPU; the parameters are the same)."""

    def __init__(self, cin, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, parts):
        x = torch.cat(parts, dim=1)
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=1)


class ConvBNRelu(nn.Module):
    """conv -> batch norm -> relu, the reference's workhorse block."""

    def __init__(self, cin, features, kernel=3, stride=1, dilation=1,
                 use_bias=False, relu=True):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.Conv_0 = conv2d(cin, features, kernel, stride, pad, dilation,
                             use_bias)
        self.SyncBatchNorm_0 = SyncBatchNorm(features)
        self.relu = relu

    def forward(self, x):
        x = self.SyncBatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


def resize_bilinear(x, size):
    """Bilinear resize of an NCHW tensor to spatial `size` (h, w):
    half-pixel centres (`align_corners=False`) with edge clamping, and an
    antialiasing triangle filter on each downsampled axis — the function
    `jax.image.resize(..., "bilinear")` computes, which the reference
    uses for every resize (its upsampling matrices reproduce it)."""
    H, W = int(size[0]), int(size[1])
    h, w = x.shape[-2:]
    if (H, W) == (h, w):
        return x
    return F.interpolate(x, size=(H, W), mode="bilinear",
                         align_corners=False, antialias=(H < h or W < w))


def max_pool(x, window=2, stride=2, padding=0):
    """Max pooling; padded positions never win (-inf padding)."""
    return F.max_pool2d(x, window, stride, padding)


def adaptive_avg_pool(x, out_size):
    """Adaptive average pooling to (out_size, out_size) over the
    floor/ceil index windows [floor(i*h/o), ceil((i+1)*h/o)) — the
    reference's general-case windows, and plain average pooling when
    the size divides."""
    return F.adaptive_avg_pool2d(x, out_size)
