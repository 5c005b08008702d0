"""The pyramid-pooling family of the port (`mergenet_tpu.models.pspnet`
is the reference): PSPFPNet (ResNet backbone, pyramid pooling on the
/32 stage, FPN head), UperNet (the same on the deep-stem ResNet with a
wider FPN) and PSPNet (dilated deep-stem ResNet-101, pyramid pooling,
a dropout classifier head and an auxiliary head on c4).

The public forward takes and returns the reference's NHWC layout;
inside, tensors are NCHW in channels_last memory format.  `dtype`
(e.g. torch.bfloat16) is the compute dtype of mixed-precision
training: the input is cast to it, parameters and batch-norm
statistics stay float32, the logits come back float32."""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConcatFusionConv, Dropout, SyncBatchNorm,
                     adaptive_avg_pool, conv2d, nhwc_logits, resize_bilinear,
                     to_nchw)
from .resnet import ResNetBackbone, feature_dims


class PyramidPoolingModule(nn.Module):
    """Pool to each s in pool_sizes, 1x1 conv to in_dim/len(pool_sizes),
    BN + relu, upsample back, concat with the input."""

    def __init__(self, in_dim, pool_sizes=(1, 2, 3, 6)):
        super().__init__()
        self.pool_sizes = tuple(pool_sizes)
        out_dim = in_dim // len(self.pool_sizes)
        for i in range(len(self.pool_sizes)):
            self.add_module("Conv_%d" % i, conv2d(in_dim, out_dim, 1))
            self.add_module("SyncBatchNorm_%d" % i, SyncBatchNorm(out_dim))

    def forward(self, x):
        size = x.shape[-2:]
        out = [x]
        for i, s in enumerate(self.pool_sizes):
            y = getattr(self, "Conv_%d" % i)(adaptive_avg_pool(x, s))
            y = F.relu(getattr(self, "SyncBatchNorm_%d" % i)(y))
            out.append(resize_bilinear(y, size))
        return torch.cat(out, dim=1)


class FPNModule(nn.Module):
    """Top-down feature-pyramid fusion + multi-level concat head."""

    def __init__(self, in_dims, num_outputs, fpn_dim=256):
        super().__init__()
        n = len(in_dims)
        for i, d in enumerate(in_dims):
            self.add_module("fpn_in_%d" % i, conv2d(d, fpn_dim, 1))
            self.add_module("fpn_out_%d" % i,
                            conv2d(fpn_dim, fpn_dim, 3, padding=1,
                                   bias=True))
        self.Conv_0 = ConcatFusionConv(n * fpn_dim, fpn_dim)
        self.SyncBatchNorm_0 = SyncBatchNorm(fpn_dim)
        self.Conv_1 = conv2d(fpn_dim, num_outputs, 1, bias=True)
        self.n = n

    def forward(self, feats):
        n = self.n
        laterals = [getattr(self, "fpn_in_%d" % i)(f)
                    for i, f in enumerate(feats)]
        last = laterals[-1]
        outs = [getattr(self, "fpn_out_%d" % (n - 1))(last)]
        for i in reversed(range(n - 1)):
            last = laterals[i] + resize_bilinear(last,
                                                 laterals[i].shape[-2:])
            outs.append(getattr(self, "fpn_out_%d" % i)(last))
        outs.reverse()  # [P2 .. P5]
        size = outs[0].shape[-2:]
        fusion = [outs[0]] + [resize_bilinear(f, size) for f in outs[1:]]
        x = F.relu(self.SyncBatchNorm_0(self.Conv_0(fusion)))
        return self.Conv_1(x)


class _PyramidFPN(nn.Module):
    """Backbone + PPM on c5 + FPN head, the body PSPFPNet and UperNet
    share (their reference classes differ only in the backbone's stem
    and the FPN width)."""

    #: forward emits its logits at a requested `output_size`
    takes_output_size = True

    def __init__(self, num_outputs, backbone, layer, fpn_dim, pool_sizes,
                 dtype):
        super().__init__()
        self.dtype = dtype
        dims = feature_dims(layer)
        self.ResNetBackbone_0 = backbone
        self.PyramidPoolingModule_0 = PyramidPoolingModule(dims[-1],
                                                           pool_sizes)
        ppm_dim = dims[-1] * 2  # input concat with len(pool_sizes) quarters
        self.FPNModule_0 = FPNModule(dims[:-1] + (ppm_dim,), num_outputs,
                                     fpn_dim)
        self.num_outputs = num_outputs

    def forward(self, x, output_size=None):
        """x: (N, H, W, 3) NHWC float.  Returns (N, h, w, num_outputs)
        float32 logits at `output_size` (default: the input size)."""
        out_size = tuple(output_size) if output_size else x.shape[1:3]
        x = to_nchw(x, self.dtype)
        c2, c3, c4, c5 = self.ResNetBackbone_0(x)
        c5 = self.PyramidPoolingModule_0(c5)
        y = self.FPNModule_0((c2, c3, c4, c5))
        return nhwc_logits(y, out_size)


class PSPFPNet(_PyramidFPN):
    """ResNet backbone (7x7 stem; `s2d_stem` for its space-to-depth
    form) + PPM on the /32 stage + FPN head."""

    def __init__(self, num_outputs, layer=50, fpn_dim=256,
                 pool_sizes=(1, 2, 3, 6), s2d_stem=False, dtype=None):
        super().__init__(num_outputs,
                         ResNetBackbone(layer, s2d_stem=s2d_stem), layer,
                         fpn_dim, pool_sizes, dtype)


class UperNet(_PyramidFPN):
    """PSPFPNet's topology on the deep-stem ResNet with a wider FPN."""

    def __init__(self, num_outputs, layer=50, fpn_dim=512,
                 pool_sizes=(1, 2, 3, 6), dtype=None):
        super().__init__(num_outputs, ResNetBackbone(layer, deep_stem=True),
                         layer, fpn_dim, pool_sizes, dtype)


class PSPNet(nn.Module):
    """Dilated deep-stem ResNet (c4, c5 at /8) + PPM + a 3x3 conv to 512,
    batch norm, relu, dropout 0.1 and a 1x1 classifier; the auxiliary
    head on c4 (3x3 conv to 256, batch norm, relu, dropout 0.1, 1x1
    classifier) runs when the forward is called `with_aux=True` (its
    parameters always exist)."""

    takes_output_size = True

    def __init__(self, num_outputs, layer=101, pool_sizes=(1, 2, 3, 6),
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        dims = feature_dims(layer)
        self.ResNetBackbone_0 = ResNetBackbone(
            layer, deep_stem=True, stage_strides=(1, 2, 1, 1),
            stage_dilations=(1, 1, 2, 4))
        self.PyramidPoolingModule_0 = PyramidPoolingModule(dims[-1],
                                                           pool_sizes)
        self.Conv_0 = conv2d(dims[-1] * 2, 512, 3, padding=1)
        self.SyncBatchNorm_0 = SyncBatchNorm(512)
        self.Dropout_0 = Dropout(0.1)
        self.Conv_1 = conv2d(512, num_outputs, 1, bias=True)
        self.Conv_2 = conv2d(dims[2], 256, 3, padding=1)
        self.SyncBatchNorm_1 = SyncBatchNorm(256)
        self.Dropout_1 = Dropout(0.1)
        self.Conv_3 = conv2d(256, num_outputs, 1, bias=True)
        self.num_outputs = num_outputs

    def forward(self, x, with_aux=False, output_size=None):
        """x: (N, H, W, 3) NHWC float.  Returns float32 logits (N, h, w,
        num_outputs) at `output_size` (default: the input size), and the
        auxiliary logits beside them when `with_aux`."""
        out_size = tuple(output_size) if output_size else x.shape[1:3]
        x = to_nchw(x, self.dtype)
        _, _, c4, c5 = self.ResNetBackbone_0(x)
        y = self.PyramidPoolingModule_0(c5)
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(y)))
        y = self.Conv_1(self.Dropout_0(y))
        y = nhwc_logits(y, out_size)
        if not with_aux:
            return y
        aux = F.relu(self.SyncBatchNorm_1(self.Conv_2(c4)))
        aux = self.Conv_3(self.Dropout_1(aux))
        return y, nhwc_logits(aux, out_size)
