"""PSPFPNet of the port (`mergenet_tpu.models.pspnet` is the reference):
ResNet-50 backbone, pyramid pooling on the /32 stage, FPN head.

The public forward takes and returns the reference's NHWC layout;
inside, tensors are NCHW in channels_last memory format.  `dtype`
(e.g. torch.bfloat16) is the compute dtype of mixed-precision
training: the input is cast to it, parameters and batch-norm
statistics stay float32, the logits come back float32."""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConcatFusionConv, SyncBatchNorm, adaptive_avg_pool,
                     conv2d, resize_bilinear)
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


class PSPFPNet(nn.Module):
    """ResNet backbone + PPM on the /32 stage + FPN head."""

    #: forward emits its logits at a requested `output_size`
    takes_output_size = True

    def __init__(self, num_outputs, layer=50, fpn_dim=256,
                 pool_sizes=(1, 2, 3, 6), dtype=None):
        super().__init__()
        self.dtype = dtype
        dims = feature_dims(layer)
        self.ResNetBackbone_0 = ResNetBackbone(layer)
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
        x = x.permute(0, 3, 1, 2)  # NHWC storage == channels_last NCHW
        if self.dtype is not None:
            x = x.to(self.dtype)
        c2, c3, c4, c5 = self.ResNetBackbone_0(x)
        c5 = self.PyramidPoolingModule_0(c5)
        y = self.FPNModule_0((c2, c3, c4, c5))
        y = resize_bilinear(y, out_size)
        return y.permute(0, 2, 3, 1).float()
