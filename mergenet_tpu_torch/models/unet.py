"""UNet of the port (`mergenet_tpu.models.unet` is the reference): an
encoder-decoder with skip connections, batch norm after every conv,
'transpose'/'upsample' up modes and 'concat'/'add' merge modes, and a
final 1x1 conv to num_classes + num_offsets channels.

NHWC in and out, (N, H, W, 3) -> (N, H, W, C+O) float32 logits; inside,
NCHW in channels_last memory format.  `dtype` is the compute dtype, as
in `pspnet.PSPFPNet`."""

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (ConvTranspose2d, SyncBatchNorm, conv2d, hw, max_pool,
                     resize_bilinear, to_nchw)


class DownConv(nn.Module):
    def __init__(self, cin, features, pooling=True):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, 3, padding=1, bias=True)
        self.SyncBatchNorm_0 = SyncBatchNorm(features)
        self.Conv_1 = conv2d(features, features, 3, padding=1, bias=True)
        self.SyncBatchNorm_1 = SyncBatchNorm(features)
        self.pooling = pooling

    def forward(self, x):
        x = F.relu(self.SyncBatchNorm_0(self.Conv_0(x)))
        x = F.relu(self.SyncBatchNorm_1(self.Conv_1(x)))
        return (max_pool(x) if self.pooling else x), x


class UpConv(nn.Module):
    def __init__(self, features, merge_mode="concat", up_mode="transpose"):
        super().__init__()
        self.merge_mode, self.up_mode = merge_mode, up_mode
        # the Flax names follow creation order: the 1x1 conv of the
        # upsample mode is Conv_0 and shifts the 3x3 convs' names
        k = 0
        if up_mode == "transpose":
            self.ConvTranspose_0 = ConvTranspose2d(2 * features, features, 2,
                                                   stride=2)
        else:
            self.Conv_0 = conv2d(2 * features, features, 1, bias=True)
            k = 1
        cin = 2 * features if merge_mode == "concat" else features
        self.first = "Conv_%d" % k
        self.second = "Conv_%d" % (k + 1)
        self.add_module(self.first, conv2d(cin, features, 3, padding=1,
                                           bias=True))
        self.SyncBatchNorm_0 = SyncBatchNorm(features)
        self.add_module(self.second, conv2d(features, features, 3, padding=1,
                                            bias=True))
        self.SyncBatchNorm_1 = SyncBatchNorm(features)

    def forward(self, from_down, from_up):
        if self.up_mode == "transpose":
            x = self.ConvTranspose_0(from_up)
        else:
            h, w = hw(from_up)
            x = self.Conv_0(resize_bilinear(from_up, (2 * h, 2 * w)))
        if self.merge_mode == "concat":
            x = torch.cat([x, from_down], dim=1)
        else:
            x = x + from_down
        x = F.relu(self.SyncBatchNorm_0(getattr(self, self.first)(x)))
        return F.relu(self.SyncBatchNorm_1(getattr(self, self.second)(x)))


class UNet(nn.Module):
    def __init__(self, num_classes, num_offsets, depth=5, start_filts=64,
                 up_mode="transpose", merge_mode="concat", dtype=None):
        super().__init__()
        if up_mode not in ("transpose", "upsample"):
            raise ValueError("invalid up_mode {}".format(up_mode))
        if merge_mode not in ("concat", "add"):
            raise ValueError("invalid merge_mode {}".format(merge_mode))
        if up_mode == "upsample" and merge_mode == "add":
            raise ValueError("up_mode 'upsample' is incompatible with "
                             "merge_mode 'add'")
        self.depth, self.dtype = depth, dtype
        cin = 3
        for i in range(depth):
            outs = start_filts * 2 ** i
            self.add_module("DownConv_%d" % i,
                            DownConv(cin, outs, pooling=i < depth - 1))
            cin = outs
        for i in range(depth - 1):
            outs //= 2
            self.add_module("UpConv_%d" % i,
                            UpConv(outs, merge_mode, up_mode))
        self.Conv_0 = conv2d(outs, num_classes + num_offsets, 1, bias=True)

    def forward(self, x):
        x = to_nchw(x, self.dtype)
        skips = []
        for i in range(self.depth):
            x, before_pool = getattr(self, "DownConv_%d" % i)(x)
            skips.append(before_pool)
        for i in range(self.depth - 1):
            x = getattr(self, "UpConv_%d" % i)(skips[-(i + 2)], x)
        return self.Conv_0(x).permute(0, 2, 3, 1).float()
