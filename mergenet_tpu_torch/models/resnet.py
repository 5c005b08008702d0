"""ResNet-50 backbone of the port (`mergenet_tpu.models.resnet` is the
reference): torchvision-style Bottleneck blocks, the 7x7 stem, and the
4-stage feature pyramid.

Strided convs use symmetric padding, as the reference does explicitly
(its flax "SAME" would pad asymmetrically at even sizes)."""

import torch.nn.functional as F
from torch import nn

from .layers import StemConv7, SyncBatchNorm, conv2d, max_pool

STAGE_BLOCKS = {50: (3, 4, 6, 3)}  # deeper variants wait for the zoo port
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


class Bottleneck(nn.Module):
    def __init__(self, cin, features, stride=1, dilation=1):
        super().__init__()
        cout = features * EXPANSION
        self.Conv_0 = conv2d(cin, features, 1)
        self.SyncBatchNorm_0 = SyncBatchNorm(features)
        self.Conv_1 = conv2d(features, features, 3, stride, dilation,
                             dilation)
        self.SyncBatchNorm_1 = SyncBatchNorm(features)
        self.Conv_2 = conv2d(features, cout, 1)
        self.SyncBatchNorm_2 = SyncBatchNorm(cout)
        # projection shortcut exactly where the reference's shapes differ
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.Conv_3 = conv2d(cin, cout, 1, stride)
            self.SyncBatchNorm_3 = SyncBatchNorm(cout)

    def forward(self, x):
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.SyncBatchNorm_1(self.Conv_1(y)))
        y = self.SyncBatchNorm_2(self.Conv_2(y))
        r = self.SyncBatchNorm_3(self.Conv_3(x)) if self.has_proj else x
        return F.relu(y + r)


class ResNetBackbone(nn.Module):
    """Returns (c2, c3, c4, c5) at strides 4/8/16/32."""

    def __init__(self, layer=50):
        super().__init__()
        blocks = STAGE_BLOCKS[layer]
        self.Conv_0 = StemConv7(3, 64)
        self.SyncBatchNorm_0 = SyncBatchNorm(64)
        self.stage_ends = []
        cin, k = 64, 0
        for stage, n in enumerate(blocks):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module("Bottleneck_%d" % k,
                                Bottleneck(cin, WIDTHS[stage], stride))
                cin = WIDTHS[stage] * EXPANSION
                k += 1
            self.stage_ends.append(k)

    def forward(self, x):
        x = F.relu(self.SyncBatchNorm_0(self.Conv_0(x)))
        x = max_pool(x, window=3, stride=2, padding=1)
        feats, k = [], 0
        for end in self.stage_ends:
            while k < end:
                x = getattr(self, "Bottleneck_%d" % k)(x)
                k += 1
            feats.append(x)
        return tuple(feats)


def feature_dims(layer=50):
    """Channel counts of (c2, c3, c4, c5)."""
    return tuple(d * EXPANSION for d in WIDTHS)
