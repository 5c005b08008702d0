"""ResNet backbones of the port (`mergenet_tpu.models.resnet` is the
reference): 18/34/50/101/152 with torchvision-style BasicBlock and
Bottleneck blocks, the 7x7 stem (optionally its space-to-depth form) or
the deep 3x3 stem, and per-stage strides and dilations (the dilated
ResNet-101 of PSPNet), returning the 4-stage feature pyramid.

Strided convs use symmetric padding, as the reference does explicitly
(its flax "SAME" would pad asymmetrically at even sizes).  Blocks are
numbered flat across stages (`BasicBlock_k` / `Bottleneck_k`), as flax
names them."""

import torch.nn.functional as F
from torch import nn

from .layers import StemConv7, SyncBatchNorm, conv2d, max_pool

STAGE_BLOCKS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
EXPANSION = {18: 1, 34: 1, 50: 4, 101: 4, 152: 4}
WIDTHS = (64, 128, 256, 512)


class BasicBlock(nn.Module):
    """Two 3x3 convs (padding = dilation); a 1x1 projection shortcut
    exactly where the reference's residual shape differs from the
    output's (a stride, or a change of width)."""

    expansion = 1

    def __init__(self, cin, features, stride=1, dilation=1):
        super().__init__()
        self.Conv_0 = conv2d(cin, features, 3, stride, dilation, dilation)
        self.SyncBatchNorm_0 = SyncBatchNorm(features)
        self.Conv_1 = conv2d(features, features, 3, 1, dilation, dilation)
        self.SyncBatchNorm_1 = SyncBatchNorm(features)
        self.has_proj = stride != 1 or cin != features
        if self.has_proj:
            self.Conv_2 = conv2d(cin, features, 1, stride)
            self.SyncBatchNorm_2 = SyncBatchNorm(features)

    def forward(self, x):
        y = F.relu(self.SyncBatchNorm_0(self.Conv_0(x)))
        y = self.SyncBatchNorm_1(self.Conv_1(y))
        r = self.SyncBatchNorm_2(self.Conv_2(x)) if self.has_proj else x
        return F.relu(y + r)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (stride, padding = dilation), 1x1 expand to
    4 x features; projection shortcut as in `BasicBlock`."""

    expansion = 4

    def __init__(self, cin, features, stride=1, dilation=1):
        super().__init__()
        cout = features * self.expansion
        self.Conv_0 = conv2d(cin, features, 1)
        self.SyncBatchNorm_0 = SyncBatchNorm(features)
        self.Conv_1 = conv2d(features, features, 3, stride, dilation,
                             dilation)
        self.SyncBatchNorm_1 = SyncBatchNorm(features)
        self.Conv_2 = conv2d(features, cout, 1)
        self.SyncBatchNorm_2 = SyncBatchNorm(cout)
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
    """Returns (c2, c3, c4, c5) at strides 4/8/16/32 (less where stages
    are dilated: PSPNet's stage_strides=(1, 2, 1, 1), stage_dilations=
    (1, 1, 2, 4) keeps c4 and c5 at /8).  `deep_stem`: three 3x3 convs
    (64, 64, 128; the first stride 2 with padding 1) in place of the
    7x7; `s2d_stem`: the 7x7 as its space-to-depth rewrite."""

    def __init__(self, layer=50, deep_stem=False, stage_strides=(1, 2, 2, 2),
                 stage_dilations=(1, 1, 1, 1), s2d_stem=False):
        super().__init__()
        blocks = STAGE_BLOCKS[layer]
        block_cls = Bottleneck if EXPANSION[layer] == 4 else BasicBlock
        self.deep_stem = deep_stem
        if deep_stem:
            for i, (ci, co) in enumerate(((3, 64), (64, 64), (64, 128))):
                self.add_module("Conv_%d" % i,
                                conv2d(ci, co, 3, 2 if i == 0 else 1, 1))
                self.add_module("SyncBatchNorm_%d" % i, SyncBatchNorm(co))
            cin = 128
        else:
            self.Conv_0 = StemConv7(3, 64, s2d=s2d_stem)
            self.SyncBatchNorm_0 = SyncBatchNorm(64)
            cin = 64
        self.blocks = []
        self.stage_ends = []
        for stage, n in enumerate(blocks):
            for i in range(n):
                stride = stage_strides[stage] if i == 0 else 1
                name = "%s_%d" % (block_cls.__name__, len(self.blocks))
                self.add_module(name, block_cls(cin, WIDTHS[stage], stride,
                                                stage_dilations[stage]))
                self.blocks.append(name)
                cin = WIDTHS[stage] * block_cls.expansion
            self.stage_ends.append(len(self.blocks))

    def forward(self, x):
        for i in range(3 if self.deep_stem else 1):
            x = F.relu(getattr(self, "SyncBatchNorm_%d" % i)(
                getattr(self, "Conv_%d" % i)(x)))
        x = max_pool(x, window=3, stride=2, padding=1)
        feats, k = [], 0
        for end in self.stage_ends:
            while k < end:
                x = getattr(self, self.blocks[k])(x)
                k += 1
            feats.append(x)
        return tuple(feats)


def feature_dims(layer=50):
    """Channel counts of (c2, c3, c4, c5)."""
    return tuple(d * EXPANSION[layer] for d in WIDTHS)
