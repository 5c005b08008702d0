"""VGG16 feature extractor of the port (`mergenet_tpu.models.vgg` is
the reference): the five conv-block outputs the FCN heads tap
(torchvision's vgg16.features as the reference's `models/fcn.py`
slices it)."""

import torch.nn.functional as F
from torch import nn

from .layers import conv2d, max_pool

# (convs per block, channels)
_VGG16_CFG = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def vgg_width(channels, width_mult):
    """Width-scaled channel count (min 8); width_mult=1 is torchvision."""
    return max(8, int(channels * width_mult))


class VGG16Backbone(nn.Module):
    """Returns the outputs of each of the 5 blocks after their 2x2 max
    pool: strides 2/4/8/16/32.  Convs are 3x3 with bias and padding 1,
    numbered `Conv_0..Conv_12` across blocks; `width_mult` scales every
    block's channels (1.0 = torchvision's vgg16)."""

    def __init__(self, width_mult=1.0):
        super().__init__()
        self.block_ends = []
        cin, k = 3, 0
        for n_convs, width in _VGG16_CFG:
            cout = vgg_width(width, width_mult)
            for _ in range(n_convs):
                self.add_module("Conv_%d" % k,
                                conv2d(cin, cout, 3, padding=1, bias=True))
                cin = cout
                k += 1
            self.block_ends.append(k)

    def forward(self, x):
        features, k = [], 0
        for end in self.block_ends:
            while k < end:
                x = F.relu(getattr(self, "Conv_%d" % k)(x))
                k += 1
            x = max_pool(x)
            features.append(x)
        return tuple(features)
