"""FCN heads of the port over ResNet and VGG16 backbones
(`mergenet_tpu.models.fcn` is the reference): 1x1 score convs at
strides 32/16/8 fused by bilinear upsample-and-add, then a bilinear
resize to the output size.  NHWC in, float32 NHWC logits out."""

import torch.nn.functional as F
from torch import nn

from .layers import Dropout, conv2d, nhwc_logits, resize_bilinear, to_nchw
from .resnet import ResNetBackbone, feature_dims
from .vgg import VGG16Backbone, vgg_width


def _add_score_heads(model, num_outputs, scale, d32, d16, d8):
    """1x1 score convs (with bias) on the /32, /16 and /8 taps of
    `d32`, `d16`, `d8` channels, as far as `scale` asks."""
    if scale not in (8, 16, 32):
        raise ValueError("scale must be 8, 16 or 32")
    model.scale = scale
    model.score_32s = conv2d(d32, num_outputs, 1, bias=True)
    if scale <= 16:
        model.score_16s = conv2d(d16, num_outputs, 1, bias=True)
    if scale <= 8:
        model.score_8s = conv2d(d8, num_outputs, 1, bias=True)


def _fuse(model, score, tap16, tap8):
    """Add the /16 and /8 score maps to the upsampled coarser score, as
    far as the model's scale asks."""
    if model.scale <= 16:
        score = model.score_16s(tap16) + resize_bilinear(score,
                                                         tap16.shape[-2:])
    if model.scale <= 8:
        score = model.score_8s(tap8) + resize_bilinear(score,
                                                       tap8.shape[-2:])
    return score


class FCNResNet(nn.Module):
    """FCN-8s/16s/32s over a ResNet backbone (`layer` 18 to 152):
    `score_32s` on c5, `score_16s` on c4, `score_8s` on c3."""

    takes_output_size = True

    def __init__(self, num_outputs, scale=8, layer=18, dtype=None):
        super().__init__()
        self.dtype = dtype
        dims = feature_dims(layer)
        self.ResNetBackbone_0 = ResNetBackbone(layer)
        _add_score_heads(self, num_outputs, scale, dims[3], dims[2], dims[1])
        self.num_outputs = num_outputs

    def forward(self, x, output_size=None):
        """x: (N, H, W, 3) NHWC float.  Returns (N, h, w, num_outputs)
        float32 logits at `output_size` (default: the input size)."""
        out_size = tuple(output_size) if output_size else x.shape[1:3]
        _, c3, c4, c5 = self.ResNetBackbone_0(to_nchw(x, self.dtype))
        return nhwc_logits(_fuse(self, self.score_32s(c5), c4, c3),
                           out_size)


class FCNVGG16(nn.Module):
    """FCN-8s/16s/32s over VGG16: an fc-style head on the /32 features
    (a 7x7 conv to 4096, relu, dropout 0.5, a 1x1 conv to 4096, relu,
    dropout 0.5, `score_32s`), `score_16s` on block 4, `score_8s` on
    block 3.  `ref_head=True` pads the 7x7 VALID, as the reference's
    checkpoints were trained (the /32 map shrinks by 6); the default
    pads it 3 (SAME).  `width_mult` scales every width."""

    takes_output_size = True

    def __init__(self, num_outputs, scale=8, ref_head=False, width_mult=1.0,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        b5 = vgg_width(512, width_mult)
        fc = vgg_width(4096, width_mult)
        self.VGG16Backbone_0 = VGG16Backbone(width_mult)
        self.Conv_0 = conv2d(b5, fc, 7, padding=0 if ref_head else 3,
                             bias=True)
        self.Dropout_0 = Dropout(0.5)
        self.Conv_1 = conv2d(fc, fc, 1, bias=True)
        self.Dropout_1 = Dropout(0.5)
        _add_score_heads(self, num_outputs, scale, fc, b5,
                         vgg_width(256, width_mult))
        self.num_outputs = num_outputs

    def forward(self, x, output_size=None):
        out_size = tuple(output_size) if output_size else x.shape[1:3]
        _, _, b3, b4, b5 = self.VGG16Backbone_0(to_nchw(x, self.dtype))
        y = self.Dropout_0(F.relu(self.Conv_0(b5)))
        y = self.Dropout_1(F.relu(self.Conv_1(y)))
        return nhwc_logits(_fuse(self, self.score_32s(y), b4, b3), out_size)
