"""Model entry points of the port: the PSPFPNet family only in this
slice (`mergenet_tpu.models` is the reference)."""

import torch

from .pspnet import FPNModule, PSPFPNet, PyramidPoolingModule  # noqa: F401
from .resnet import ResNetBackbone  # noqa: F401


@torch.no_grad()
def logits_at(model, x, size):
    """float32 LOGITS (N, h, w, C+O) at spatial `size` for an NHWC batch
    `x`, emitted directly at that size (the serving fast path; paired
    with `decode_hierarchical(from_logits=True)`)."""
    return model(x, output_size=tuple(size)).float()


@torch.no_grad()
def probs_at(model, x, size):
    """Sigmoid probabilities at spatial `size` for an NHWC batch `x`."""
    return torch.sigmoid(logits_at(model, x, size))
