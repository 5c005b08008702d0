"""End-to-end frame: net forward + hierarchical decode in memory, no
host round trip between them (`mergenet_tpu/utils/e2e.py` is the
reference; only its default 'hier' mode is ported)."""

import torch

from . import resolve_device
from .decoder.device import decode_hierarchical
from .models import logits_at


def upsample_nearest(mask, size):
    """Nearest-neighbour resize of an (h, w) label grid to `size` with
    half-pixel centres (`jax.image.resize(..., "nearest")`)."""
    h, w = mask.shape
    H, W = int(size[0]), int(size[1])
    rows = ((torch.arange(H, device=mask.device, dtype=torch.float64) + 0.5)
            * (h / H)).floor().long().clamp_(max=h - 1)
    cols = ((torch.arange(W, device=mask.device, dtype=torch.float64) + 0.5)
            * (w / W)).floor().long().clamp_(max=w - 1)
    return mask[rows][:, cols]


def build_e2e_infer(model, num_classes, offsets, decode_size=None,
                    same_different_bias=0.0, object_merge_factor=1.0,
                    merge_logprob_bias=0.03, dtype=None, device=None):
    """Returns infer(imgs) -> (masks (N, H, W) int32, inst_classes
    (N, M2) int32).

    imgs: (N, H, W, 3) uint8 images (numpy or tensor), scaled to [0, 1)
    by /256 as the reference's bench does.  The net runs at full
    resolution in `dtype` (None: float32) and emits logits directly at
    `decode_size` (default half resolution); `decode_hierarchical`
    decodes them (from_logits=True, relabel=True) and the mask is
    upsampled back with nearest neighbour.  `model` is moved to `device`
    (None means CUDA) and `dtype`."""
    dev = resolve_device(device)
    model = model.to(device=dev, dtype=dtype or torch.float32).eval()
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    kw = dict(same_different_bias=same_different_bias,
              object_merge_factor=object_merge_factor,
              merge_logprob_bias=merge_logprob_bias, relabel=True,
              from_logits=True, device=dev)

    @torch.no_grad()
    def infer(imgs):
        imgs = torch.as_tensor(imgs, device=dev)
        if imgs.dtype != torch.uint8 or imgs.dim() != 4:
            raise ValueError("imgs must be (N, H, W, 3) uint8")
        N, H, W = imgs.shape[:3]
        dh, dw = decode_size if decode_size else (H // 2, W // 2)
        masks, classes = [], []
        for n in range(N):
            x = (imgs[n:n + 1].float() / 256.0).to(dtype or torch.float32)
            logits = logits_at(model, x, (dh, dw))[0]
            mask, inst_class = decode_hierarchical(
                logits[..., :num_classes], logits[..., num_classes:],
                num_classes, offsets, **kw)
            masks.append(upsample_nearest(mask, (H, W)))
            classes.append(inst_class)
        return torch.stack(masks), torch.stack(classes)

    return infer
