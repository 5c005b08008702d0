"""Serving pipeline on one card: net forward -> certified
`decode_hierarchical` -> relabel -> nearest upsample per frame, with the
exact-mode overflow fallback (`mergenet_tpu/serving.py` is the
reference).

The reference shards the batch over a device mesh with `shard_map`;
here the frames of a batch run one after another on one `device`.
Serving over several cards waits for the port of the data-parallel
layer.

Overflow fallback: `decode_hierarchical`'s capacities are budgets; an
over-budget scene drops edges or pairs or freezes components (counted
by `return_stats`) and under-merges.  With `overflow_fallback=True` the
pipeline returns each frame's overflow count and re-decodes every
flagged frame with the exact mode (`run_segmentation_device`, whose
capacities are measured, so nothing can overflow) on the sigmoid
probabilities at the decode size."""

import torch

from . import resolve_device
from .decoder.device import decode_hierarchical, run_segmentation_device
from .e2e import upsample_nearest
from .models import logits_at, probs_at


def build_serving_pipeline(model, num_classes, offsets, decode_size=None,
                           dtype=None, same_different_bias=0.0,
                           object_merge_factor=1.0,
                           merge_logprob_bias=0.03, hier_kwargs=None,
                           overflow_fallback=False, device=None):
    """Returns serve(imgs) -> (masks, inst_classes[, overflow]).

    imgs: (B, H, W, 3) float images (numpy or tensor).  Masks come back
    at full resolution ((B, H, W) int32, ids 1..K per frame), with
    inst_classes (B, M) int32 mapping ids to classes (padded with -1).
    The net runs in `dtype` (None: float32) on `device` (None means
    CUDA) and emits its maps at `decode_size` (default half
    resolution).  With `overflow_fallback=True` a third element follows:
    the per-frame overflow counts (B,) int32 (edges + pairs dropped +
    frozen components; 0 means the budgets held), and every frame with
    a nonzero count is re-decoded with the exact mode."""
    dev = resolve_device(device)
    model = model.to(device=dev, dtype=dtype or torch.float32).eval()
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    hyper = dict(same_different_bias=same_different_bias,
                 object_merge_factor=object_merge_factor,
                 merge_logprob_bias=merge_logprob_bias)

    def net_input(img):
        return img[None].to(dtype or torch.float32)

    def one(img, dh, dw):
        logits = logits_at(model, net_input(img), (dh, dw))[0]
        out = decode_hierarchical(
            logits[..., :num_classes], logits[..., num_classes:],
            num_classes, offsets, relabel=True,
            return_stats=overflow_fallback, from_logits=True, device=dev,
            **hyper, **(hier_kwargs or {}))
        if overflow_fallback:
            mask, inst_class, stats = out
            overflow = (stats["edges_dropped"] + stats["pairs_dropped"]
                        + stats["n_frozen"])
        else:
            mask, inst_class = out
            overflow = torch.zeros((), dtype=torch.int32, device=dev)
        return upsample_nearest(mask, img.shape[:2]), inst_class, overflow

    def fallback(img, dh, dw, n_classes):
        """The exact decode of one frame: (full mask, class row)."""
        small = probs_at(model, net_input(img), (dh, dw))[0]
        mask, classes = run_segmentation_device(
            small[..., :num_classes].movedim(-1, 0),
            small[..., num_classes:].movedim(-1, 0), num_classes, offsets,
            mode="exact", device=dev, **hyper)
        full = upsample_nearest(torch.as_tensor(mask, device=dev),
                                img.shape[:2])
        row = torch.full((n_classes,), -1, dtype=torch.int32, device=dev)
        row[:len(classes)] = torch.tensor(classes, dtype=torch.int32)
        return full, row

    @torch.no_grad()
    def serve(imgs):
        imgs = torch.as_tensor(imgs, device=dev)
        if not imgs.is_floating_point() or imgs.dim() != 4:
            raise ValueError("imgs must be (B, H, W, 3) float")
        H, W = imgs.shape[1:3]
        dh, dw = decode_size if decode_size else (H // 2, W // 2)
        outs = [one(img, dh, dw) for img in imgs]
        masks = torch.stack([o[0] for o in outs])
        inst_classes = torch.stack([o[1] for o in outs])
        if not overflow_fallback:
            return masks, inst_classes
        overflow = torch.stack([o[2] for o in outs]).to(torch.int32)
        for b in torch.nonzero(overflow).flatten().tolist():
            masks[b], inst_classes[b] = fallback(imgs[b], dh, dw,
                                                 inst_classes.shape[1])
        return masks, inst_classes, overflow

    return serve
