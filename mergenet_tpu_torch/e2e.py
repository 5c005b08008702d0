"""End-to-end frame: net forward + merge decode in memory, no host round
trip between them (`mergenet_tpu/utils/e2e.py` is the reference)."""

import copy

import numpy as np
import torch

from . import resolve_device
from .data import rle as maskUtils
from .decoder.device import (decode_hierarchical, decode_on_device,
                             decode_on_device_staged, relabel_mask)
from .models import logits_at, probs_at


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
                    merge_logprob_bias=0.03, max_rounds=48,
                    max_components=None, max_edges=None, dtype=None,
                    decode_mode="hier", hier_kwargs=None, device=None):
    """Returns infer(imgs) -> (masks (N, H, W) int32, inst_classes
    (N, M) int32).

    imgs: (N, H, W, 3) float images (numpy or tensor), used as given,
    as the reference takes them: /256 RGB, or the caffe-style
    mean-subtracted BGR of `ClassDataset(caffe=True)`.  They are cast to
    `dtype` (None: float32); the net runs at full resolution and emits
    its maps at `decode_size` (default half resolution); the mask is
    upsampled back with nearest neighbour.  A copy of `model` runs, on
    `device` (None means CUDA) with every parameter and buffer cast to
    `dtype` (the reference bench's bf16 route, `bench.py:271-274`) and
    is `infer.model`; the caller's module is left as it was.

    decode_mode: 'hier' (default) decodes the raw logits with
    `decode_hierarchical` (from_logits=True, relabel=True; capacities
    from `hier_kwargs`).  'exact' decodes sigmoid probabilities with the
    staged exact decode (`decode_on_device_staged`), or, when
    `max_components` / `max_edges` are given, with the capped
    single-pass `decode_on_device`; `relabel_mask` then numbers the
    instances."""
    if decode_mode not in ("hier", "exact"):
        raise ValueError("decode_mode must be 'hier' or 'exact', got %r"
                         % (decode_mode,))
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(device=dev,
                                    dtype=dtype or torch.float32).eval()
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    kw = dict(same_different_bias=same_different_bias,
              object_merge_factor=object_merge_factor,
              merge_logprob_bias=merge_logprob_bias, device=dev)

    def decode(x, dh, dw):
        if decode_mode == "hier":
            # models without output_size (UNet) decode probabilities
            raw = logits_at(model, x, (dh, dw))
            small = raw[0] if raw is not None \
                else probs_at(model, x, (dh, dw))[0]
            return decode_hierarchical(
                small[..., :num_classes], small[..., num_classes:],
                num_classes, offsets, relabel=True,
                from_logits=raw is not None, **kw, **(hier_kwargs or {}))
        small = probs_at(model, x, (dh, dw))[0]
        cp, sp = small[..., :num_classes], small[..., num_classes:]
        if max_components is None and max_edges is None:
            out = decode_on_device_staged(cp, sp, num_classes, offsets,
                                          max_rounds=max_rounds, **kw)
        else:
            out = decode_on_device(cp, sp, num_classes, offsets,
                                   max_components=max_components,
                                   max_edges=max_edges,
                                   max_rounds=max_rounds, **kw)
        return relabel_mask(*out)

    @torch.no_grad()
    def infer(imgs):
        imgs = torch.as_tensor(imgs, device=dev)
        if (not imgs.is_floating_point() or imgs.dim() != 4
                or imgs.shape[-1] != 3):
            raise ValueError("imgs must be (N, H, W, 3) float, got %s %s"
                             % (imgs.dtype, tuple(imgs.shape)))
        N, H, W = imgs.shape[:3]
        dh, dw = decode_size if decode_size else (H // 2, W // 2)
        masks, classes = [], []
        for n in range(N):
            x = imgs[n:n + 1].to(dtype or torch.float32)
            mask, inst_class = decode(x, dh, dw)
            masks.append(upsample_nearest(mask, (H, W)))
            classes.append(inst_class)
        return torch.stack(masks), torch.stack(classes)

    infer.model = model  # the copy it runs
    return infer


def masks_to_results(masks, inst_classes, image_ids, catIds):
    """Convert a decoded batch into COCO result dicts (host side).

    masks: (N, H, W) instance ids 1..K (0 = background); inst_classes:
    (N, M) class per instance id - 1, -1 past the last; numpy arrays or
    tensors on any device.  Instance k of image b becomes one result with
    category catIds[class] and score 1."""
    masks, inst_classes = (t.cpu().numpy() if torch.is_tensor(t)
                           else np.asarray(t) for t in (masks, inst_classes))
    out = []
    for b in range(masks.shape[0]):
        mask = masks[b]
        for i in range(1, int(mask.max()) + 1):
            cls = int(inst_classes[b][i - 1])
            if cls < 0:
                continue
            m = (mask == i).astype(np.uint8)
            out.append({
                "image_id": int(image_ids[b]),
                "score": 1,
                "category_id": catIds[cls],
                "segmentation": maskUtils.encode(np.asfortranarray(m)),
            })
    return out
