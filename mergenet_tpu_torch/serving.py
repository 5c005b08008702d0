"""Serving pipeline on one card: net forward -> certified
`decode_hierarchical` -> relabel -> nearest upsample per frame, with the
exact-mode overflow fallback (`mergenet_tpu/serving.py` is the
reference).

Frames of a batch run one after another on one `device`.  With a
`mesh` of any shape (`parallel.mesh.make_mesh`, one rank per card) the
batch is sharded over its data axis, as the reference's `shard_map`
with `P("data")` shards it: each rank serves the contiguous slice of
its data index on its own card through the same single-card path (its
own flagged frames included), ranks that share a data index (over the
spatial and model axes) serve the same frames, replicated, and the
masks, classes and overflow counts are all-gathered so that every rank
returns the whole batch.

Overflow fallback: `decode_hierarchical`'s capacities are budgets; an
over-budget scene drops edges or pairs or freezes components (counted
by `return_stats`) and under-merges.  With `overflow_fallback=True` the
pipeline returns each frame's overflow count and re-decodes every
flagged frame with the exact mode (`run_segmentation_device`, whose
capacities are measured, so nothing can overflow) on the sigmoid
probabilities at the decode size."""

import copy

import torch

from . import resolve_device
from .decoder.device import decode_hierarchical, run_segmentation_device
from .e2e import upsample_nearest
from .models import logits_at, probs_at
from .parallel.mesh import all_gather_batch, check_mesh, local_slice


def build_serving_pipeline(model, num_classes, offsets, decode_size=None,
                           dtype=None, same_different_bias=0.0,
                           object_merge_factor=1.0,
                           merge_logprob_bias=0.03, hier_kwargs=None,
                           overflow_fallback=False, device=None,
                           mesh=None):
    """Returns serve(imgs) -> (masks, inst_classes[, overflow]).

    imgs: (B, H, W, 3) float images (numpy or tensor).  Masks come back
    at full resolution ((B, H, W) int32, ids 1..K per frame), with
    inst_classes (B, M) int32 mapping ids to classes (padded with -1).
    A copy of `model` runs, with every parameter and buffer cast to
    `dtype` (None: float32; the reference bench's bf16 route), on
    `device` (None means CUDA) and is `serve.model`; the caller's module
    is left as it was.
    The net emits its maps at `decode_size` (default half
    resolution).  With `overflow_fallback=True` a third element follows:
    the per-frame overflow counts (B,) int32 (edges + pairs dropped +
    frozen components; 0 means the budgets held), and every frame with
    a nonzero count is re-decoded with the exact mode.  With `mesh`,
    B must divide by its data axis; the model runs on the mesh's
    device, and every rank returns the whole batch."""
    if mesh is not None:
        device = check_mesh(mesh).device
    dev = resolve_device(device)
    model = copy.deepcopy(model).to(device=dev,
                                    dtype=dtype or torch.float32).eval()
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    hyper = dict(same_different_bias=same_different_bias,
                 object_merge_factor=object_merge_factor,
                 merge_logprob_bias=merge_logprob_bias)

    def net_input(img):
        return img[None].to(dtype or torch.float32)

    def one(img, dh, dw):
        # raw logits into the decode's log domain; models without
        # output_size (UNet) decode their resized probabilities
        raw = logits_at(model, net_input(img), (dh, dw))
        small = raw[0] if raw is not None \
            else probs_at(model, net_input(img), (dh, dw))[0]
        out = decode_hierarchical(
            small[..., :num_classes], small[..., num_classes:],
            num_classes, offsets, relabel=True,
            return_stats=overflow_fallback, from_logits=raw is not None,
            device=dev, **hyper, **(hier_kwargs or {}))
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

    def serve_local(imgs):
        H, W = imgs.shape[1:3]
        dh, dw = decode_size if decode_size else (H // 2, W // 2)
        outs = [one(img, dh, dw) for img in imgs]
        masks = torch.stack([o[0] for o in outs])
        inst_classes = torch.stack([o[1] for o in outs])
        overflow = torch.stack([o[2] for o in outs]).to(torch.int32)
        if overflow_fallback:
            for b in torch.nonzero(overflow).flatten().tolist():
                masks[b], inst_classes[b] = fallback(imgs[b], dh, dw,
                                                     inst_classes.shape[1])
        return masks, inst_classes, overflow

    @torch.no_grad()
    def serve(imgs):
        imgs = torch.as_tensor(imgs)
        if not imgs.is_floating_point() or imgs.dim() != 4:
            raise ValueError("imgs must be (B, H, W, 3) float")
        if mesh is not None:
            imgs = imgs[local_slice(imgs.shape[0], mesh)]
        out = serve_local(imgs.to(dev))
        if mesh is not None:
            out = tuple(all_gather_batch(t, mesh) for t in out)
        return out if overflow_fallback else out[:2]

    serve.model = model  # the copy it runs
    return serve
