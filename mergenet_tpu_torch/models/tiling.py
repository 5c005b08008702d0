"""Sliding-window ("tile") inference with flip ensembling
(`mergenet_tpu.models.tiling` is the reference, itself after the
original `tile_predict`, `models/pspnet_caffe.py:492-560`).

All windows of a batch and their horizontal flips go through one
batched forward on the images' device; the softmax probabilities of
each window (averaged with its flip's) are summed back into the frame
in window order, divided by the number of windows over each pixel and
renormalised.

The class remap follows the reference (`pspnet_caffe.py:548-554`): when
the model predicts `n_model_classes` semantic classes and the decoder
wants `n_instance_classes`, the background channel is the max over the
first `n_model_classes - n_instance_classes + 1` (non-instance)
channels and the instance channels are the tail."""

import torch


def _tile_grid(full, side):
    """Reference grid arithmetic (`pspnet_caffe.py:506-515`): n = full//side
    + 1 windows of `side` with stride (full - side) / n, ends clamped."""
    n = int(full / float(side)) + 1
    stride = (full - side) / float(n)
    return [int(i * stride) for i in range(n + 1)]


def tile_predict(apply_fn, imgs, n_instance_classes, input_size,
                 n_model_classes=None, include_flip_mode=True):
    """Tiled softmax-ensembled prediction.

    Args:
        apply_fn: (N, h, w, 3) tensor -> (N, h, w, C) logits.
        imgs: (N, H, W, 3) tensor; the work runs on its device.
        n_instance_classes: channels wanted by the decoder.
        input_size: (side_x, side_y) model window.
        n_model_classes: channels the model outputs (defaults to
            n_instance_classes, i.e. no remap).
        include_flip_mode: also average the horizontally-flipped
            prediction.
    Returns:
        (N, H, W, n_instance_classes) float32 probability maps,
        renormalised.
    """
    imgs = torch.as_tensor(imgs)
    n, h, w, _ = imgs.shape
    side_x, side_y = input_size
    if n_model_classes is None:
        n_model_classes = n_instance_classes
    tiles = []
    for sx in _tile_grid(h, side_x):
        ex = min(sx + side_x, h)
        sx = ex - side_x
        for sy in _tile_grid(w, side_y):
            ey = min(sy + side_y, w)
            sy = ey - side_y
            tiles.append((sx, sy))
    flat = torch.cat([imgs[:, sx:sx + side_x, sy:sy + side_y, :]
                      for sx, sy in tiles])  # (T * N, sx, sy, 3), tile-major
    m = flat.shape[0]
    if include_flip_mode:
        flat = torch.cat([flat, flat.flip(2)])
    probs = torch.softmax(apply_fn(flat).float(), dim=-1)
    if include_flip_mode:
        probs = (probs[:m] + probs[m:].flip(2)) / 2.0
    probs = probs.reshape(len(tiles), n, side_x, side_y, n_model_classes)

    if n_model_classes != n_instance_classes:
        n_bg = n_model_classes - n_instance_classes + 1
        background = probs[..., :n_bg].amax(-1, keepdim=True)
        probs = torch.cat([background, probs[..., n_bg:]], dim=-1)

    pred = probs.new_zeros((n, h, w, n_instance_classes))
    count = probs.new_zeros((h, w, 1))
    for t, (sx, sy) in enumerate(tiles):
        pred[:, sx:sx + side_x, sy:sy + side_y, :] += probs[t]
        count[sx:sx + side_x, sy:sy + side_y, :] += 1.0
    score = pred / count[None]
    return score / score.sum(-1, keepdim=True)
