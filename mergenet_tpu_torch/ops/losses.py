"""Losses of the class and offset heads (`mergenet_tpu.ops.losses` is
the reference): pure functions over channel-last (..., H, W, C) logits
and targets, written with the reference's formulas."""

import torch


def _bce_from_logits(logits, targets, weight=None):
    """Elementwise binary cross-entropy with logits, the reference's
    stable form: max(x, 0) - x * t + log(1 + exp(-|x|)), with JAX's
    derivatives at x == 0, where an exact 0 is common (a 1x1 conv head
    over all-zero ReLU features): `jnp.maximum` splits the gradient of
    max(x, 0) evenly (0.5) and `jnp.abs` has slope +1, so d/dx = -t
    there, not sigmoid(0) - t; `torch.maximum` splits as jnp does, and
    -|x| is written as a select with slope -1 at 0 (torch.abs has 0)."""
    neg_abs = torch.where(logits >= 0, -logits, logits)
    per_elem = (torch.maximum(logits, logits.new_zeros(()))
                - logits * targets + torch.log1p(torch.exp(neg_abs)))
    if weight is not None:
        per_elem = per_elem * weight
    return per_elem


def bce_with_logits_loss(logits, targets):
    """Mean binary cross-entropy with logits (the recipes' default)."""
    return _bce_from_logits(logits, targets).mean()


def weighted_bce_with_logits_loss(logits, targets, alpha=0.5):
    """BCE with constant positive/negative weighting."""
    weight = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return _bce_from_logits(logits, targets, weight).mean()


def multi_bce_with_logits_loss(logits, targets):
    """BCE re-weighted per (image, channel) by the predicted positive
    mass: weight = (n - sum(sigmoid) + 1) / (sum(sigmoid) + 1) on
    positives, n = H * W."""
    n = targets.shape[-3] * targets.shape[-2]
    prob_mass = torch.sigmoid(logits).sum(dim=(-3, -2), keepdim=True)
    pos_weight = (n - prob_mass + 1.0) / (prob_mass + 1.0)
    weight = pos_weight * targets + (1.0 - targets)
    return _bce_from_logits(logits, targets, weight).mean()


def soft_dice_loss(logits, targets, mode="1", smooth=1.0):
    """Soft dice over sigmoid probabilities, summed over channels; mode
    '0' complements both sides first (weights the boundary class)."""
    probs = torch.sigmoid(logits)
    if mode == "0":
        probs = 1.0 - probs
        targets = 1.0 - targets
    c = probs.shape[-1]
    p = probs.reshape(-1, c)
    t = targets.reshape(-1, c)
    intersection = (p * t).sum(dim=0)
    denom = p.sum(dim=0) + t.sum(dim=0)
    dice = (2.0 * intersection + smooth) / (denom + smooth)
    return (1.0 - dice).sum()


def cross_entropy_one_hot_loss(logits, targets):
    """Softmax cross-entropy against the argmax of a one-hot(ish)
    target."""
    labels = targets.argmax(dim=-1, keepdim=True)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels).mean()


def fused_class_offset_loss(logits, targets, num_classes, alpha=1.0,
                            class_loss=bce_with_logits_loss,
                            offset_loss=bce_with_logits_loss):
    """class_loss(logits[..., :C]) + alpha * offset_loss(logits[..., C:])
    over a channel-stacked (..., H, W, C+O) tensor; returns (total,
    (cls_loss, ofs_loss))."""
    cls = class_loss(logits[..., :num_classes], targets[..., :num_classes])
    ofs = offset_loss(logits[..., num_classes:], targets[..., num_classes:])
    return cls + alpha * ofs, (cls, ofs)


_LOSSES = {
    "bce": bce_with_logits_loss,
    "wbce": weighted_bce_with_logits_loss,
    "mbce": multi_bce_with_logits_loss,
    "dice": lambda lg, t: soft_dice_loss(lg, t, mode="0"),
    "ce": cross_entropy_one_hot_loss,
}


def get_loss_fn(name):
    """Loss registry keyed by the recipe flag names."""
    if name not in _LOSSES:
        raise ValueError("Unknown loss '{}'; choose from {}".format(
            name, sorted(_LOSSES)))
    return _LOSSES[name]
