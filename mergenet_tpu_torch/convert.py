"""Flax parameter trees <-> the port's state dict.

The reference's checkpoints are nested dicts of numpy arrays (`params`,
`batch_stats`), keyed by Flax module names, which the port's modules
reuse.  Conv kernels go HWIO -> OIHW; a `ConvTranspose_*` kernel (kh,
kw, in, out) becomes torch's (in, out, kh, kw) weight flipped in both
spatial axes (flax's transposed conv does not flip its kernel, torch's
does); batch norm maps `BatchNorm_0/{scale, bias}` and `{mean, var}` to
`weight, bias, running_mean, running_var`."""

import numpy as np
import torch

from .models.layers import ConvTranspose2d, SyncBatchNorm


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


def flax_to_state_dict(params, batch_stats, dtype=torch.float32):
    """State dict for the port's module from Flax (params, batch_stats)
    trees of numpy arrays, every tensor cast to `dtype`."""
    sd = {}
    for tree in (params, batch_stats):
        for path, arr in _flatten(tree):
            *mods, leaf = path
            if mods and mods[-1] == "BatchNorm_0":
                mods, name = mods[:-1], _BN_NAMES[leaf]
            elif leaf == "kernel" and mods[-1].startswith("ConvTranspose"):
                name = "weight"
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            elif leaf == "kernel":
                name = "weight"
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif leaf == "bias":
                name = "bias"
            else:
                raise KeyError("unmapped parameter %s" % "/".join(path))
            sd[".".join(list(mods) + [name])] = torch.from_numpy(
                np.array(arr)).to(dtype)  # a writable copy
    return sd


def load_flax_weights(model, params, batch_stats):
    """Load Flax trees into `model` (strict: every key must map), cast
    to the model's current parameter dtype."""
    dtype = next(model.parameters()).dtype
    model.load_state_dict(flax_to_state_dict(params, batch_stats, dtype),
                          strict=True)
    return model


def state_dict_to_flax(model):
    """The inverse of `load_flax_weights`: (params, batch_stats) Flax
    trees of float32 numpy arrays from `model`'s current state."""
    params, batch_stats = {}, {}
    for key, t in model.state_dict().items():
        *mods, name = key.split(".")
        mod = model.get_submodule(".".join(mods))
        arr = t.detach().float().cpu().numpy()
        tree = params
        if isinstance(mod, SyncBatchNorm):
            leaf = {v: k for k, v in _BN_NAMES.items()}[name]
            mods = mods + ["BatchNorm_0"]
            if name.startswith("running_"):
                tree = batch_stats
        elif name == "weight" and isinstance(mod, ConvTranspose2d):
            leaf, arr = "kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif name == "weight":
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            leaf = name
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return params, batch_stats
