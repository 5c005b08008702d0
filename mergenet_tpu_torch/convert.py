"""Flax parameter trees -> the port's state dict.

The reference's checkpoints are nested dicts of numpy arrays (`params`,
`batch_stats`), keyed by Flax module names, which the port's modules
reuse.  Conv kernels go HWIO -> OIHW; batch norm maps
`BatchNorm_0/{scale, bias}` and `{mean, var}` to
`weight, bias, running_mean, running_var`."""

import numpy as np
import torch


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
