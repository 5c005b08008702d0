"""Checkpoints of the train state (`mergenet_tpu.utils.checkpoint` is
the reference): one `torch.save` file holding the parameters, the
batch-norm statistics, the optimizer's momentum buffers and the update
count, beside a `<name>.meta.json` with the epoch, the best IoU and the
offset list (part of the model contract: inference reads it back).
One process; the reference's multi-host barriers wait for the
data-parallel slice.

`import_torch_checkpoint` reads a checkpoint of the original torch
framework (`.pth.tar`) for `utils.weight_import`."""

import json
import os
import shutil

import torch


def save_checkpoint(dir, state, is_best, offsets=None, epoch=None,
                    best_iou=None, filename="checkpoint"):
    """Save `state` as `dir`/`filename` (+ .meta.json); copy both to
    `dir`/model_best when `is_best`."""
    os.makedirs(dir, exist_ok=True)
    path = os.path.join(dir, filename)
    params = dict(state.model.named_parameters())
    payload = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "batch_stats": {k: v.detach().cpu() for k, v in
                        state.model.state_dict().items() if k not in params},
        "opt_state": state.optimizer.state_dict(),
        "step": int(state.step),
    }
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    meta = {"epoch": epoch, "best_iou": best_iou,
            "offsets": [list(o) for o in offsets] if offsets else None}
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    if is_best:
        best = os.path.join(dir, "model_best")
        shutil.copyfile(path, best)
        shutil.copyfile(path + ".meta.json", best + ".meta.json")


def load_checkpoint(dir, state, filename="checkpoint"):
    """Restore a checkpoint into `state` in place; returns (state, meta).

    `dir` is the experiment directory (its `filename` checkpoint is
    loaded) or a checkpoint file such as `<exp>/model_best`.  The
    optimizer's hyperparameters stay `state.tx`'s, as optax's come from
    the code; the checkpoint supplies the momentum buffers, unless its
    optimizer state does not fit this optimizer (other parameter
    groups), when the fresh state is kept, as the reference does."""
    path = os.path.join(dir, filename)
    if not os.path.exists(path):  # `dir` is itself a checkpoint
        path = dir
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict({**ckpt["params"], **ckpt["batch_stats"]},
                                strict=True)
    try:
        state.optimizer.load_state_dict(ckpt["opt_state"])
    except ValueError:
        pass
    for group in state.optimizer.param_groups:
        group.update(momentum=state.tx.momentum,
                     nesterov=state.tx.nesterov,
                     weight_decay=state.tx.weight_decay)
    state.step = int(ckpt["step"])
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        if meta.get("offsets"):
            meta["offsets"] = [tuple(o) for o in meta["offsets"]]
    return state, meta


def import_torch_checkpoint(path):
    """Load a reference `.pth.tar` checkpoint (or a plain state dict)
    into a flat dict of numpy arrays keyed by the torch state-dict names,
    as torch stores them (convs OIHW, transposed convs (in, out, kh,
    kw)); a `model_state` entry is unwrapped.  Returns (flat_weights,
    metadata: `epoch`, `best_iou`, `offset` where present).  The file
    is a pickle (its metadata need not be tensors): load only
    checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = ckpt.get("model_state", ckpt)
    flat = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    meta = {k: ckpt[k] for k in ("epoch", "best_iou", "offset")
            if isinstance(ckpt, dict) and k in ckpt}
    return flat, meta
