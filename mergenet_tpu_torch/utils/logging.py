"""Minimal TensorBoard-compatible scalar logging
(`mergenet_tpu.utils.logging` is the reference): TensorBoard event files
when `torch.utils.tensorboard` imports (it needs the `tensorboard`
package), else an append-only `scalars.jsonl` under the same API."""

import json
import os
import time

_writer = None
_logdir = None


def configure(logdir):
    """Set the logging directory (API parity with tensorboard_logger)."""
    global _writer, _logdir
    _logdir = logdir
    os.makedirs(logdir, exist_ok=True)
    _writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return
    _writer = SummaryWriter(logdir)


def log_value(name, value, step=0):
    """Log a scalar; no-op unless configure() was called."""
    if _logdir is None:
        return
    if _writer is not None:
        _writer.add_scalar(name, float(value), int(step))
        return
    path = os.path.join(_logdir, "scalars.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps({"name": name, "value": float(value),
                            "step": int(step), "time": time.time()}) + "\n")
