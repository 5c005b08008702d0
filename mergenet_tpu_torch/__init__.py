"""PyTorch/CUDA port of `mergenet_tpu`.

The JAX package beside it is the reference; this package imports torch
and numpy only (never jax, flax, cv2, PIL or `mergenet_tpu`), keeping
its own copies of the few pure-numpy pieces it needs.

Entry points take `device=None`, meaning "cuda"; they raise when no GPU
is present unless the caller passes `device="cpu"` (as the tests do).
The decode's hand-written sm_90a kernels (`ops/floodscan.py`,
`ops/absorb.py`, `ops/tgather.py`) launch on CUDA tensors; CPU tensors
take each kernel's plain PyTorch version.
"""

import torch


def resolve_device(device=None):
    """torch.device for an entry point: None means CUDA, which must be
    present; an explicit "cpu" is honoured as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mergenet_tpu_torch entry points run on the GPU by default and "
            "no CUDA device is available; pass device='cpu' explicitly "
            "to run on the CPU")
    return dev
