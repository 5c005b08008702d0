"""On-chip table lookup out[n] = table[idx[n]] for an int32 table and
in-range int32 indices (the contract of the TPU prototype
`scripts/bench_pallas_gather.py::pallas_gather`; kernel:
`csrc/pgather.cu`, which serves the table from L2).  An index outside
[0, M) is clamped into it, in the kernel and in the plain version
alike, so no lookup reads out of bounds.  Unlike `ops/tgather.py`,
negative indices do not wrap."""

import torch

from . import _build


def pgather_plain(table, idx):
    """The plain PyTorch version (the CPU path and the card-side
    reference): clamp into [0, M), then index."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def pgather(table, idx):
    """table (M,) int32, 0 < M < 2**31; idx (N,) int32, N < 2**31, both
    contiguous.  Returns (N,) int32."""
    _build.require(table.dtype == torch.int32 and table.dim() == 1
                   and table.shape[0] > 0, "table must be non-empty 1-D "
                   "int32, got %s %s" % (table.dtype, tuple(table.shape)))
    _build.require(idx.dtype == torch.int32 and idx.dim() == 1,
                   "idx must be 1-D int32, got %s %s"
                   % (idx.dtype, tuple(idx.shape)))
    _build.require(table.is_contiguous() and idx.is_contiguous(),
                   "pgather needs contiguous tensors")
    _build.require(idx.numel() < 2 ** 31 and table.shape[0] < 2 ** 31,
                   "pgather sizes must fit int32")
    if _build.kernel_device(table, idx) == "cpu":
        return pgather_plain(table, idx)
    out = torch.empty_like(idx)
    lib = _build.library()
    with torch.cuda.device(idx.device):
        err = lib.mn_pgather(table.data_ptr(), idx.data_ptr(),
                             out.data_ptr(), idx.numel(), table.shape[0],
                             _build.stream_of(idx))
    _build.check(err, "pgather")
    _build.LAUNCHES["pgather"] += 1
    return out
