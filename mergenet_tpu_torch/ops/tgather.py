"""Table gather out[n] = table[idx[n]] with the reference's index
normalisation: negative indices wrap once (i + M), then clamp into
[0, M).  Replaces `mergenet_tpu/ops/pallas/tgather.py::table_gather`
(kernel: `csrc/tgather.cu`)."""

import torch

from . import _build


def table_gather_plain(table, idx):
    """The plain PyTorch version (the CPU path and the card-side
    reference): wrap, clamp, then index."""
    m = table.shape[0]
    i = torch.where(idx < 0, idx + m, idx).clamp_(0, m - 1)
    return table[i]


def table_gather(table, idx):
    """table (M,) int32, M > 0; idx int32 of any shape, any values.
    Returns int32 of idx's shape."""
    _build.require(table.dtype == torch.int32 and table.dim() == 1
                   and table.shape[0] > 0, "table must be non-empty 1-D "
                   "int32, got %s %s" % (table.dtype, tuple(table.shape)))
    _build.require(idx.dtype == torch.int32, "idx must be int32, got %s"
                   % idx.dtype)
    if _build.kernel_device(table, idx) == "cpu":
        return table_gather_plain(table, idx)
    _build.require(table.is_contiguous() and idx.is_contiguous(),
                   "table_gather needs contiguous tensors")
    _build.require(idx.numel() < 2 ** 31 and table.shape[0] < 2 ** 31,
                   "table_gather sizes must fit int32")
    out = torch.empty_like(idx)
    lib = _build.library()
    with torch.cuda.device(idx.device):
        err = lib.mn_table_gather(table.data_ptr(), idx.data_ptr(),
                                  out.data_ptr(), idx.numel(),
                                  table.shape[0], _build.stream_of(idx))
    _build.check(err, "tgather")
    _build.LAUNCHES["tgather"] += 1
    return out
