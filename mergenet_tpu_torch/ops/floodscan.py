"""The flood fill's segmented min-scan sweeps.  Replaces
`mergenet_tpu/ops/pallas/floodscan.py::flood_scan` (kernel:
`csrc/floodscan.cu`); the reference function is
`decoder/device.py::_scan_sweeps`."""

import math

import torch

from . import _build

INT_MAX = 2147483647


def _shift(x, k, dim, fill):
    """out[p] = x[p - k] along `dim` (k may be negative), out-of-range
    -> fill."""
    out = torch.full_like(x, fill)
    n = x.shape[dim]
    if abs(k) >= n:
        return out
    if k >= 0:
        out.narrow(dim, k, n - k).copy_(x.narrow(dim, 0, n - k))
    else:
        out.narrow(dim, 0, n + k).copy_(x.narrow(dim, -k, n + k))
    return out


def _scan_axis(label, S, stride, dim):
    """Forward then reverse Hillis-Steele segmented min-scan along `dim`
    over the stride sublattices; S[p] links p and p + stride."""
    n = label.shape[dim]
    steps = max(1, math.ceil(math.log2(max(-(-n // stride), 2))))
    for sgn in (1, -1):
        g = _shift(S, stride, dim, False) if sgn > 0 else S
        for i in range(steps):
            d = sgn * (stride << i)
            vs = _shift(label, d, dim, INT_MAX)
            label = torch.where(g, torch.minimum(label, vs), label)
            g = g & _shift(g, d, dim, False)
    return label


def flood_scan_plain(h_S, v_S, s, t, ccl):
    """The plain PyTorch version: `ccl` sweeps of H (stride s, links h_S)
    then V (stride t, links v_S) segmented min-scans from the row-major
    iota label."""
    planes = [p for p in (h_S, v_S) if p is not None]
    H, W = planes[0].shape
    label = torch.arange(H * W, dtype=torch.int32,
                         device=planes[0].device).reshape(H, W)
    for _ in range(ccl):
        if h_S is not None:
            label = _scan_axis(label, h_S, s, 1)
        if v_S is not None:
            label = _scan_axis(label, v_S, t, 0)
    return label


def flood_scan(h_S, v_S, s, t, ccl):
    """All `ccl` sweeps from the row-major iota.  h_S / v_S: (H, W) bool
    link planes (S[p] links p and p + stride along the axis) or None;
    s / t their strides.  Returns (H, W) int32 labels."""
    planes = [p for p in (h_S, v_S) if p is not None]
    _build.require(planes, "flood_scan needs at least one link plane")
    H, W = planes[0].shape
    for p in planes:
        _build.require(p.dtype == torch.bool and tuple(p.shape) == (H, W),
                       "link planes must be (H, W) bool")
    _build.require((h_S is None or s >= 1) and (v_S is None or t >= 1),
                   "strides must be >= 1")
    if _build.kernel_device(*planes) == "cpu":
        return flood_scan_plain(h_S, v_S, s, t, ccl)
    _build.require(all(p.is_contiguous() for p in planes),
                   "flood_scan needs contiguous link planes")
    _build.require(H * W < 2 ** 31, "flood_scan grid must fit int32")
    out = torch.empty((H, W), dtype=torch.int32, device=planes[0].device)
    lib = _build.library()
    with torch.cuda.device(out.device):
        err = lib.mn_flood_scan(
            out.data_ptr(), None if h_S is None else h_S.data_ptr(),
            None if v_S is None else v_S.data_ptr(), H, W, s or 1, t or 1,
            ccl, _build.stream_of(out))
    _build.check(err, "floodscan")
    _build.LAUNCHES["floodscan"] += 1
    return out
