"""The decoder's absorption-round edge scan: per pixel, the best
eligible same-class absorption edge over every offset in both
directions.  Replaces `mergenet_tpu/ops/pallas/absorb.py::
absorb_best_edges` (kernel: `csrc/absorb.cu`); the reference is the jnp
loop of `decoder/device.py::decode_hierarchical` stage 2.  Stats come
packed (`absorb_best_edges`, C <= 16) or unpacked
(`absorb_best_edges_unpacked`, C > 16, where the reference runs that jnp
loop); one kernel takes both."""

import ctypes

import torch

from . import _build
from .grid import shift2d

NEG_INF = -3.0e38
MAX_OFFSETS = 64  # csrc/absorb.cu kMaxOffsets


def absorb_plain_unpacked(comp2d, arg_own, size_own, froz_own, log_odds,
                          offsets, theta, size_cap):
    """The reference's per-offset plane loop on unpacked stats (the
    plain version of `absorb_best_edges_unpacked`)."""
    H, W = comp2d.shape
    best_pri = torch.full((H, W), NEG_INF, dtype=torch.float32,
                          device=comp2d.device)
    best_partner = torch.full((H, W), -1, dtype=torch.int32,
                              device=comp2d.device)
    for oi, (di, dj) in enumerate(offsets):
        nbr = shift2d(comp2d, di, dj, -1)
        arg_nbr = shift2d(arg_own, di, dj, -2)
        size_nbr = shift2d(size_own, di, dj, 0)
        froz_nbr = shift2d(froz_own, di, dj, True)
        oml = log_odds[oi]
        small = torch.minimum(size_own, size_nbr)
        ok = ((nbr >= 0) & (nbr != comp2d) & (arg_nbr == arg_own)
              & (small <= size_cap) & (oml >= theta) & ~froz_own
              & ~froz_nbr)
        up_fwd = (size_nbr > size_own) | ((size_nbr == size_own)
                                          & (nbr > comp2d))
        pri_f = torch.where(ok & up_fwd, oml, NEG_INF)
        pri_b = torch.where(ok & ~up_fwd, oml, NEG_INF)
        for p, q in ((pri_f, nbr),
                     (shift2d(pri_b, -di, -dj, NEG_INF),
                      shift2d(comp2d, -di, -dj, -1))):
            take = (p > best_pri) | ((p == best_pri) & (q > best_partner))
            best_pri = torch.where(take, p, best_pri)
            best_partner = torch.where(take, q, best_partner)
    return best_pri, best_partner


def absorb_plain(comp2d, packed_own, log_odds, offsets, theta, size_cap):
    """The plain PyTorch version on packed stats
    (size<<5 | argcls<<1 | frozen)."""
    return absorb_plain_unpacked(
        comp2d, (packed_own >> 1) & 15, packed_own >> 5,
        (packed_own & 1) == 1, log_odds, offsets, theta, size_cap)


def absorb_best_edges(comp2d, packed_own, log_odds, offsets, theta,
                      size_cap):
    """comp2d (H, W) int32; packed_own (H, W) int32; log_odds (O, H, W)
    float32.  Returns (best_pri (H, W) float32, best_partner (H, W)
    int32)."""
    _build.require(packed_own.dtype == torch.int32,
                   "absorb_best_edges: packed_own must be int32")
    _check(comp2d, (packed_own,), log_odds, offsets)
    if _build.kernel_device(comp2d, packed_own, log_odds) == "cpu":
        return absorb_plain(comp2d, packed_own, log_odds, offsets, theta,
                            size_cap)
    return _launch("mn_absorb_best_edges", comp2d, (packed_own,), log_odds,
                   offsets, theta, size_cap)


def absorb_best_edges_unpacked(comp2d, clsfz_own, size_own, log_odds,
                               offsets, theta, size_cap):
    """The same scan on unpacked stats, for C > 16 classes: clsfz_own
    (H, W) int32 holds argcls<<1 | frozen, size_own (H, W) int32 the
    unclamped size."""
    _build.require(clsfz_own.dtype == torch.int32
                   and size_own.dtype == torch.int32,
                   "absorb_best_edges_unpacked: stats must be int32")
    _check(comp2d, (clsfz_own, size_own), log_odds, offsets)
    if _build.kernel_device(comp2d, clsfz_own, size_own, log_odds) == "cpu":
        return absorb_plain_unpacked(
            comp2d, clsfz_own >> 1, size_own, (clsfz_own & 1) == 1,
            log_odds, offsets, theta, size_cap)
    return _launch("mn_absorb_best_edges_unpacked", comp2d,
                   (clsfz_own, size_own), log_odds, offsets, theta,
                   size_cap)


def _check(comp2d, stats, log_odds, offsets):
    H, W = comp2d.shape
    _build.require(comp2d.dtype == torch.int32
                   and log_odds.dtype == torch.float32,
                   "absorb_best_edges dtypes: int32 comp, float32 log_odds")
    _build.require(all(tuple(s.shape) == (H, W) for s in stats)
                   and tuple(log_odds.shape) == (len(offsets), H, W),
                   "absorb_best_edges shapes: (H, W) planes, (O, H, W) "
                   "log_odds")


def _launch(entry, comp2d, stats, log_odds, offsets, theta, size_cap):
    H, W = comp2d.shape
    O = len(offsets)
    _build.require(comp2d.is_contiguous() and log_odds.is_contiguous()
                   and all(s.is_contiguous() for s in stats),
                   "absorb_best_edges needs contiguous tensors")
    _build.require(O <= MAX_OFFSETS, "at most %d offsets" % MAX_OFFSETS)
    _build.require(H > 0 and W > 0 and max(O, 1) * H * W < 2 ** 31,
                   "grid must be non-empty and fit int32")
    best_pri = torch.empty((H, W), dtype=torch.float32,
                           device=comp2d.device)
    best_partner = torch.empty((H, W), dtype=torch.int32,
                               device=comp2d.device)
    offs = (ctypes.c_int * max(1, 2 * O))(
        *[int(v) for o in offsets for v in o])
    fn = getattr(_build.library(), entry)
    with torch.cuda.device(comp2d.device):
        err = fn(comp2d.data_ptr(), *[s.data_ptr() for s in stats],
                 log_odds.data_ptr(), best_pri.data_ptr(),
                 best_partner.data_ptr(), H, W,
                 ctypes.cast(offs, ctypes.c_void_p), O, float(theta),
                 int(size_cap), _build.stream_of(comp2d))
    _build.check(err, "absorb")
    _build.LAUNCHES["absorb"] += 1
    return best_pri, best_partner
