"""On-device merge decoders, ported to PyTorch
(`mergenet_tpu/decoder/device.py` is the reference).

`decode_hierarchical` runs the reference's four stages — conservative
flood fill, same-class absorption rounds, pair dedup, aggregated
Boruvka pair rounds.  The exact mode (`run_segmentation_device`) runs
the rolls-only first round (`boruvka_rolls_round`), then annealed pair
rounds with capacities measured on the host (`_pair_exact_finish`);
`decode_on_device` runs Boruvka rounds over all (pixel, offset) edges.
Every `lax.cond` branch is a Python branch on a device scalar and every
`while_loop` a Python loop with the reference's cap, which raises
instead of returning an unconverged result.  The reference's 2-key
(lo, hi) sorts are stable sorts of one int64 key lo * P + hi (torch has
no multi-key sort).  Layout at the public functions is the reference's:
(H, W, C) class maps, (H, W, O) sameness maps.

Kernels: the flood fill's scans (`ops/floodscan.py`), the absorption
edge scan (`ops/absorb.py`) and the table gather (`ops/tgather.py`:
the run-budget-overflow branch, `decode_on_device`'s final lookup and
`relabel_mask`) launch hand-written CUDA kernels on CUDA tensors.

Arithmetic follows the reference's order so that the CPU result equals
the reference's on the CPU: float running sums reproduce XLA's blocked
cumsum (`_cumsum_f32`), compensated scans reproduce
`lax.associative_scan`'s pairing (`_associative_scan`), and per-segment
float sums run in index order (`_scatter_add`; on CUDA the sort-based
deterministic `index_put_`, never atomics).  The logs of probabilities
and the priorities' multiply-adds follow XLA's CPU arithmetic (its
Cephes log and log1p, its fused multiply-add: `_log32`, `_log1p32`,
`_fma32`) in IEEE operations, so the card, the CPU and the reference
get the same bits.  Integer packing stays int32 (torch's cumsum and sum
would widen to int64 unless told)."""

import numpy as np
import torch

from .. import resolve_device
from ..ops import absorb as _absorb
from ..ops import floodscan as _floodscan
from ..ops import tgather as _tgather_op
from ..ops.grid import shift2d as _shift2d

NEG_INF = -3.0e38
I32 = torch.int32
F32 = torch.float32

#: run-compaction table size: in budget when a label grid has at most
#: this many column-major runs; beyond it `_densify_stats`,
#: `_run_apply` and `_run_segment_max` take their per-pixel paths.
#: Read at call time, so lowering it forces the overflow branch.
RUN_SLOTS = 32768

#: live-prefix bound for the component-table work of
#: `decode_hierarchical` (the reference's `SMALL = min(16384, M)`)
SMALL = 16384


# ---------------------------------------------------------------- scans

def _arange(n, device):
    return torch.arange(n, dtype=I32, device=device)


def _cumsum_i32(x, dim=0):
    return torch.cumsum(x, dim=dim, dtype=I32)


def _cumsum_f32(x, dim=-1, block=16):
    """float32 running sum along `dim` in the summation order of XLA's
    CPU cumsum (sequential within blocks of 16, block totals summed the
    same way recursively, bases added last), so CPU results equal the
    reference's bit for bit and the card's equal the CPU's."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= block:
        cols = [x[..., 0]]
        for k in range(1, n):
            cols.append(cols[-1] + x[..., k])
        return torch.stack(cols, dim=-1).movedim(-1, dim)
    nb = -(-n // block)
    xp = torch.nn.functional.pad(x, (0, nb * block - n))
    within = _cumsum_f32(xp.reshape(*x.shape[:-1], nb, block), -1, block)
    inc = _cumsum_f32(within[..., -1], -1, block)
    exc = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    out = (within + exc[..., None]).reshape(*x.shape[:-1], nb * block)
    return out[..., :n].movedim(-1, dim)


def _interleave(a, b, dim):
    n = a.shape[dim] + b.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = b
    return out


def _associative_scan(fn, elems, dim=0, reverse=False):
    """Inclusive scan with `lax.associative_scan`'s exact pairing
    (odd/even recursion), so a float combiner rounds as the reference's
    does.  fn(a, b) combines tuples, a earlier than b."""
    elems = tuple(e.flip(dim) if reverse else e for e in elems)

    def sl(e, start, stop=None, step=1):
        idx = [slice(None)] * e.dim()
        idx[dim] = slice(start, stop, step)
        return e[tuple(idx)]

    def scan(es):
        n = es[0].shape[dim]
        if n < 2:
            return es
        reduced = fn(tuple(sl(e, 0, n - 1, 2) for e in es),
                     tuple(sl(e, 1, None, 2) for e in es))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(sl(e, 0, -1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in es))
        else:
            even = fn(odd, tuple(sl(e, 2, None, 2) for e in es))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim)
                     for e, r in zip(es, even))
        return tuple(_interleave(a, b, dim) for a, b in zip(even, odd))

    out = scan(elems)
    return tuple(o.flip(dim) if reverse else o for o in out)


def _two_sum(a, b):
    """TwoSum-carry combiner for compensated scans."""
    ah, al = a
    bh, bl = b
    s = ah + bh
    z = s - ah
    e = (ah - (s - z)) + (bh - z)
    return (s, al + bl + e)


def _stable_cumsum(x, block=1024):
    """Running sum whose differences between nearby read-out points
    stay accurate at millions of elements: blocked cumsums plus a
    compensated scan over the block totals."""
    n = x.shape[0]
    nb = -(-n // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - n)).reshape(nb, block)
    within = _cumsum_f32(xb, 1)
    btot = within[:, -1]
    hi, lo = _associative_scan(_two_sum, (btot, torch.zeros_like(btot)))
    base = torch.cat([torch.zeros_like(btot[:1]), (hi + lo)[:-1]])
    return (base[:, None] + within).reshape(-1)[:n]


def _stable_cumsum_rows(x, block=1024):
    """Row-wise `_stable_cumsum` along axis 1 of an (R, B) array."""
    R, B = x.shape
    if B <= block:
        return _cumsum_f32(x, 1)
    nb = -(-B // block)
    xb = torch.nn.functional.pad(x, (0, nb * block - B)).reshape(
        R, nb, block)
    within = _cumsum_f32(xb, 2)
    btot = within[:, :, -1]
    hi, lo = _associative_scan(_two_sum, (btot, torch.zeros_like(btot)),
                               dim=1)
    base = torch.cat([torch.zeros_like(btot[:, :1]), (hi + lo)[:, :-1]], 1)
    return (base[:, :, None] + within).reshape(R, nb * block)[:, :B]




# ------------------------------------------------------ segment reduces

def _scatter_add(x, idx, v):
    """x.at[idx].add(v) along dim 0: sequential in index order on the
    CPU (the reference's order); the deterministic sort-based
    `index_put_` on CUDA."""
    if x.device.type == "cpu":
        return x.clone().index_add_(0, idx, v)
    return x.clone().index_put_((idx.long(),), v, accumulate=True)


def _segment_sum(v, idx, num_segments):
    return _scatter_add(
        v.new_zeros((num_segments,) + tuple(v.shape[1:])), idx, v)


def _segment_max(v, idx, num_segments):
    """1-D segment max; empty segments hold -inf / the int32 minimum."""
    init = (float("-inf") if v.is_floating_point()
            else torch.iinfo(v.dtype).min)
    out = torch.full((num_segments,), init, dtype=v.dtype, device=v.device)
    return out.scatter_reduce_(0, idx.long(), v, "amax", include_self=True)


def _sort(keys, *payloads, dim=-1):
    """Stable 1-key sort carrying payloads (`lax.sort(num_keys=1)`)."""
    ks, perm = torch.sort(keys, dim=dim, stable=True)
    return (ks,) + tuple(torch.gather(p, dim, perm) for p in payloads)


# ------------------------------------------------------------ pre/flood

def _fma32(a, b, c):
    """float32 a * b + c with one rounding: the fused multiply-add that
    the reference's XLA program computes on the CPU, whose backend
    contracts a product followed by a sum.  `a` is a float32 tensor, `b`
    and `c` float32 tensors or Python floats holding float32 values.
    The product is exact in float64, so only the sum rounds (to float64,
    then to float32; no input tried rounded differently from a true
    fused multiply-add), and the card gets the same bits as the CPU."""
    if not torch.is_tensor(b) and b == 1.0:  # a * 1 is exact
        return a + c
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def _f32(v):
    return float(np.float32(v))


#: the Cephes coefficients of XLA's float32 log on the CPU
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
#: the Cephes rational approximation of XLA's float32 log1p for
#: |x| < sqrt(2) - 1 (numerator and denominator, highest degree first)
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(_f32(v) for v in (
    1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))


def _log32(x):
    """float32 log of positive finite x, computed as the reference's XLA
    program computes it on the CPU: Cephes range reduction to a mantissa
    in [sqrt(1/2), sqrt(2)) and a degree-8 polynomial with XLA's fused
    multiply-adds (`_fma32`).  Every step is an IEEE float32 or float64
    operation, so the CPU and the card get the same bits, and they equal
    the reference's (torch's float32 log differs from both by an ulp in
    places, enough to flip near-tie merges of the exact mode)."""
    x = torch.clamp_min(x.to(F32), _f32(1.17549435e-38))  # smallest normal
    bits = x.view(I32)
    e = ((bits >> 23) - 127).to(F32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(F32)  # in [0.5, 1)
    small = m < _f32(0.707106781186547524)
    e = e - small.to(F32)
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma32(_fma32(t, p[0], p[1]), t, p[2])
    y1 = _fma32(_fma32(t, p[3], p[4]), t, p[5])
    y2 = _fma32(_fma32(t, p[6], p[7]), t, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, _LOG_Q1 * e)
    return (t - 0.5 * x2) + y + _LOG_Q2 * e


def _log1p32(x):
    """float32 log1p of x > -1 as the reference's XLA program computes
    it on the CPU: `_log32(1 + x)`, or for |x| < sqrt(2) - 1 the Cephes
    rational approximation, Horner steps fused (`_fma32`)."""
    x = x.to(F32)

    def horner(coeffs):
        poly = torch.full_like(x, coeffs[0])
        for c in coeffs[1:]:
            poly = _fma32(poly, x, c)
        return poly

    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (horner(_LOG1P_NUM)
                                         / horner(_LOG1P_DEN)))
    return torch.where(x.abs() < _f32(0.41421356237309504880), small,
                       _log32(1.0 + x))


def _log_domain(class_probs, sameness_probs, same_different_bias,
                from_logits=False):
    """Clipped log class probs (H, W, C) and sameness log-odds, plane
    major (O, H, W).  With `from_logits` the inputs are raw logits and
    the sigmoid -> clip -> log round trip is collapsed algebraically.
    From probabilities, the logs are `_log32` / `_log1p32`."""
    dev = class_probs.device
    eps = torch.tensor(1.1920929e-07, dtype=F32, device=dev)
    if from_logits:
        L = 15.942385  # log((1-eps)/eps)
        cl = class_probs.to(F32)
        sl = sameness_probs.movedim(-1, 0).to(F32)
        x = -cl  # -softplus(-cl), softplus(x) = max(x, 0) + log1p(e^-|x|)
        sp_ = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
        cls_lp_pix = torch.minimum(torch.maximum(-sp_, torch.log(eps)),
                                   torch.log1p(-eps))
        log_odds = torch.clamp(sl, -L, L)
        if same_different_bias:
            log_odds = torch.clamp(log_odds + same_different_bias, -L, L)
        return cls_lp_pix, log_odds.contiguous()
    one_m = 1.0 - eps
    cp = torch.minimum(torch.maximum(class_probs.to(F32), eps), one_m)
    sp = torch.minimum(torch.maximum(
        sameness_probs.movedim(-1, 0).to(F32), eps), one_m)
    if same_different_bias:
        logit = _log32(sp) - _log1p32(-sp) + same_different_bias
        sp = torch.minimum(torch.maximum(torch.sigmoid(logit), eps), one_m)
    return _log32(cp), (_log32(sp) - _log1p32(-sp)).contiguous()


def _contract(parent, two_cycle_break=True):
    """Pointer-jump a 1-D int32 forest to a fixed point.  The loop is
    capped at ceil(log2 n) jumps, which suffice for any forest; a parent
    array that is not a fixed point after them holds a cycle, and the
    function raises instead of returning it."""
    n = parent.shape[0]
    ids = _arange(n, parent.device)
    if two_cycle_break:
        parent = torch.where((parent[parent] == ids) & (ids < parent), ids,
                             parent)
    n_jump = max(1, int(np.ceil(np.log2(max(n, 2)))))
    changed, it = True, 0
    while changed and it < n_jump:
        p2 = parent[parent]
        changed = bool((p2 != parent).any())
        parent = p2
        it += 1
    if changed and bool((parent[parent] != parent).any()):
        raise RuntimeError(
            "_contract: pointer jumping reached its cap of %d jumps (n=%d) "
            "without a fixed point; the parent array has a cycle"
            % (n_jump, n))
    return parent


def _contract_prefix(parent, n_live, small=8192):
    """`_contract` for a forest whose live entries are the prefix
    [0, n_live); runs on the [:small] slice when n_live fits it."""
    M = parent.shape[0]
    if small >= M or int(n_live) > small:
        return _contract(parent)
    out = parent.clone()
    out[:small] = _contract(parent[:small])
    return out


def _flood_links(argmax_pix, log_odds, offsets, den_mode, omf, bias,
                 ccl_margin):
    """The flood fill's strong-link planes: (h_links, v_links), each
    (S (H, W) bool, stride) or None, with S[p] the strong edge between
    p and p + stride along the axis (after the erosion guard)."""
    H, W = argmax_pix.shape
    dev = argmax_pix.device
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]

    def strong_edge(oi, di, dj):
        same_cls = argmax_pix == torch.roll(argmax_pix, (-di, -dj), (0, 1))
        oml = log_odds[oi]
        if den_mode == "sum":
            pri = oml * omf / 2.0 + bias
        else:
            pri = _fma32(oml, omf, bias)
        ok = same_cls & (pri >= 0.0) & (oml > ccl_margin)
        if di > 0:
            ok = ok & (rows < H - di)
        elif di < 0:
            ok = ok & (rows >= -di)
        if dj > 0:
            ok = ok & (cols < W - dj)
        elif dj < 0:
            ok = ok & (cols >= -dj)
        return ok

    offs = list(offsets)

    def axis_links(axis):
        cands = [(i, o) for i, o in enumerate(offs)
                 if o[1 - axis] == 0 and o[axis] != 0]
        if not cands:
            return None
        oi, o = min(cands, key=lambda t: abs(t[1][axis]))
        d = o[axis]
        s = abs(d)
        if (H, W)[axis] % s != 0:
            return None
        e = strong_edge(oi, *o)
        if d < 0:
            e = torch.roll(e, -s, axis)
        return e, s

    h_links = axis_links(1)
    v_links = axis_links(0)
    pixel_ok = torch.ones((H, W), dtype=torch.bool, device=dev)
    for links, axis in ((h_links, 1), (v_links, 0)):
        if links is None or ccl_margin <= 0:
            continue
        S, stride = links
        pos = rows if axis == 0 else cols
        extent = (H, W)[axis]
        oob_fwd = pos >= extent - stride
        oob_bwd = pos < stride
        bwd = torch.roll(S, stride, axis)
        pixel_ok = pixel_ok & (S | oob_fwd) & (bwd | oob_bwd)
    if h_links is not None:
        S, stride = h_links
        h_links = (S & pixel_ok & torch.roll(pixel_ok, -stride, 1), stride)
    if v_links is not None:
        S, stride = v_links
        v_links = (S & pixel_ok & torch.roll(pixel_ok, -stride, 0), stride)
    return h_links, v_links


def _flood_fill(argmax_pix, log_odds, offsets, den_mode, omf, bias,
                ccl_sweeps, ccl_margin):
    """Segmented-scan flood fill over strong unit-stride edges; returns
    self-rooted root-pixel-id labels (H, W) int32."""
    H, W = argmax_pix.shape
    label = _arange(H * W, argmax_pix.device).reshape(H, W)
    if not ccl_sweeps:
        return label
    h_links, v_links = _flood_links(argmax_pix, log_odds, offsets, den_mode,
                                    omf, bias, ccl_margin)
    if h_links is not None or v_links is not None:
        label = _floodscan.flood_scan(
            None if h_links is None else h_links[0].contiguous(),
            None if v_links is None else v_links[0].contiguous(),
            0 if h_links is None else h_links[1],
            0 if v_links is None else v_links[1], ccl_sweeps)
        # the min-scans give label[p] <= p (acyclic): no 2-cycle break;
        # _contract raises if a wrong label left a cycle
        label = _contract(label.reshape(-1),
                          two_cycle_break=False).reshape(H, W)
    return label


# ---------------------------------------------------------- run compaction

def _col_run_ends(label):
    """Column-major run structure: (lab_cm (N,), last (N,) run-end
    flags, gidx (N,) int32 global run index)."""
    lt = label.t()
    W, H = lt.shape
    first = torch.cat([torch.ones((W, 1), dtype=torch.bool,
                                  device=label.device),
                       lt[:, 1:] != lt[:, :-1]], 1)
    last = torch.cat([first[:, 1:], torch.ones((W, 1), dtype=torch.bool,
                                               device=label.device)], 1)
    gidx = _cumsum_i32(first.reshape(-1)) - 1
    return lt.reshape(-1), last.reshape(-1), gidx


def _run_fill_cols(ends_val, H, W):
    """Broadcast per-run values (at run-end positions, -1 elsewhere,
    column-major (N,)) to every pixel of the run.  Returns (H, W)."""
    y = ends_val.reshape(W, H).flip(1)
    ar = torch.arange(H, device=y.device)
    last_ok = torch.where(y >= 0, ar, -1).cummax(dim=1).values
    filled = torch.gather(y, 1, last_ok.clamp(min=0))
    filled = torch.where(last_ok >= 0, filled, y[:, :1])
    return filled.flip(1).t()


def absorb_stats(cls_lp, size, frozen, pack_stats):
    """Stage 2's per-component stats in the absorb kernel's layouts:
    (size<<5 | argcls<<1 | frozen,) with sizes clamped to 2^26 - 1 when
    `pack_stats` (C <= 16), else (argcls<<1 | frozen, size)."""
    argcls = torch.argmax(cls_lp, dim=1).to(I32)
    clsfz = (argcls << 1) | frozen.to(I32)
    if pack_stats:
        return ((torch.clamp_max(size, (1 << 26) - 1) << 5) | clsfz,)
    return clsfz, size


def _run_apply(table, comp_c, comp2d_s1, runs, vals_c=None, table_fn=None):
    """table[comp2d_s1] at run granularity; the per-pixel table gather
    (the tgather kernel on CUDA) when the grid exceeded the run budget.
    `vals_c` / `table_fn` as in the reference."""
    pos, _, _, runs_ok = runs
    H, W = comp2d_s1.shape
    if bool(runs_ok):
        v = table[comp_c] if vals_c is None else vals_c
        ends = torch.full((H * W,), -1, dtype=I32, device=comp_c.device)
        ends[pos] = v
        return _run_fill_cols(ends, H, W)
    tab = table if table_fn is None else table_fn()
    return _tgather_op.table_gather(tab.contiguous(), comp2d_s1.contiguous())


def _run_segment_max(vals2d, comp2d, comp_c, runs, M):
    """segment_max(vals2d, comp2d, M) at run granularity (a segmented
    column cummax read at the run ends), or per pixel beyond the run
    budget.  vals2d (H, W) int32."""
    pos, _, first_cm, runs_ok = runs
    H, W = vals2d.shape
    if bool(runs_ok):
        v = vals2d.t().to(torch.int64) + 2 ** 31
        f = first_cm.reshape(W, H)
        run = torch.cumsum(f, dim=1)
        # run index in the high bits: a running max never crosses a run
        m = torch.cummax((run << 32) | v, dim=1).values
        m = ((m & 0xFFFFFFFF) - 2 ** 31).to(I32)
        return _segment_max(m.reshape(-1)[pos], comp_c, M)
    return _segment_max(vals2d.reshape(-1), comp2d.reshape(-1), M)


def _densify_stats_runs(label, cls_lp_pix, M, G=None):
    """Run-compacted densify + per-component stats (the fast path; the
    caller falls back when the grid has more than G = RUN_SLOTS column
    runs).  Returns (comp_of_pix, cls_lp (M, C), size (M,), frozen (M,),
    n_comp_total, n_runs, runs)."""
    H, W = label.shape
    C = cls_lp_pix.shape[-1]
    N = H * W
    dev = label.device
    G = min(RUN_SLOTS if G is None else G, N)
    flat = label.reshape(-1).to(I32)
    dense = _cumsum_i32((flat == _arange(N, dev)).to(I32)) - 1
    n_comp_total = dense[N - 1] + 1

    lab_cm, last, gidx = _col_run_ends(label)
    n_runs = gidx[N - 1] + 1
    keys = torch.where(last, gidx, N)
    _, pos = _sort(keys, _arange(N, dev))
    slot = _arange(G, dev)
    valid = slot < torch.minimum(n_runs, torch.tensor(G, device=dev))
    pos = torch.where(valid, pos[:G], N - 1)
    comp_c = torch.clamp_max(dense[lab_cm[pos]], M - 1)

    vals = torch.cat([cls_lp_pix, torch.ones((H, W, 1), dtype=F32,
                                             device=dev)], -1)
    cum = _cumsum_f32(vals.permute(1, 0, 2), 1)  # per-column (W, H, C+1)
    vals_c = cum.reshape(N, C + 1)[pos]
    prev_pos = torch.cat([torch.full((1,), -1, dtype=I32, device=dev),
                          pos[:-1]])
    same_col = torch.div(pos, H, rounding_mode="floor") == torch.div(
        prev_pos, H, rounding_mode="floor")
    prev_vals = torch.cat([torch.zeros((1, C + 1), dtype=F32, device=dev),
                           vals_c[:-1]], 0)
    partial = vals_c - torch.where(same_col[:, None], prev_vals, 0.0)
    partial = torch.where(valid[:, None], partial, 0.0)
    agg = _segment_sum(partial, comp_c, M)

    ends_val = torch.full((N,), -1, dtype=I32, device=dev)
    ends_val[pos] = comp_c
    comp_of_pix = _run_fill_cols(ends_val, H, W)

    frozen = torch.zeros((M,), dtype=torch.bool, device=dev)
    frozen[M - 1] = n_comp_total > M
    first_cm = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          last[:-1]])
    runs = (pos, comp_c, first_cm, n_runs <= G)
    return (comp_of_pix, agg[:, :C], agg[:, C].to(I32), frozen,
            n_comp_total, n_runs, runs)


def _densify_stats(label, cls_lp_pix, M, return_runs=False):
    """Densify self-rooted root-pixel labels to component ids in [0, M)
    with per-component (cls_lp, size); components beyond M clamp into
    the frozen slot M-1.  Run-compacted when the grid's column-run count
    fits RUN_SLOTS, else per pixel."""
    H, W = label.shape
    C = cls_lp_pix.shape[-1]
    N = H * W
    (comp2d, cls_lp, size, frozen, n_comp_total,
     n_runs, runs) = _densify_stats_runs(label, cls_lp_pix, M)
    if int(n_runs) > min(RUN_SLOTS, N):
        flat = label.reshape(-1).to(I32)
        dense = _cumsum_i32((flat == _arange(N, flat.device)).to(I32)) - 1
        comp_of_pix = torch.clamp_max(dense[flat], M - 1)
        agg = _segment_sum(
            torch.cat([cls_lp_pix.reshape(N, C),
                       torch.ones((N, 1), dtype=F32, device=flat.device)],
                      1), comp_of_pix, M)
        comp2d, cls_lp = comp_of_pix.reshape(H, W), agg[:, :C]
        size, n_comp_total = agg[:, C].to(I32), dense[N - 1] + 1
    if return_runs:
        return comp2d, cls_lp, size, frozen, n_comp_total, runs
    return comp2d, cls_lp, size, frozen, n_comp_total


def _finalize_tables(cls_lp, size, frozen, M, do_prune, prune_threshold):
    """Optional prune into the biggest background component, plus the
    instance-root mask.  Returns (parent or None, root_class,
    is_instance_root)."""
    ids = _arange(M, cls_lp.device)
    root_class = torch.argmax(cls_lp, dim=1).to(I32)
    is_root = size > 0
    parent = None
    if do_prune:
        best_lp = cls_lp.max(dim=1).values
        advantage = best_lp - cls_lp[:, 0]
        bg_size = torch.where(is_root & (root_class == 0), size, -1)
        bg_root = torch.argmax(bg_size).to(I32)
        weak = is_root & (advantage < prune_threshold) & (ids != bg_root)
        parent = torch.where(weak, bg_root, ids)
        root_class = torch.where(weak, 0, root_class)
        is_root = is_root & ~weak
    return parent, root_class, is_root & (root_class != 0) & ~frozen


# ------------------------------------------------------------ pair dedup

def _block_dedup(key, oml, P, SENT, pair_slots, block, slots):
    """Per-block pre-aggregated pair dedup (the sorted fallback of the
    run dedup), with whole-pair drops past a row's `slots` unique
    pairs.  Returns (plo, phi, pair_oml, stats)."""
    dev = key.device
    E = key.shape[0]
    R = -(-E // block)
    pad = R * block - E
    if pad:
        key = torch.cat([key, torch.full((pad,), SENT, dtype=I32,
                                         device=dev)])
        oml = torch.cat([oml, torch.zeros((pad,), dtype=F32, device=dev)])
    k2, o2 = _sort(key.reshape(R, block), oml.reshape(R, block), dim=1)
    dead = k2 >= SENT
    ones = torch.ones((R, 1), dtype=torch.bool, device=dev)
    first = torch.cat([ones, k2[:, 1:] != k2[:, :-1]], 1)
    run_id = _cumsum_i32(first.to(I32), 1) - 1
    tot = _stable_cumsum_rows(torch.where(dead, 0.0, o2))
    last = torch.cat([first[:, 1:], ones], 1)
    sel = last & ~dead
    mindrop = torch.where(first & ~dead & (run_id >= slots), k2,
                          SENT).min()
    ordkey = torch.where(sel & (run_id < slots), run_id, slots).to(I32)
    ord_s, k_s, t_s = _sort(ordkey, k2, tot, dim=1)
    kept = ord_s[:, :slots] < slots
    t_sl = t_s[:, :slots]
    prev = torch.cat([torch.zeros((R, 1), dtype=F32, device=dev),
                      t_sl[:, :-1]], 1)
    pk = torch.where(kept, k_s[:, :slots], SENT).reshape(-1)
    pt = torch.where(kept, t_sl - prev, 0.0).reshape(-1)

    plo, phi, pair_oml, pairs_kept, pairs_cut = _dedup_global_finish(
        pk, pt, P, SENT, pair_slots, mindrop)

    n_ext = (~dead).sum(dtype=I32)
    edges_dropped = (~dead & (k2 >= mindrop)).sum(dtype=I32)
    rowdrop = (first & ~dead & (run_id >= slots)).sum(dtype=I32)
    pairs_dropped = (rowdrop + pairs_cut + torch.clamp_min(
        pairs_kept - (pair_slots - 1), 0)).to(I32)
    stats = {"n_ext": n_ext, "edges_dropped": edges_dropped,
             "pairs_total": pairs_kept + pairs_dropped,
             "pairs_dropped": pairs_dropped}
    return plo, phi, pair_oml, stats


def _dedup_global_finish(pk, pt, P, SENT, pair_slots, mindrop):
    """Global merge of per-row (pair key, partial oml sum) entries: one
    small sort, run-differenced running sum, compaction to `pair_slots`.
    Returns (plo, phi, pair_oml, pairs_kept, pairs_cut)."""
    dev = pk.device
    if pk.shape[0] < pair_slots:
        padn = pair_slots - pk.shape[0]
        pk = torch.cat([pk, torch.full((padn,), SENT, dtype=I32,
                                       device=dev)])
        pt = torch.cat([pt, torch.zeros((padn,), dtype=F32, device=dev)])
    gk, gt = _sort(pk, pt)
    gdead = gk >= mindrop
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    gfirst = torch.cat([one, gk[1:] != gk[:-1]])
    krun = _cumsum_i32((gfirst & ~gdead).to(I32)) - 1
    gtot = _stable_cumsum(torch.where(gdead, 0.0, gt))
    glast = torch.cat([gfirst[1:], one])
    gsel = glast & ~gdead & (krun < pair_slots - 1)
    gord = torch.where(gsel, krun, pair_slots - 1)
    os_, pk_s, tot_s = _sort(gord, gk, gtot)
    valid = os_[:pair_slots] < pair_slots - 1
    plo = torch.where(valid, torch.div(pk_s[:pair_slots], P,
                                       rounding_mode="floor"), -1)
    phi = torch.where(valid, pk_s[:pair_slots] % P, -1)
    ctot = tot_s[:pair_slots]
    pair_oml = torch.where(
        valid, ctot - torch.cat([torch.zeros((1,), dtype=F32, device=dev),
                                 ctot[:-1]]), 0.0)
    pairs_kept = (gfirst & ~gdead).sum(dtype=I32)
    pairs_cut = (gfirst & (gk < SENT) & gdead).sum(dtype=I32)
    return plo, phi, pair_oml, pairs_kept, pairs_cut


def _dedup_rows(keyT, omlT, H, SENT, block):
    """Row-blocked column-major edge layout: rows hold whole columns, so
    every run lies inside one row.  Returns (key, oml, first, dead),
    each (R, B)."""
    O, W, _ = keyT.shape
    dev = keyT.device
    B = H * max(1, int(block) // H)
    E = O * W * H
    R = -(-E // B)
    key = keyT.reshape(-1)
    oml = omlT.reshape(-1)
    pad = R * B - E
    if pad:
        key = torch.cat([key, torch.full((pad,), SENT, dtype=I32,
                                         device=dev)])
        oml = torch.cat([oml, torch.zeros((pad,), dtype=F32, device=dev)])
    key = key.reshape(R, B)
    oml = oml.reshape(R, B)
    col0 = (torch.arange(B, device=dev) % H) == 0
    first = col0[None, :] | torch.cat(
        [torch.ones((R, 1), dtype=torch.bool, device=dev),
         key[:, 1:] != key[:, :-1]], 1)
    return key, oml, first, key >= SENT


def _run_dedup(key, oml, first, dead, P, SENT, pair_slots, slots):
    """Run-granular pair dedup: in column-major order equal pair keys
    are contiguous, so per-run sums are row-cumsum differences at run
    ends, compacted by one sort per row.  Exact (drops nothing): the
    caller takes `_block_dedup` when a row has more than `slots` live
    runs."""
    R, B = key.shape
    dev = key.device
    livestart = first & ~dead
    rid = _cumsum_i32(livestart.to(I32), 1) - 1
    last = torch.cat([first[:, 1:], torch.ones((R, 1), dtype=torch.bool,
                                               device=dev)], 1)
    sel = last & ~dead
    tot = _stable_cumsum_rows(torch.where(dead, 0.0, oml))
    ordkey = torch.where(sel & (rid < slots), rid, slots).to(I32)
    ord_s, k_sf, t_sf = _sort(ordkey, key, tot, dim=1)
    kept = ord_s[:, :slots] < slots
    k_s = k_sf[:, :slots]
    t_sl = t_sf[:, :slots]
    prev = torch.cat([torch.zeros((R, 1), dtype=F32, device=dev),
                      t_sl[:, :-1]], 1)
    pk = torch.where(kept, k_s, SENT).reshape(-1)
    pt = torch.where(kept, t_sl - prev, 0.0).reshape(-1)

    plo, phi, pair_oml, pairs_kept, pairs_cut = _dedup_global_finish(
        pk, pt, P, SENT, pair_slots, SENT)
    clamp = torch.clamp_min(pairs_kept - (pair_slots - 1), 0)
    pairs_dropped = (pairs_cut + clamp).to(I32)
    stats = {"n_ext": (~dead).sum(dtype=I32),
             "edges_dropped": torch.zeros((), dtype=I32, device=dev),
             "pairs_total": pairs_kept + pairs_dropped,
             "pairs_dropped": pairs_dropped}
    return plo, phi, pair_oml, stats


def _pair_keys(lo, hi, ext, P, SENT, packed):
    """Pair keys lo * P + hi of the external edges, SENT elsewhere: int32
    when `packed`, else int64 — torch has no multi-key sort, and the
    stable sort of the int64 key is the reference's stable 2-key
    (lo, hi) sort, its sentinel (M2, M2) packing to SENT."""
    if not packed:
        lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    return torch.where(ext, lo * P + hi, SENT)


def _pair_phase(comp2d, cls_lp, size, frozen, log_odds, offsets, M2,
                pair_slots, pair_rounds, den_mode, omf, bias, packed=True,
                edge_slots=None, dedup_block=None, dedup_slots=64,
                froz2d=None, anneal_start=0.0, anneal_halvings=0):
    """Pair dedup + aggregated Boruvka rounds.  `packed` selects int32
    pair keys (requires (M2+1)^2-1 <= 2^31-1), else the reference's
    (lo, hi) 2-key sorts, here int64 keys.  With `dedup_block` (packed
    only): the column-major run dedup, or the sorted block dedup when a
    row has more than `dedup_slots` live runs.  Without it: one key sort
    over all edges that doubles as the stream compaction to
    `edge_slots`, dropping whole pairs past the cut.  Returns
    (total_map (M2,), cls_lp, size, stats)."""
    P = M2 + 1
    SENT = P * P - 1
    if froz2d is None:
        froz2d = frozen[comp2d]
    if not packed or dedup_block is None:
        plo, phi, pair_oml, stats = _mono_dedup(
            comp2d, froz2d, log_odds, offsets, P, SENT, pair_slots,
            edge_slots, packed)
        return _pair_rounds(plo, phi, pair_oml, stats, cls_lp, size,
                            frozen, M2, P, SENT, pair_slots, pair_rounds,
                            den_mode, omf, bias, anneal_start,
                            anneal_halvings, packed)
    compT = comp2d.t()
    frozT = froz2d.t()
    keys = []
    for di, dj in offsets:
        c2 = _shift2d(compT, dj, di, -1)
        f2 = _shift2d(frozT, dj, di, True)
        ext = (c2 >= 0) & (c2 != compT) & ~frozT & ~f2
        lo = torch.minimum(compT, c2)
        hi = torch.maximum(compT, c2)
        keys.append(torch.where(ext, lo * P + hi, SENT))
    keyT = torch.stack(keys)                 # (O, W, H)
    omlT = log_odds.transpose(1, 2)          # (O, W, H)
    H2 = comp2d.shape[0]
    keyr, omlr, firstr, deadr = _dedup_rows(keyT, omlT, H2, SENT,
                                            int(dedup_block))
    nlive = int((firstr & ~deadr).sum(dim=1, dtype=I32).max())
    if nlive <= int(dedup_slots):
        plo, phi, pair_oml, stats = _run_dedup(
            keyr, omlr, firstr, deadr, P, SENT, pair_slots,
            int(dedup_slots))
    else:
        plo, phi, pair_oml, stats = _block_dedup(
            keyT.reshape(-1), omlT.reshape(-1), P, SENT, pair_slots,
            int(dedup_block), int(dedup_slots))
    return _pair_rounds(plo, phi, pair_oml, stats, cls_lp, size, frozen,
                        M2, P, SENT, pair_slots, pair_rounds, den_mode, omf,
                        bias, anneal_start, anneal_halvings)


def _mono_dedup(comp2d, froz2d, log_odds, offsets, P, SENT, pair_slots,
                edge_slots, packed=True):
    """One sort of all (pixel, offset) edge keys: internal edges carry the
    sentinel and sort to the tail, so slicing to K = edge_slots keeps
    every external edge when they fit; a pair whose run straddles the
    cut is dropped whole.  Per-pair sums are run-end differences of a
    compensated running sum.  Keys are int32 when `packed`, else int64
    (`_pair_keys`).  Returns (plo, phi, pair_oml, stats)."""
    dev = comp2d.device
    keys = []
    for di, dj in offsets:
        c2 = _shift2d(comp2d, di, dj, -1)
        f2 = _shift2d(froz2d, di, dj, True)
        ext = (c2 >= 0) & (c2 != comp2d) & ~froz2d & ~f2
        lo = torch.minimum(comp2d, c2)
        hi = torch.maximum(comp2d, c2)
        keys.append(_pair_keys(lo, hi, ext, P, SENT, packed).reshape(-1))
    key = torch.cat(keys)
    oml = log_odds.reshape(-1)  # plane-major == the per-offset concat
    E_all = oml.shape[0]
    K = E_all if edge_slots is None else min(int(edge_slots), E_all)
    n_ext = (key < SENT).sum(dtype=I32)
    edges_dropped = torch.clamp_min(n_ext - K, 0)
    key_s, oml_s = _sort(key, oml)
    straddles = bool(key_s[K] == key_s[K - 1]) if K < E_all else False
    key_s, oml_s = key_s[:K], oml_s[:K]
    dead_s = key_s >= SENT
    cut = (key_s == key_s[-1]) & ~dead_s & straddles
    dead_s = dead_s | cut
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    first = torch.cat([one, key_s[1:] != key_s[:-1]])
    edges_dropped = edges_dropped + cut.sum(dtype=I32)
    # runs are detected WITHOUT masking the sentinel tail, which would
    # fold internal edges into the last real pair's run
    run_id = _cumsum_i32(first.to(I32)) - 1
    total = _stable_cumsum(torch.where(dead_s, 0.0, oml_s))
    last = torch.cat([first[1:], one])
    sel = last & ~dead_s & (run_id < pair_slots - 1)
    ordkey = torch.where(sel, run_id, pair_slots - 1)
    ord_s, pk_s, tot_s = _sort(ordkey, key_s, total)
    valid = ord_s[:pair_slots] < pair_slots - 1
    plo = torch.where(valid, torch.div(pk_s[:pair_slots], P,
                                       rounding_mode="floor"), -1).to(I32)
    phi = torch.where(valid, pk_s[:pair_slots] % P, -1).to(I32)
    ctot = tot_s[:pair_slots]
    pair_oml = torch.where(
        valid, ctot - torch.cat([torch.zeros((1,), dtype=F32, device=dev),
                                 ctot[:-1]]), 0.0)
    pairs_total = (first & ~dead_s).sum(dtype=I32)
    stats = {"n_ext": n_ext, "edges_dropped": edges_dropped.to(I32),
             "pairs_total": pairs_total,
             "pairs_dropped": torch.clamp_min(
                 pairs_total - (pair_slots - 1), 0).to(I32)}
    return plo, phi, pair_oml, stats


def _pair_rounds(plo, phi, pair_oml, stats, cls_lp, size, frozen, M2, P,
                 SENT, pair_slots, pair_rounds, den_mode, omf, bias,
                 anneal_start=0.0, anneal_halvings=0, packed=True):
    """Aggregated Boruvka rounds with up-size hooking over the unique
    pair arrays, until a round merges nothing (at most `pair_rounds`
    rounds; reaching the cap unconverged raises).  Pair keys are int32
    when `packed`, else int64 (the reference's 2-key sort)."""
    dev = plo.device
    ids2 = _arange(M2, dev)
    total_map = ids2
    poml = pair_oml
    r = 0
    while True:
        if r >= pair_rounds:
            raise RuntimeError(
                "_pair_rounds: no fixed point within pair_rounds=%d rounds"
                % pair_rounds)
        live = ((plo >= 0) & (plo != phi)
                & ~frozen[torch.clamp_min(plo, 0)]
                & ~frozen[torch.clamp_min(phi, 0)])
        k = _pair_keys(plo, phi, live, P, SENT, packed)
        k_s, o_s = _sort(k, poml)
        dead = k_s >= SENT
        lo_c = torch.clamp_max(torch.div(k_s, P, rounding_mode="floor"),
                               M2 - 1).to(I32)
        hi_c = torch.clamp_max(k_s % P, M2 - 1).to(I32)
        f_ = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                        k_s[1:] != k_s[:-1]])
        rid = _cumsum_i32(f_.to(I32)) - 1
        agg = _segment_sum(o_s, rid, pair_slots)[rid]
        best_lp = cls_lp.max(dim=1).values
        joint = cls_lp[lo_c] + cls_lp[hi_c]
        cdl = joint.max(dim=1).values - best_lp[lo_c] - best_lp[hi_c]
        n1 = size[lo_c].to(F32)
        n2 = size[hi_c].to(F32)
        if den_mode == "sum":
            pri = _fma32(agg, omf, cdl) / (n1 + n2) + bias
        else:
            pri = (_fma32(agg, omf, cdl) + bias) / (n1 * n2)
        pri = torch.where(dead, NEG_INF, pri)

        hi_up = (n2 > n1) | ((n2 == n1) & (hi_c > lo_c))
        pri_lo = torch.where(hi_up, pri, NEG_INF)
        pri_hi = torch.where(~hi_up, pri, NEG_INF)
        comp_best = torch.maximum(_segment_max(pri_lo, lo_c, M2),
                                  _segment_max(pri_hi, hi_c, M2))
        finite = torch.isfinite(comp_best)
        comp_best = torch.where(finite, comp_best, NEG_INF)
        if not anneal_halvings:
            tau = 0.0
        else:
            maxpri = float(torch.clamp_min(
                torch.where(finite, comp_best, 0.0).max(), 0.0))
            fixed = float(np.float32(anneal_start) * np.exp2(
                -np.float32(r)))
            tau = ((fixed if fixed <= maxpri else float(
                np.float32(0.5) * np.float32(maxpri)))
                if r < anneal_halvings else 0.0)
        elig_lo = (pri_lo == comp_best[lo_c]) & ~dead & hi_up
        elig_hi = (pri_hi == comp_best[hi_c]) & ~dead & ~hi_up
        partner = torch.maximum(
            _segment_max(torch.where(elig_lo, hi_c, -1), lo_c, M2),
            _segment_max(torch.where(elig_hi, lo_c, -1), hi_c, M2))
        parent = _contract(torch.where((comp_best >= tau) & (partner >= 0),
                                       torch.clamp_min(partner, 0), ids2))
        dying = parent != ids2
        cls_lp = _scatter_add(cls_lp, parent,
                              torch.where(dying[:, None], cls_lp, 0.0))
        cls_lp = torch.where(dying[:, None], 0.0, cls_lp)
        size = size + _segment_sum(torch.where(dying, size, 0), parent, M2)
        size = torch.where(dying, 0, size)
        nlo = parent[lo_c]
        nhi = parent[hi_c]
        nlo, nhi = torch.minimum(nlo, nhi), torch.maximum(nlo, nhi)
        plo = torch.where(dead, -1, nlo)
        phi = torch.where(dead, -1, nhi)
        poml = o_s
        total_map = parent[total_map]
        r += 1
        if not bool(dying.any()) and tau <= 0.0:
            break
    return total_map, cls_lp, size, stats


# ---------------------------------------------------------------- decode

def _maps(class_probs, sameness_probs, num_classes, offsets, device):
    """(H, W, C) / (H, W, O) maps as tensors on the resolved device, and
    the offsets as a tuple of int pairs; raises on a shape mismatch."""
    dev = resolve_device(device)
    class_probs = torch.as_tensor(class_probs, device=dev)
    sameness_probs = torch.as_tensor(sameness_probs, device=dev)
    if (class_probs.shape[-1] != num_classes
            or sameness_probs.shape[-1] != len(offsets)):
        raise ValueError("class/sameness maps do not match num_classes=%d "
                         "and %d offsets" % (num_classes, len(offsets)))
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    return class_probs, sameness_probs, offsets, dev


def decode_hierarchical(class_probs, sameness_probs, num_classes, offsets,
                        same_different_bias=0.0, object_merge_factor=1.0,
                        merge_logprob_bias=0.0, den_mode="sum",
                        ccl_sweeps=3, ccl_margin=2.0, absorb_thetas=(1.0,),
                        absorb_size_cap=64, max_components=65536,
                        pair_components=8192, pair_slots=16384,
                        pair_rounds=64, edge_slots=None, dedup_block=4096,
                        dedup_slots=256, do_prune=False,
                        prune_threshold=200.0, return_stats=False,
                        relabel=False, from_logits=False, device=None):
    """Single-frame hierarchical decode (same arguments, defaults and
    outputs as the reference's; see its docstring for the stages and
    the capacity-overflow policy).

    class_probs (H, W, C) / sameness_probs (H, W, O): probabilities, or
    raw logits with `from_logits=True`; numpy arrays or tensors, moved to
    `device` (None means CUDA).  Returns (comp (H, W) int32, root_class
    (M2,), is_instance_root (M2,)), or with `relabel=True` (mask (H, W)
    int32 instance ids 1..K, inst_class (M2,) int32); with
    `return_stats=True` a dict of int32 scalar tensors (n_ext,
    edges_dropped, pairs_total, pairs_dropped, n_frozen) follows."""
    class_probs, sameness_probs, offsets, dev = _maps(
        class_probs, sameness_probs, num_classes, offsets, device)
    H, W, C = class_probs.shape
    N = H * W
    M = min(max_components, N)
    M2 = min(pair_components, M)
    if (M2 + 1) * (M2 + 1) - 1 > 2 ** 31 - 1:
        raise ValueError("pair_components must be <= 46339 (int32 pair-key "
                         "packing)")
    omf = float(np.float32(object_merge_factor))
    bias = float(np.float32(merge_logprob_bias))
    cls_lp_pix, log_odds = _log_domain(class_probs, sameness_probs,
                                       same_different_bias,
                                       from_logits=from_logits)
    argmax_pix = torch.argmax(cls_lp_pix, dim=-1)

    # ---- stage 1: flood + densify to M ----
    label = _flood_fill(argmax_pix, log_odds, offsets, den_mode, omf, bias,
                        ccl_sweeps, ccl_margin)
    comp2d, cls_lp, size, frozen, n_comp_total, runs = _densify_stats(
        label, cls_lp_pix, M, return_runs=True)
    comp_c = runs[1]
    n_comp_total = int(n_comp_total)

    # ---- stage 2: absorption rounds on the grid ----
    ids = _arange(M, dev)
    small = min(SMALL, M)
    pack_stats = num_classes <= 16  # argcls in 4 bits, size < 2^26
    comp2d_s1 = comp2d
    tparent = None
    for theta in absorb_thetas:
        theta = float(np.float32(theta))
        comp_cur_c = comp_c if tparent is None else tparent[comp_c]
        if tparent is not None:
            comp2d = _run_apply(tparent, comp_c, comp2d_s1, runs)
        stats = absorb_stats(cls_lp, size, frozen, pack_stats)
        if pack_stats:
            packed_own = _run_apply(stats[0], comp_cur_c, comp2d_s1, runs)
            best_pri, best_partner = _absorb.absorb_best_edges(
                comp2d.contiguous(), packed_own.contiguous(), log_odds,
                offsets, theta, absorb_size_cap)
        else:
            best_pri, best_partner = _absorb.absorb_best_edges_unpacked(
                comp2d.contiguous(), *(t[comp2d].contiguous() for t in stats),
                log_odds, offsets, theta, absorb_size_cap)
        bp = best_pri.reshape(-1)
        own_f = comp2d.reshape(-1)
        partner_f = best_partner.reshape(-1)
        # one segment max of (quantized pri, partner + 1) packed in int32
        partner_bits = max(1, int(np.ceil(np.log2(M + 2))))
        q_levels = (1 << (31 - partner_bits)) - 1
        if q_levels >= 255:
            q = torch.clamp((bp - theta) * float(np.float32(q_levels / 16.0)),
                            0, q_levels - 1).to(I32) + 1
            packed_edge = torch.where((bp >= theta) & (partner_f >= 0),
                                      (q << partner_bits) | (partner_f + 1),
                                      0)
            best_packed = _run_segment_max(packed_edge.reshape(H, W),
                                           comp2d, comp_cur_c, runs, M)
            hook = best_packed > 0
            partner = (best_packed & ((1 << partner_bits) - 1)) - 1
        else:
            comp_best = _segment_max(bp, own_f, M)
            elig = bp == comp_best[own_f]
            partner = _segment_max(torch.where(elig, partner_f, -1), own_f,
                                   M)
            hook = (comp_best >= theta) & (partner >= 0)
        parent = _contract_prefix(
            torch.where(hook, torch.clamp_min(partner, 0), ids),
            n_comp_total, small=small)

        def merge_tables(cls_lp_s, size_s, parent_s):
            m = parent_s.shape[0]
            dying = parent_s != _arange(m, dev)
            c = _scatter_add(cls_lp_s, parent_s,
                             torch.where(dying[:, None], cls_lp_s, 0.0))
            c = torch.where(dying[:, None], 0.0, c)
            s = size_s + _segment_sum(torch.where(dying, size_s, 0),
                                      parent_s, m)
            return c, torch.where(dying, 0, s)

        if small < M and n_comp_total <= small:
            c, s = merge_tables(cls_lp[:small], size[:small],
                                parent[:small])
            cls_lp, size = cls_lp.clone(), size.clone()
            cls_lp[:small], size[:small] = c, s
        else:
            cls_lp, size = merge_tables(cls_lp, size, parent)
        tparent = parent if tparent is None else parent[tparent]

    # ---- stage 3: re-densify to M2 + pair dedup ----
    live = size > 0
    dense2 = _cumsum_i32(live.to(I32)) - 1
    over2 = live & (dense2 >= M2)
    map2 = torch.where(live, torch.clamp_max(dense2, M2 - 1), 0)

    def redensify(cls_lp_s, size_s, frz_s, map2_s, over2_s, live_s):
        sel_s = live_s.to(I32)
        c = _segment_sum(cls_lp_s * sel_s[:, None], map2_s, M2)
        s = _segment_sum(size_s * sel_s, map2_s, M2)
        f = _segment_max(((frz_s | over2_s) & live_s).to(I32), map2_s,
                         M2) > 0
        return c, s, f

    tabs = (cls_lp, size, frozen, map2, over2, live)
    if small < M and n_comp_total <= small:
        tabs = tuple(x[:small] for x in tabs)
    cls_lp, size, frozen = redensify(*tabs)
    # one fused run-granular apply: dedup id + frozen flag (bit 16)
    tcur_c = comp_c if tparent is None else tparent[comp_c]
    t_c = map2[tcur_c]
    t_c = t_c | (frozen[t_c].to(I32) << 16)

    def t_full():
        t = map2 if tparent is None else map2[tparent]
        return t | (frozen[t].to(I32) << 16)

    tp = _run_apply(None, comp_c, comp2d_s1, runs, vals_c=t_c,
                    table_fn=t_full)
    comp2d = tp & ((1 << 16) - 1)
    froz2d = tp >= (1 << 16)

    total_map, cls_lp, size, stats = _pair_phase(
        comp2d, cls_lp, size, frozen, log_odds, offsets, M2, pair_slots,
        pair_rounds, den_mode, omf, bias, edge_slots=edge_slots,
        dedup_block=None if edge_slots is not None else dedup_block,
        dedup_slots=dedup_slots, froz2d=froz2d)

    parent, root_class, is_inst = _finalize_tables(
        cls_lp, size, frozen, M2, do_prune, prune_threshold)
    tm = total_map if parent is None else parent[total_map]
    t16_c = t_c & ((1 << 16) - 1)
    if relabel:
        idtab, inst_class = _instance_tables(root_class, is_inst)
        mask = _run_apply(
            None, comp_c, comp2d_s1, runs, vals_c=idtab[tm[t16_c]],
            table_fn=lambda: idtab[tm][t_full() & ((1 << 16) - 1)])
        out = (mask, inst_class)
    else:
        comp = _run_apply(None, comp_c, comp2d_s1, runs, vals_c=tm[t16_c],
                          table_fn=lambda: tm[t_full() & ((1 << 16) - 1)])
        out = (comp, root_class, is_inst)
    if return_stats:
        stats = dict(stats, n_frozen=frozen.sum(dtype=I32))
        return out + (stats,)
    return out


# ------------------------------------------------------------ exact mode

def boruvka_rolls_round(class_probs, sameness_probs, num_classes, offsets,
                        same_different_bias=0.0, object_merge_factor=1.0,
                        merge_logprob_bias=0.0, den_mode="sum",
                        hook_threshold=0.0, device=None):
    """The first aggregated-Boruvka round on singleton components, from
    per-offset priority planes alone: each pixel hooks to its best
    partner with priority >= `hook_threshold` (ties to the larger
    partner id), 2-cycles resolve to the smaller id, and pointer jumping
    contracts the forest.  Returns (label (H, W) int32 self-rooted root
    pixel ids, n_comp () int32, n_ext () int32 edges between different
    components)."""
    class_probs, sameness_probs, offsets, dev = _maps(
        class_probs, sameness_probs, num_classes, offsets, device)
    H, W = class_probs.shape[:2]
    N = H * W
    omf = float(np.float32(object_merge_factor))
    bias = float(np.float32(merge_logprob_bias))
    cls_lp_pix, log_odds = _log_domain(class_probs, sameness_probs,
                                       same_different_bias)
    best_pix = cls_lp_pix.max(dim=-1).values
    pix_id = _arange(N, dev).reshape(H, W)
    best_pri = torch.full((H, W), NEG_INF, dtype=F32, device=dev)
    best_partner = torch.full((H, W), -1, dtype=I32, device=dev)

    def consider(pri, partner):
        nonlocal best_pri, best_partner
        take = (pri > best_pri) | ((pri == best_pri)
                                   & (partner > best_partner))
        best_pri = torch.where(take, pri, best_pri)
        best_partner = torch.where(take, partner, best_partner)

    for oi, (di, dj) in enumerate(offsets):
        oml = log_odds[oi]
        joint = (cls_lp_pix + _shift2d(cls_lp_pix, di, dj, 0.0)).max(
            dim=-1).values
        cdl = joint - best_pix - _shift2d(best_pix, di, dj, 0.0)
        if den_mode == "sum":
            pri = _fma32(oml, omf, cdl) / 2.0 + bias
        else:
            pri = _fma32(oml, omf, cdl) + bias
        partner_fwd = _shift2d(pix_id, di, dj, -1)
        consider(torch.where(partner_fwd >= 0, pri, NEG_INF), partner_fwd)
        pri_bwd = _shift2d(pri, -di, -dj, NEG_INF)
        partner_bwd = _shift2d(pix_id, -di, -dj, -1)
        consider(torch.where(partner_bwd >= 0, pri_bwd, NEG_INF),
                 partner_bwd)

    hook = best_pri >= float(np.float32(hook_threshold))
    parent = _contract(torch.where(hook, best_partner, pix_id).reshape(-1))
    label = parent.reshape(H, W)
    n_comp = (parent == _arange(N, dev)).sum(dtype=I32)
    n_ext = torch.zeros((), dtype=I32, device=dev)
    for di, dj in offsets:
        other = _shift2d(label, di, dj, -1)
        n_ext = n_ext + ((other >= 0) & (other != label)).sum(dtype=I32)
    return label, n_comp, n_ext


def _count_unique_pairs(label2d, offsets):
    """Number of distinct component pairs linked by any (pixel, offset)
    edge of a root-pixel-id label grid; sizes the exact finisher's
    `pair_slots`.  The reference's 2-key sort with its 2**30 sentinel,
    as one int64 key (lo << 31 | hi)."""
    SENT = 2 ** 30
    keys = []
    for di, dj in offsets:
        other = _shift2d(label2d, di, dj, -1)
        ext = (other >= 0) & (other != label2d)
        lo = torch.where(ext, torch.minimum(label2d, other), SENT)
        hi = torch.where(ext, torch.maximum(label2d, other), SENT)
        keys.append(((lo.to(torch.int64) << 31) | hi).reshape(-1))
    key_s = torch.sort(torch.cat(keys)).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool,
                                  device=key_s.device),
                       key_s[1:] != key_s[:-1]])
    return (first & (key_s < (SENT << 31))).sum(dtype=I32)


def _finalize_components(comp, cls_lp, size, frozen, M, do_prune,
                         prune_threshold):
    """`_finalize_tables` plus the per-pixel prune apply, for decode
    paths that hold a pixel-level component plane."""
    parent, root_class, is_instance_root = _finalize_tables(
        cls_lp, size, frozen, M, do_prune, prune_threshold)
    if parent is not None:
        comp = parent[comp.reshape(-1)].reshape(comp.shape)
    return comp, root_class, is_instance_root


def _instance_tables(root_class, is_instance_root):
    """(ids (M,) int32: component -> instance id 1..K, 0 elsewhere;
    inst_class (M,) int32: class of instance k at k-1, padded with -1)."""
    M = root_class.shape[0]
    inst_id = _cumsum_i32(is_instance_root.to(I32))
    ids = torch.where(is_instance_root, inst_id, 0).to(I32)
    k = torch.where(is_instance_root, inst_id - 1, M - 1)
    inst_class = torch.full((M,), -1, dtype=I32, device=root_class.device)
    # scatter-max: non-instance slots write -1 into k = M-1, which must
    # not clobber a real instance there (instance classes are >= 1)
    inst_class.scatter_reduce_(
        0, k.long(), torch.where(is_instance_root, root_class.to(I32), -1),
        "amax", include_self=True)
    return ids, inst_class


def relabel_mask(label, root_class, is_instance_root):
    """Compact component ids into instance ids 1..K (0 = background).
    label (H, W) int32 indexes root_class (M,).  Returns (mask (H, W)
    int32, inst_class (M,) int32 with inst_class[k-1] the class of
    instance k, padded with -1).  The per-pixel lookup is the tgather
    kernel on CUDA."""
    ids, inst_class = _instance_tables(root_class, is_instance_root)
    mask = _tgather_op.table_gather(
        ids.contiguous(), label.reshape(-1).to(I32).contiguous())
    return mask.reshape(label.shape), inst_class


def _edge_sort(ext, elo, ehi, M, K):
    """Phase 2 of `decode_on_device`: order the (pixel, offset) edges so
    the first K hold the external ones, pair-contiguous when capped.
    Returns (kept edge indices (K,) int64, e_live (K,) bool).  Uncapped:
    a stable flag sort.  Capped: a stable sort of the pair key (int32
    when (M+1)^2-1 fits, else int64 for the reference's 2-key sort),
    dropping whole the pair that straddles the cut at K."""
    E_all = ext.shape[0]
    eidx = torch.arange(E_all, device=ext.device)
    if K == E_all:
        flag_s, kept = _sort(torch.where(ext, 0, 1).to(I32), eidx)
        return kept, flag_s == 0
    P = M + 1
    SENT = P * P - 1
    ekey = _pair_keys(elo, ehi, ext, P, SENT, SENT <= 2 ** 31 - 1)
    ekey_s, kept = _sort(ekey, eidx)
    straddles = bool(ekey_s[K] == ekey_s[K - 1]) if K < E_all else False
    ekey_s, kept = ekey_s[:K], kept[:K]
    e_live = ekey_s < SENT
    if straddles:
        e_live = e_live & (ekey_s != ekey_s[-1])
    return kept, e_live


def decode_on_device(class_probs, sameness_probs, num_classes, offsets,
                     same_different_bias=0.0, object_merge_factor=1.0,
                     merge_logprob_bias=0.0, den_mode="sum",
                     do_prune=False, prune_threshold=200.0,
                     max_rounds=64, max_components=None, max_edges=None,
                     ccl_sweeps=0, ccl_margin=0.0, anneal_start=32.0,
                     anneal_halvings=0, initial_labels=None,
                     stop_at_max_rounds=False, device=None):
    """Decode one image with aggregated Boruvka rounds over all
    (pixel, offset) edges (same arguments, defaults and outputs as the
    reference's; see its docstring).  Phase 1: `initial_labels` or the
    flood fill (off by default); phase 2: edge compaction, capped at
    `max_edges` with whole-pair drops; phase 3: rounds with the annealed
    threshold until one merges nothing.  Reaching `max_rounds` without
    that raises, unless `stop_at_max_rounds` asks for the reference's
    plain stop (the staged decode's first pass runs a fixed budget of
    rounds by design).  Returns (comp (H, W) int32 in [0, M), root_class
    (M,), is_instance_root (M,)); the final per-pixel lookup is the
    tgather kernel on CUDA."""
    class_probs, sameness_probs, offsets, dev = _maps(
        class_probs, sameness_probs, num_classes, offsets, device)
    H, W, C = class_probs.shape
    N = H * W
    M = N if max_components is None else min(max_components, N)
    omf = float(np.float32(object_merge_factor))
    bias = float(np.float32(merge_logprob_bias))
    cls_lp_pix, log_odds = _log_domain(class_probs, sameness_probs,
                                       same_different_bias)

    # ---- phase 1: flood fill or the given labels ----
    if initial_labels is not None:
        label = torch.as_tensor(initial_labels, device=dev).to(I32)
    else:
        argmax_pix = torch.argmax(cls_lp_pix, dim=-1)
        label = _flood_fill(argmax_pix, log_odds, offsets, den_mode, omf,
                            bias, ccl_sweeps, ccl_margin)
    comp2d, cls_lp, size, frozen, _ = _densify_stats(label, cls_lp_pix, M)

    # ---- phase 2: edge compaction ----
    rows = torch.arange(H, device=dev)[:, None]
    cols = torch.arange(W, device=dev)[None, :]
    ea_l, eb_l, ext_l = [], [], []
    for di, dj in offsets:
        b2 = torch.roll(comp2d, (-di, -dj), (0, 1))
        valid = ((rows + di >= 0) & (rows + di < H)
                 & (cols + dj >= 0) & (cols + dj < W))
        ea_l.append(comp2d.reshape(-1))
        eb_l.append(b2.reshape(-1))
        ext_l.append((valid & (comp2d != b2)).reshape(-1))
    ea = torch.cat(ea_l)
    eb = torch.cat(eb_l)
    ext = torch.cat(ext_l)
    E_all = ea.shape[0]
    K = E_all if max_edges is None else min(int(max_edges), E_all)
    kept, e_live = _edge_sort(ext, torch.minimum(ea, eb),
                              torch.maximum(ea, eb), M, K)
    ea, eb, eo = ea[kept], eb[kept], log_odds.reshape(-1)[kept]

    # ---- phase 3: Boruvka rounds ----
    P = M + 1
    SENT = P * P - 1
    packed = SENT <= 2 ** 31 - 1
    comp_ids = _arange(M, dev)
    total_map = comp_ids
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    rounds = 0
    while True:
        if rounds >= max_rounds:
            if stop_at_max_rounds:
                break
            raise RuntimeError(
                "decode_on_device: no fixed point within max_rounds=%d "
                "rounds" % max_rounds)
        best_lp = cls_lp.max(dim=1).values
        tau = (float(np.float32(anneal_start)
                     * np.exp2(-np.float32(rounds)))
               if rounds < anneal_halvings else 0.0)
        lo = torch.minimum(ea, eb)
        hi = torch.maximum(ea, eb)
        live = e_live & (lo != hi) & ~frozen[lo] & ~frozen[hi]
        key_s, oml_s = _sort(_pair_keys(lo, hi, live, P, SENT, packed), eo)
        lo_s = torch.div(key_s, P, rounding_mode="floor").to(I32)
        hi_s = (key_s % P).to(I32)
        first = torch.cat([one, key_s[1:] != key_s[:-1]])
        run_id = _cumsum_i32(first.to(I32)) - 1
        pair_oml = _segment_sum(oml_s, run_id, K)[run_id]

        lo_c = torch.clamp_max(lo_s, M - 1)
        hi_c = torch.clamp_max(hi_s, M - 1)
        joint = cls_lp[lo_c] + cls_lp[hi_c]
        cdl = joint.max(dim=1).values - best_lp[lo_c] - best_lp[hi_c]
        n1 = size[lo_c].to(F32)
        n2 = size[hi_c].to(F32)
        if den_mode == "sum":
            pri = _fma32(pair_oml, omf, cdl) / (n1 + n2) + bias
        else:
            pri = (_fma32(pair_oml, omf, cdl) + bias) / (n1 * n2)
        dead = lo_s >= M
        pri = torch.where(dead, NEG_INF, pri)

        comp_best = torch.maximum(_segment_max(pri, lo_c, M),
                                  _segment_max(pri, hi_c, M))
        comp_best = torch.where(torch.isfinite(comp_best), comp_best,
                                NEG_INF)
        elig_lo = (pri == comp_best[lo_c]) & ~dead
        elig_hi = (pri == comp_best[hi_c]) & ~dead
        partner = torch.maximum(
            _segment_max(torch.where(elig_lo, hi_c, -1), lo_c, M),
            _segment_max(torch.where(elig_hi, lo_c, -1), hi_c, M))
        parent = _contract(torch.where((comp_best >= tau) & (partner >= 0),
                                       torch.clamp_min(partner, 0),
                                       comp_ids))
        dying = parent != comp_ids
        cls_lp = _scatter_add(cls_lp, parent,
                              torch.where(dying[:, None], cls_lp, 0.0))
        size = size + _segment_sum(torch.where(dying, size, 0), parent, M)
        cls_lp = torch.where(dying[:, None], 0.0, cls_lp)
        size = torch.where(dying, 0, size)
        ea = parent[ea]
        eb = parent[eb]
        total_map = parent[total_map]
        rounds += 1
        if not bool(dying.any()) and tau <= 0.0:
            break

    comp = _tgather_op.table_gather(
        total_map.contiguous(), comp2d.reshape(-1).contiguous()
    ).reshape(H, W)
    return _finalize_components(comp, cls_lp, size, frozen, M, do_prune,
                                prune_threshold)


def _pair_exact_finish(class_probs, sameness_probs, num_classes, offsets,
                       initial_labels, same_different_bias=0.0,
                       object_merge_factor=1.0, merge_logprob_bias=0.0,
                       den_mode="sum", max_components=65536,
                       pair_slots=262144, pair_rounds=64, edge_slots=None,
                       do_prune=False, prune_threshold=200.0,
                       anneal_start=0.0, anneal_halvings=0, device=None):
    """Exact finisher of `run_segmentation_device`: aggregated Boruvka
    pair rounds from `initial_labels` (self-rooted root pixel ids), with
    capacities the caller sized from measured counts.  Int32 pair keys
    when the component space allows, else int64 (the 2-key form).
    Returns (comp (H, W), root_class (M2,), is_instance_root (M2,))."""
    class_probs, sameness_probs, offsets, dev = _maps(
        class_probs, sameness_probs, num_classes, offsets, device)
    H, W, C = class_probs.shape
    M2 = min(max_components, H * W)
    omf = float(np.float32(object_merge_factor))
    bias = float(np.float32(merge_logprob_bias))
    cls_lp_pix, log_odds = _log_domain(class_probs, sameness_probs,
                                       same_different_bias)
    label = torch.as_tensor(initial_labels, device=dev).to(I32)
    comp2d, cls_lp, size, frozen, _ = _densify_stats(label, cls_lp_pix, M2)
    packed = (M2 + 1) * (M2 + 1) - 1 <= 2 ** 31 - 1
    total_map, cls_lp, size, _ = _pair_phase(
        comp2d, cls_lp, size, frozen, log_odds, offsets, M2, pair_slots,
        pair_rounds, den_mode, omf, bias, packed=packed,
        edge_slots=edge_slots, anneal_start=anneal_start,
        anneal_halvings=anneal_halvings)
    comp = total_map[comp2d.reshape(-1)].reshape(H, W)
    return _finalize_components(comp, cls_lp, size, frozen, M2, do_prune,
                                prune_threshold)


def decode_on_device_staged(class_probs, sameness_probs, num_classes,
                            offsets, stage1_rounds=4, stage2_components=8,
                            stage2_edges=2, device=None, **kw):
    """Exact decode in three stages: the rolls-only first round, a few
    uncapped aggregated rounds (`stage1_rounds`, a budget, not a
    convergence cap), then a capped pass with capacities
    N // stage2_components and N // stage2_edges.  Returns what
    `decode_on_device` returns."""
    class_probs, sameness_probs, offsets, dev = _maps(
        class_probs, sameness_probs, num_classes, offsets, device)
    H, W = class_probs.shape[:2]
    N = H * W
    for name in ("initial_labels", "max_components", "max_edges"):
        kw.pop(name, None)
    kw1 = {k: kw[k] for k in ("same_different_bias", "object_merge_factor",
                              "merge_logprob_bias", "den_mode") if k in kw}
    lab1, _, _ = boruvka_rolls_round(class_probs, sameness_probs,
                                     num_classes, offsets, device=dev, **kw1)
    lab2, _, _ = decode_on_device(
        class_probs, sameness_probs, num_classes, offsets,
        initial_labels=lab1, max_rounds=stage1_rounds,
        stop_at_max_rounds=True, device=dev, **kw1)
    # decode_on_device returns dense component ids; re-anchor them to
    # self-rooted pixel ids (each component's smallest pixel)
    flat2 = lab2.reshape(-1).long()
    rep_pixel = torch.full((N,), 2 ** 31 - 1, dtype=I32, device=dev)
    rep_pixel.scatter_reduce_(0, flat2, _arange(N, dev), "amin",
                              include_self=True)
    lab2 = rep_pixel[flat2].reshape(H, W)
    return decode_on_device(
        class_probs, sameness_probs, num_classes, offsets,
        initial_labels=lab2, max_components=max(4096, N // stage2_components),
        max_edges=max(16384, N // stage2_edges), device=dev, **kw)


def decode_on_device_batch(class_probs, sameness_probs, num_classes,
                           offsets, device=None, **kw):
    """Batched decode (B, H, W, C) / (B, H, W, O) -> (masks (B, H, W),
    inst_classes (B, M)): each image decoded on its own (the staged
    exact decode, or `decode_on_device` when capacities are given), then
    relabelled."""
    dev = resolve_device(device)
    class_probs = torch.as_tensor(class_probs, device=dev)
    sameness_probs = torch.as_tensor(sameness_probs, device=dev)
    masks, classes = [], []
    for c, s in zip(class_probs, sameness_probs):
        if kw.get("max_components") is None and kw.get("max_edges") is None:
            out = decode_on_device_staged(
                c, s, num_classes, offsets, device=dev,
                **{k: v for k, v in kw.items()
                   if k not in ("max_components", "max_edges")})
        else:
            out = decode_on_device(c, s, num_classes, offsets, device=dev,
                                   **kw)
        mask, inst_class = relabel_mask(*out)
        masks.append(mask)
        classes.append(inst_class)
    return torch.stack(masks), torch.stack(classes)


def _bucket(n, floor):
    """Next power of two >= max(n, floor): capacities from measured
    counts (bucketing bounds the reference's compilations)."""
    n = max(int(n), floor, 1)
    return 1 << int(np.ceil(np.log2(n)))


def run_segmentation_device(class_probs, sameness_probs, num_classes,
                            offsets, same_different_bias=0.0,
                            object_merge_factor=1.0, merge_logprob_bias=0.0,
                            den_mode="sum", do_prune=False,
                            prune_threshold=200.0, max_rounds=48,
                            max_components=None, max_edges=None,
                            mode="exact", return_stats=False,
                            anneal_start=8.0, anneal_halvings=8,
                            device=None):
    """Host-friendly decode with the reference's signature: channel-first
    (C, H, W) / (O, H, W) maps (numpy or tensors) in, (mask (H, W) numpy
    int32, classes list[, stats dict of ints]) out.

    mode='exact' (default): the rolls round, then annealed aggregated
    pair rounds with capacities bucketed from the measured component,
    pair and edge counts (read on the host: nothing can overflow).
    mode='hier': `decode_hierarchical`'s serving configuration (caps are
    a ValueError there).  Passing max_components / max_edges otherwise
    selects the capped single-pass `decode_on_device`."""
    dev = resolve_device(device)
    cp = torch.as_tensor(class_probs, device=dev).movedim(0, -1)
    sp = torch.as_tensor(sameness_probs, device=dev).movedim(0, -1)
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    hyper = dict(same_different_bias=same_different_bias,
                 object_merge_factor=object_merge_factor,
                 merge_logprob_bias=merge_logprob_bias, den_mode=den_mode)
    stats = None
    if mode == "hier":
        if max_components is not None or max_edges is not None:
            raise ValueError(
                "mode='hier' runs decode_hierarchical's static serving "
                "configuration and would ignore max_components/"
                "max_edges; drop the caps, or drop mode='hier' to select "
                "the capped single-pass decode_on_device")
        label, root_class, is_inst, stats = decode_hierarchical(
            cp, sp, num_classes, offsets, do_prune=do_prune,
            prune_threshold=prune_threshold, return_stats=True, device=dev,
            **hyper)
    elif max_components is not None or max_edges is not None:
        label, root_class, is_inst = decode_on_device(
            cp, sp, num_classes, offsets, max_components=max_components,
            max_edges=max_edges, do_prune=do_prune,
            prune_threshold=prune_threshold, max_rounds=max_rounds,
            device=dev, **hyper)
    else:
        label, n_comp, n_ext = boruvka_rolls_round(
            cp, sp, num_classes, offsets, device=dev, **hyper)
        n_pairs = int(_count_unique_pairs(label, offsets))
        label, root_class, is_inst = _pair_exact_finish(
            cp, sp, num_classes, offsets, initial_labels=label,
            max_components=_bucket(int(n_comp), 4096),
            pair_slots=_bucket(n_pairs + 2, 16384),
            edge_slots=_bucket(int(n_ext) + 1, 16384),
            pair_rounds=max_rounds, do_prune=do_prune,
            prune_threshold=prune_threshold,
            anneal_start=float(anneal_start),
            anneal_halvings=int(anneal_halvings), device=dev, **hyper)
        stats = {"n_ext": int(n_ext), "edges_dropped": 0,
                 "pairs_total": n_pairs, "pairs_dropped": 0, "n_frozen": 0}
    mask, inst_class = relabel_mask(label, root_class, is_inst)
    inst_class = inst_class.cpu().numpy()
    classes = []
    for v in inst_class:
        if v == -1:
            break
        classes.append(int(v))
    mask = mask.cpu().numpy()
    if return_stats:
        return mask, classes, {k: int(v) for k, v in (stats or {}).items()}
    return mask, classes
