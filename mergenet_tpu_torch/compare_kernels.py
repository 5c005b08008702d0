"""Old against new on one card: the floodscan, pgather, absorb and
tgather kernels of another `csrc/` tree timed beside this tree's, in one
process.

    git archive <commit> mergenet_tpu_torch/csrc | tar -x -C <dir>
    python -m mergenet_tpu_torch.compare_kernels <dir>/mergenet_tpu_torch/csrc

Builds the other tree's `*.cu` with this package's flags into `_build/`
(both trees must share the C interface of `mn_flood_scan`, `mn_pgather`,
`mn_absorb_best_edges` and `mn_table_gather`), checks both libraries'
kernels bit-equal to the plain versions, then times each in turns
(other, this, this, other; the median of the two turns is reported) by
CUDA-graph replay (device ms), by 200 back-to-back eager calls (ms per
call: the larger of the host's and the card's time per call) and by
the host's wall time per call issued without a sync (host us: the
launch work alone) at the served shapes, on fixture 0
of `tests/fixtures/certification512` (512x1024, C=9, O=10):

- floodscan on the served flood links (s=2, t=1, ccl=3);
- pgather at N=524288 for M=8192 and 65536 (the gather bench's data);
- absorb on the served stage-2 inputs (theta 1.0, cap 64) with all ten
  offsets, and with the seven short and the three long ones alone;
- tgather at N=524288 on random indices (M=65536 and 524288, as
  `chip_smoke.py` draws them) and on the decoder's own: the run-budget
  overflow branch's (`comp2d_s1` into the packed stats, M=65536) and
  `relabel_mask`'s (the final component grid into the instance ids).

These rows call each library's C entry directly on preallocated
outputs, so both trees pay the same host work.  Then, this tree only:
the port's wrappers as the decoder calls them (absorb on packed and on
unpacked stats, tgather on the overflow indices), and the launch floor
of tgather's grid from `probes/launch_floor.cu`: an empty kernel, and
an int4 copy of the indices (what the gather costs without its table
reads).  Each row also gives, from torch.profiler over 20 calls, every
kernel's launches per call and mean device time, so that the graph
time splits into kernel time and the gaps between launches.
Prints one JSON line per row, then the card.  Needs a CUDA device."""

import argparse
import collections
import ctypes
import glob
import json
import os
import statistics
import time

import numpy as np
import torch

from . import io
from .decoder import device as D
from .ops import _build, absorb, floodscan, pgather, tgather
from .timing import card, eager_ms, graph_ms

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(os.path.dirname(HERE), "tests", "fixtures",
                   "certification512")
FLOOR_SRC = os.path.join(HERE, "probes", "launch_floor.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
N = 512 * 1024

def _bind(path):
    """The library at `path` with its kernel entry points typed."""
    lib = ctypes.CDLL(path)
    lib.mn_flood_scan.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.mn_pgather.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.mn_table_gather.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.mn_absorb_best_edges.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P,
                                         _I, _F, _I, _P]
    return lib


def _compile(srcs, tag):
    """`srcs` built with this package's flags into a library of its own
    under `_build/`."""
    return _build.compile_library(srcs, os.path.join(
        _build.BUILD_DIR, "lib%s_%d.so" % (tag, os.getpid())))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _ok(err, name):
    if err:
        raise RuntimeError("%s: CUDA error %d" % (name, err))


def _flood(lib, out, h, v, s, t, ccl):
    _ok(lib.mn_flood_scan(out.data_ptr(), h.data_ptr(), v.data_ptr(),
                          h.shape[0], h.shape[1], s, t, ccl, _stream()),
        "mn_flood_scan")
    return out


def _gather(entry, out, table, idx):
    _ok(entry(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
              idx.numel(), table.numel(), _stream()), "gather")
    return out


def _absorb(lib, outs, comp, packed, lo, offsets):
    H, W = comp.shape
    offs = (ctypes.c_int * max(1, 2 * len(offsets)))(
        *[int(v) for o in offsets for v in o])
    _ok(lib.mn_absorb_best_edges(
        comp.data_ptr(), packed.data_ptr(), lo.data_ptr(),
        outs[0].data_ptr(), outs[1].data_ptr(), H, W,
        ctypes.cast(offs, ctypes.c_void_p), len(offsets), 1.0, 64,
        _stream()), "mn_absorb_best_edges")
    return outs


def host_us(fn, calls=100, reps=5):
    """Host us per call: the wall time of `calls` calls issued without a
    sync (fewer than the launch queue holds, so the host never waits on
    the card), median of `reps`."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) * 1e6 / calls)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_times(fn, calls=20):
    """{kernel name: (launches per call, mean device us)} over `calls`
    calls under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = collections.defaultdict(list)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by[ev.name].append(ev.time_range.elapsed_us())
    return {name[:80]: (len(v) / calls, sum(v) / len(v))
            for name, v in by.items()}


def served_inputs(dev):
    """Fixture 0's served-decode kernel inputs at 512x1024: the flood
    links (h_S, s, v_S, t), stage 2's absorb inputs (comp2d, packed_own,
    clsfz_own, size_own, log_odds, offsets), the run-budget overflow
    branch's gather (packed table, comp2d_s1) and relabel_mask's
    (instance-id table, final component grid)."""
    offsets = io.load_offsets(FIX)
    cp, sp = io.load_probs(FIX, 0)
    cp_d, sp_d = torch.from_numpy(cp).to(dev), torch.from_numpy(sp).to(dev)
    cls_lp_pix, log_odds = D._log_domain(cp_d, sp_d, 0.0)
    argmax_pix = torch.argmax(cls_lp_pix, dim=-1)
    omf, bias = float(np.float32(1.0)), float(np.float32(0.03))
    h, v = D._flood_links(argmax_pix, log_odds, offsets, "sum", omf, bias,
                          2.0)
    label = D._flood_fill(argmax_pix, log_odds, offsets, "sum", omf, bias,
                          3, 2.0)
    comp2d, cls_lp, size, frozen, _, runs = D._densify_stats(
        label, cls_lp_pix, 65536, return_runs=True)
    packed, = D.absorb_stats(cls_lp, size, frozen, True)
    clsfz, size = D.absorb_stats(cls_lp, size, frozen, False)
    comp2d = comp2d.contiguous()
    comp, root_class, is_root = D.decode_hierarchical(
        cp_d, sp_d, cp.shape[-1], offsets, object_merge_factor=1.0,
        merge_logprob_bias=0.03, device=dev)
    ids, _ = D._instance_tables(root_class, is_root)
    return dict(
        links=(h[0].contiguous(), h[1], v[0].contiguous(), v[1]),
        absorb=(comp2d, packed[comp2d].contiguous(),
                clsfz[comp2d].contiguous(), size[comp2d].contiguous(),
                log_odds, offsets),
        overflow_gather=(packed.contiguous(), comp2d.reshape(-1)),
        relabel_gather=(ids.contiguous(),
                        comp.reshape(-1).to(torch.int32).contiguous()))


def _cases(libs, dev):
    """(kernel, shape, reference, {tree: fn}) per row."""
    inp = served_inputs(dev)
    cases = []
    h, s, v, t = inp["links"]
    ccl = 3
    ref = floodscan.flood_scan_plain(h, v, s, t, ccl)
    outs = {k: torch.empty_like(ref) for k in libs}
    cases.append(("floodscan", "(%d, %d) s=%d t=%d ccl=%d"
                  % (*h.shape, s, t, ccl), ref,
                  {k: (lambda k=k: _flood(libs[k], outs[k], h, v, s, t,
                                          ccl)) for k in libs}))
    rng = np.random.RandomState(0)
    for m in (8192, 65536):
        table = torch.from_numpy(rng.randint(0, 2 ** 30, m)
                                 .astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, m, N).astype(np.int32)).to(dev)
        ref = pgather.pgather_plain(table, idx)
        o = {k: torch.empty_like(idx) for k in libs}
        cases.append(("pgather", "M=%d N=%d" % (m, N), ref,
                      {k: (lambda k=k, table=table, idx=idx:
                           _gather(libs[k].mn_pgather, o[k], table, idx))
                       for k in libs}))
    comp2d, packed, _, _, lo, offsets = inp["absorb"]
    H, W = comp2d.shape
    short = [o for o in offsets if abs(o[0]) <= 16 and abs(o[1]) <= 32]
    long_ = [o for o in offsets if o not in short]
    for name, offs in (("all", offsets), ("short", short), ("long", long_)):
        idx = [offsets.index(o) for o in offs]
        lo_o = lo[idx].contiguous()
        ref = absorb.absorb_plain(comp2d, packed, lo_o, offs, 1.0, 64)
        o = {k: (torch.empty_like(ref[0]), torch.empty_like(ref[1]))
             for k in libs}
        cases.append(("absorb", "(%d, %d) O=%d %s offsets %s" % (
            H, W, len(offs), name, list(map(tuple, offs))), ref,
            {k: (lambda k=k, lo_o=lo_o, offs=offs, o=o:
                 _absorb(libs[k], o[k], comp2d, packed, lo_o, offs))
             for k in libs}))
    grng = np.random.default_rng(0)
    gathers = []
    for m in (65536, N):
        table = torch.from_numpy(grng.integers(0, 2 ** 31 - 1, m)
                                 .astype(np.int32)).to(dev)
        idx = torch.from_numpy(grng.integers(-m - 4096, m + 4096, N)
                               .astype(np.int32)).to(dev)
        gathers.append(("random M=%d N=%d" % (m, N), table, idx))
    for name in ("overflow_gather", "relabel_gather"):
        table, idx = inp[name]
        gathers.append(("%s M=%d N=%d" % (name, table.numel(), idx.numel()),
                        table, idx))
    for shape, table, idx in gathers:
        ref = tgather.table_gather_plain(table, idx)
        o = {k: torch.empty_like(idx) for k in libs}
        cases.append(("tgather", shape, ref,
                      {k: (lambda k=k, table=table, idx=idx:
                           _gather(libs[k].mn_table_gather, o[k], table,
                                   idx)) for k in libs}))
    return inp, cases


def compare(other_csrc, device=None):
    """One row per kernel and shape: dict(kernel, shape, other_ms,
    this_ms, other_eager_ms, this_eager_ms, other_host_us, this_host_us,
    equal, ...), then this tree's wrappers and tgather's launch floor."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("compare_kernels times the GPU; got %s" % dev)
    libs = {"other": _bind(_compile(
                sorted(glob.glob(os.path.join(other_csrc, "*.cu"))),
                "other")),
            "this": _bind(_build.build())}
    inp, cases = _cases(libs, dev)
    rows = []
    for kernel, shape, ref, fns in cases:
        equal = {}
        for k, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            equal[k] = (all(torch.equal(g, r) for g, r in zip(got, ref))
                        if isinstance(ref, tuple) else
                        bool(torch.equal(got, ref)))
        times = {k: [] for k in fns}
        eager = {k: [] for k in fns}
        host = {k: [] for k in fns}
        for k in ("other", "this", "this", "other"):
            times[k].append(graph_ms(fns[k]))
            eager[k].append(eager_ms(fns[k], iters=200))
            host[k].append(host_us(fns[k]))
        med = {name: {k: statistics.median(v) for k, v in d.items()}
               for name, d in (("ms", times), ("eager_ms", eager),
                               ("host_us", host))}
        rows.append(dict(kernel=kernel, shape=shape,
                         other_ms=med["ms"]["other"],
                         this_ms=med["ms"]["this"],
                         other_eager_ms=med["eager_ms"]["other"],
                         this_eager_ms=med["eager_ms"]["this"],
                         other_host_us=med["host_us"]["other"],
                         this_host_us=med["host_us"]["this"],
                         turns_ms=times, turns_eager_ms=eager,
                         turns_host_us=host, equal=equal,
                         device_us={k: device_times(fn)
                                    for k, fn in fns.items()}))
    rows.extend(_wrapper_rows(inp))
    rows.extend(_floor_rows(dev))
    return rows


def _wrapper_rows(inp):
    """This tree's wrappers, as the decoder calls them (output
    allocation, checks and the ctypes call included): absorb on packed
    and on unpacked stats at the served shape, tgather on the overflow
    branch's indices."""
    comp2d, packed, clsfz, size, lo, offsets = inp["absorb"]
    table, idx = inp["overflow_gather"]
    ref = absorb.absorb_plain(comp2d, packed, lo, offsets, 1.0, 64)
    shape = "(%d, %d) O=%d" % (*comp2d.shape, len(offsets))
    cases = (
        ("absorb wrapper", shape + " packed stats", ref,
         lambda: absorb.absorb_best_edges(comp2d, packed, lo, offsets,
                                          1.0, 64)),
        ("absorb wrapper", shape + " unpacked stats", ref,
         lambda: absorb.absorb_best_edges_unpacked(
             comp2d, clsfz, size, lo, offsets, 1.0, 64)),
        ("tgather wrapper", "overflow_gather M=%d N=%d"
         % (table.numel(), idx.numel()),
         (tgather.table_gather_plain(table, idx),),
         lambda: (tgather.table_gather(table, idx),)))
    rows = []
    for kernel, shape, ref, fn in cases:
        got = fn()
        rows.append(dict(
            kernel=kernel, shape=shape, this_ms=graph_ms(fn),
            this_eager_ms=eager_ms(fn, iters=200), this_host_us=host_us(fn),
            equal={"this": all(torch.equal(g, r)
                               for g, r in zip(got, ref))},
            device_us={"this": device_times(fn)}))
    return rows


def _floor_rows(dev):
    """tgather's grids with no table reads: an empty kernel at this
    tree's grid (128 x 1024 at N=524288) and at the first design's
    (2048 x 256), and an int4 copy of the indices on this tree's grid."""
    floor = ctypes.CDLL(_compile([FLOOR_SRC], "floor"))
    floor.mn_floor_empty.argtypes = [_I, _I, _P]
    floor.mn_floor_copy.argtypes = [_P, _P, _I, _I, _P]
    idx = torch.zeros(N, dtype=torch.int32, device=dev)
    out = torch.empty_like(idx)
    fns = {
        "empty, 128 blocks x 1024 threads": lambda: _ok(
            floor.mn_floor_empty(N // 4096, 1024, _stream()), "empty"),
        "empty, 2048 blocks x 256 threads": lambda: _ok(
            floor.mn_floor_empty(N // 256, 256, _stream()), "empty"),
        "int4 copy, 128 blocks x 1024 threads": lambda: _ok(
            floor.mn_floor_copy(idx.data_ptr(), out.data_ptr(), N, 1024,
                                _stream()), "copy"),
    }
    return [dict(kernel="tgather floor", shape="%s, N=%d" % (name, N),
                 this_ms=graph_ms(fn), equal={},
                 device_us={"this": device_times(fn)})
            for name, fn in fns.items()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other_csrc", help="the other tree's csrc/ directory")
    args = ap.parse_args(argv)
    rows = compare(args.other_csrc)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(card(), flush=True)
    if not all(all(r["equal"].values()) for r in rows):
        raise SystemExit("compare_kernels: a kernel differs from its plain "
                         "version")


if __name__ == "__main__":
    main()
