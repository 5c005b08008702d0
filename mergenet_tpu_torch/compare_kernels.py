"""Old against new on one card: the floodscan and pgather kernels of
another `csrc/` tree timed beside this tree's, in one process.

    git archive <commit> mergenet_tpu_torch/csrc | tar -x -C <dir>
    python -m mergenet_tpu_torch.compare_kernels <dir>/mergenet_tpu_torch/csrc

Builds the other tree's `*.cu` with this package's flags into `_build/`
(both trees must share the C interface of `mn_flood_scan` and
`mn_pgather`), checks both libraries' floodscan and pgather bit-equal to the plain
versions, then times each by CUDA-graph replay in turns (other, this,
this, other; the median of the two turns is reported) at the served
shapes: floodscan on fixture 0's flood links at 512x1024 (s=2, t=1,
ccl=3), pgather at N=524288 for M=8192 and 65536 (the gather bench's
data).  Outputs are preallocated, so both sides time the launch alone.
Each row also gives, from torch.profiler over 20 calls, every kernel's
launches per call and mean device time, so that the graph time splits
into kernel time and the gaps between launches.  Prints one JSON line
per kernel and shape, then the card.  Needs a CUDA device."""

import argparse
import collections
import ctypes
import glob
import json
import os
import statistics

import numpy as np
import torch

from . import io
from .decoder import device as D
from .ops import _build, floodscan, pgather
from .timing import card, graph_ms

FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "fixtures", "certification512")
_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind(path):
    """The library at `path` with its floodscan and pgather entry points
    typed."""
    lib = ctypes.CDLL(path)
    lib.mn_flood_scan.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.mn_pgather.argtypes = [_P, _P, _P, _I, _I, _P]
    return lib


def _build_other(csrc):
    """The other tree's csrc/*.cu built into a library of its own."""
    return _build.compile_library(
        sorted(glob.glob(os.path.join(csrc, "*.cu"))),
        os.path.join(_build.BUILD_DIR, "libother_%d.so" % os.getpid()))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _flood(lib, out, h, v, s, t, ccl):
    err = lib.mn_flood_scan(out.data_ptr(), h.data_ptr(), v.data_ptr(),
                            h.shape[0], h.shape[1], s, t, ccl, _stream())
    if err:
        raise RuntimeError("mn_flood_scan: CUDA error %d" % err)
    return out


def _gather(lib, out, table, idx):
    err = lib.mn_pgather(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         idx.numel(), table.numel(), _stream())
    if err:
        raise RuntimeError("mn_pgather: CUDA error %d" % err)
    return out


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


def served_links(dev):
    """Fixture 0's flood-fill link planes at 512x1024, as the served
    decode builds them: (h_S, s, v_S, t)."""
    offsets = io.load_offsets(FIX)
    cp, sp = io.load_probs(FIX, 0)
    cls_lp, log_odds = D._log_domain(torch.from_numpy(cp).to(dev),
                                     torch.from_numpy(sp).to(dev), 0.0)
    h, v = D._flood_links(torch.argmax(cls_lp, dim=-1), log_odds, offsets,
                          "sum", 1.0, 0.03, 2.0)
    return h[0].contiguous(), h[1], v[0].contiguous(), v[1]


def compare(other_csrc, device=None):
    """One row per kernel and shape: dict(kernel, shape, other_ms,
    this_ms, equal)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise RuntimeError("compare_kernels times the GPU; got %s" % dev)
    libs = {"other": _bind(_build_other(other_csrc)),
            "this": _bind(_build.build())}
    cases = []
    h, s, v, t = served_links(dev)
    ccl = 3
    ref = floodscan.flood_scan_plain(h, v, s, t, ccl)
    outs = {k: torch.empty_like(ref) for k in libs}
    cases.append(("floodscan", "(%d, %d) s=%d t=%d ccl=%d"
                  % (*h.shape, s, t, ccl), ref,
                  {k: (lambda k=k: _flood(libs[k], outs[k], h, v, s, t,
                                          ccl)) for k in libs}))
    rng = np.random.RandomState(0)
    n = 512 * 1024
    for m in (8192, 65536):
        table = torch.from_numpy(rng.randint(0, 2 ** 30, m)
                                 .astype(np.int32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, m, n).astype(np.int32)).to(dev)
        ref = pgather.pgather_plain(table, idx)
        gouts = {k: torch.empty_like(idx) for k in libs}
        cases.append(("pgather", "M=%d N=%d" % (m, n), ref,
                      {k: (lambda k=k, table=table, idx=idx, o=gouts:
                           _gather(libs[k], o[k], table, idx))
                       for k in libs}))
    rows = []
    for kernel, shape, ref, fns in cases:
        equal = {}
        for k, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            equal[k] = bool(torch.equal(got, ref))
        times = {k: [] for k in fns}
        for k in ("other", "this", "this", "other"):
            times[k].append(graph_ms(fns[k]))
        rows.append(dict(kernel=kernel, shape=shape,
                         other_ms=statistics.median(times["other"]),
                         this_ms=statistics.median(times["this"]),
                         turns_ms=times, equal=equal,
                         device_us={k: device_times(fn)
                                    for k, fn in fns.items()}))
    return rows


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
