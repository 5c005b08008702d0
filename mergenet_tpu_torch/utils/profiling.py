"""Profiling helpers (`mergenet_tpu.utils.profiling` is the reference):

  * `trace(logdir)`: a `torch.profiler` capture of the host and, where
    there is one, the card, written to `<logdir>/trace.json` (a chrome
    trace; open it in Perfetto or chrome://tracing).
  * `annotate(name)`: names a region so it shows in the trace.
  * `Stopwatch`: named wall-clock spans with a summary; a span given
    `sync` synchronises that card before each clock read, so it times
    the card's work and not its enqueue."""

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace of the enclosed work under `logdir`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name):
    """Named trace region: `with annotate('decode'): ...`"""
    return torch.profiler.record_function(name)


def _sync(where):
    dev = where.device if isinstance(where, torch.Tensor) \
        else torch.device(where)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stopwatch:
    """Accumulating named wall-clock spans.

    sw = Stopwatch()
    with sw.span("net", sync=x): ...   # x: a tensor or device to wait for
    with sw.span("decode"): ...
    sw.summary()
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name, sync=None):
        if sync is not None:
            _sync(sync)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append("{:<20} total {:8.3f}s  n {:5d}  avg {:8.1f}ms"
                         .format(name, tot, n, tot / n * 1000))
        out = "\n".join(lines)
        print(out)
        return out
