"""Timing of the on-chip table lookup on the card: the port of
`scripts/bench_pallas_gather.py`'s `main`.

    python -m mergenet_tpu_torch.bench_pallas_gather

Same data as the script (RandomState(0); N = 524288 indices in [0, M);
M = 8192 and 65536 int32 table entries).  Per M it checks the kernel
(`ops/pgather.py`) against `table[idx]` and times, in ms per call: the
kernel eagerly and replayed from a CUDA graph, the materialised
`table[idx] + 1` (the script's XLA twin) and the `idx + 1` null.  Prints
one line per M, then the card's name and power limit.  Runs on the GPU
only (a number taken on the CPU is no measurement of the card)."""

import sys

import numpy as np
import torch

from . import resolve_device
from .ops.pgather import pgather
from .timing import card, eager_ms, graph_ms

N = 512 * 1024
SIZES = (8192, 65536)


def make_inputs(M, rng, n=N):
    """The script's table and indices for one M, drawn from `rng`."""
    table = rng.randint(0, 2 ** 30, M).astype(np.int32)
    idx = rng.randint(0, M, n).astype(np.int32)
    return table, idx


def run(device=None):
    """Benchmark every M on `device` (None: CUDA).  Returns one dict per
    M with `correct` and the four times in ms."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_pallas_gather times the GPU; got %s" % dev)
    rng = np.random.RandomState(0)
    rows = []
    for M in SIZES:
        table_np, idx_np = make_inputs(M, rng)
        table = torch.from_numpy(table_np).to(dev)
        idx = torch.from_numpy(idx_np).to(dev)
        ref = table_np[idx_np]
        got = pgather(table, idx).cpu().numpy()
        row = dict(M=M, N=N, correct=bool(np.array_equal(got, ref)))
        row["pgather_ms"] = eager_ms(lambda: pgather(table, idx), iters=16)
        row["pgather_graph_ms"] = graph_ms(lambda: pgather(table, idx))
        row["xla_twin_ms"] = eager_ms(lambda: table[idx] + 1, iters=16)
        row["null_ms"] = eager_ms(lambda: idx + 1, iters=16)
        rows.append(row)
    return rows


def main(device=None):
    rows = run(device)
    for r in rows:
        print("M=%d  correct=%s  pgather=%.4f ms  graph=%.4f ms  "
              "xla=%.4f ms  null=%.4f" % (r["M"], r["correct"],
                                          r["pgather_ms"],
                                          r["pgather_graph_ms"],
                                          r["xla_twin_ms"], r["null_ms"]),
              flush=True)
    print(card(), flush=True)
    return rows


if __name__ == "__main__":
    rows = main()
    sys.exit(0 if all(r["correct"] for r in rows) else 1)
