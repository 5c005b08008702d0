"""Where a training step's time goes on the GPU.

    python -m mergenet_tpu_torch.profile_train [--dtype bf16]

Takes `build_train_step_compact` steps of PSPFPNet-r50 at the recipe's
configuration (batch 16 of 768x768 crops, C=9, O=10, alpha 20, SGD;
`init_model` weights and seeded random images and blocky masks: a
step's work does not depend on the data; TF32 off) and prints, as one
JSON line: the median step ms and the peak allocated bytes; then, from
torch.profiler over 3 steps, the device busy ms per step (the
union of its kernels' intervals), the device idle share, kernel launches
per step, and the aten ops (by self device time) and kernels with the
most device time.  Needs a CUDA device."""

import argparse
import collections
import json
import time

import numpy as np
import torch

from .core.offsets import generate_offsets
from .models import PSPFPNet
from .parallel.train import (build_train_step_compact, create_train_state,
                             make_optimizer)
from .profile_frame import _busy_ms
from .timing import card, median_ms

PROFILED_STEPS = 3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "float32"), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, C = 16, 768, 9
    offsets = generate_offsets(80, 10)
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 6, (B, S // 32, S // 32))
    oc = rng.integers(0, C, (B, 256))
    oc[:, 0] = 0
    batch = [torch.from_numpy(a).cuda() for a in (
        rng.integers(0, 256, (B, S, S, 3)).astype(np.uint8),
        np.repeat(np.repeat(blocks, 32, 1), 32, 2).astype(np.int32),
        oc.astype(np.int32))]
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    state = create_train_state(PSPFPNet(C + len(offsets), dtype=dtype),
                               make_optimizer())
    step = build_train_step_compact(C, offsets, alpha=20.0)

    def run():
        nonlocal state
        state, _ = step(state, *batch)

    torch.cuda.reset_peak_memory_stats()
    out = {"dtype": args.dtype, "batch": B, "crop": S,
           "step_ms": median_ms(run),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / PROFILED_STEPS
    kernels, by_name = [], collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.time_range.start, ev.time_range.end))
            by_name[ev.name] += ev.time_range.elapsed_us()
    busy = _busy_ms(kernels) / PROFILED_STEPS
    ops = sorted(((e.key, e.self_device_time_total / 1e3 / PROFILED_STEPS)
                  for e in prof.key_averages()
                  if e.self_device_time_total > 0), key=lambda r: -r[1])
    out.update({
        "profiled_step_wall_ms": wall,
        "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / wall,
        "kernel_launches": len(kernels) / PROFILED_STEPS,
        "top_ops_ms_per_step": [[k, ms] for k, ms in ops[:15]],
        "top_kernels_ms_per_step": [
            [name[:90], us / 1e3 / PROFILED_STEPS]
            for name, us in by_name.most_common(15)],
        "card": card()})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
