"""Where a served frame's time goes on the GPU.

    python -m mergenet_tpu_torch.profile_frame [--frames 3]

Serves the frame of `chip_smoke.py` (PSPFPNet-r50 in bf16 with the
committed trained weights, bench_img.png upscaled to 1024x2048, logits
and decode at 512x1024) and prints, as one JSON line: the median wall
ms of the net, the decode and the whole frame; then, from torch.profiler
over `--frames` decodes, the decode's device busy ms (the union of its
kernels' intervals), its device idle share, its host syncs
(`aten::_local_scalar_dense`, one per `.item()`/`bool()` on a card
tensor) and kernel launches per decode, and the kernels with the most
device time.  Needs a CUDA device."""

import argparse
import collections
import json
import os
import time

import torch

from . import e2e, io
from .convert import load_flax_weights
from .decoder.device import decode_hierarchical
from .models import PSPFPNet, logits_at
from .timing import card, median_ms

FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "fixtures", "certification512")


def _busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms (from us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    cuda = torch.device("cuda")
    offsets = io.load_offsets(FIX)
    params, stats = io.load_bench_checkpoint(
        os.path.join(FIX, "bench_ckpt.npz"))
    net = load_flax_weights(PSPFPNet(9 + len(offsets)).to(torch.bfloat16),
                            params, stats).to(cuda)
    infer = e2e.build_e2e_infer(net, 9, offsets, decode_size=(512, 1024),
                                dtype=torch.bfloat16)
    img = io.read_png_rgb(os.path.join(FIX, "bench_img.png"))
    up = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(2, 0, 1)[None].float(),
        size=(1024, 2048), mode="bilinear", align_corners=False)
    img = up.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous().to(cuda)
    x32 = img.float() / 256.0  # the /256 floats the entry point takes
    x = x32.to(torch.bfloat16)
    with torch.no_grad():
        lg = logits_at(net, x, (512, 1024))[0]

    def decode():
        return decode_hierarchical(
            lg[..., :9], lg[..., 9:], 9, offsets, object_merge_factor=1.0,
            merge_logprob_bias=0.03, relabel=True, from_logits=True)

    out = {"net_ms": median_ms(lambda: logits_at(net, x, (512, 1024))),
           "decode_ms": median_ms(decode),
           "frame_ms": median_ms(lambda: infer(x32))}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(args.frames):
            decode()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / args.frames
    kernels, syncs, by_name = [], 0, collections.Counter()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.time_range.start, ev.time_range.end))
            by_name[ev.name] += ev.time_range.elapsed_us()
        elif ev.name == "aten::_local_scalar_dense":
            syncs += 1
    busy = _busy_ms(kernels) / args.frames
    out.update({
        "profiled_decode_wall_ms": wall,
        "decode_device_busy_ms": busy,
        "decode_device_idle_share": 1.0 - busy / wall if wall else None,
        "decode_host_syncs": syncs / args.frames,
        "decode_kernel_launches": len(kernels) / args.frames,
        "top_kernels_ms_per_decode": [
            [name[:90], us / 1e3 / args.frames]
            for name, us in by_name.most_common(15)],
        "card": card()})
    print(json.dumps(out))


if __name__ == "__main__":
    main()
