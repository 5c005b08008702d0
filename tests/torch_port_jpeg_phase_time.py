"""Wall time of `chip_smoke.py`'s "jpeg" phase for one checkout, on the
card:

    python tests/torch_port_jpeg_phase_time.py [ROOT] [--runs N]

ROOT (default: the checkout that holds this file) is a checkout of the
repository; its own `chip_smoke.py` and `mergenet_tpu_torch` are the
ones imported.  The kernels and the JPEG decoder are built first and the
certification dataset is regenerated as chip_smoke's data phase does
(none of it timed); then the jpeg phase runs N times (default 2; the
first also loads the net's cuDNN plans), each timed by the wall clock.
Prints one JSON line: ROOT, the card, each run's seconds and the
phase's own readings of the last run.  The phase is host-bound and hosts
differ, so compare two checkouts by running the script on each in turns
(A B B A) in one session on one card."""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(HERE))
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from mergenet_tpu_torch.data import jpeg
    from mergenet_tpu_torch.ops import _build
    from mergenet_tpu_torch.timing import card
    from mergenet_tpu_torch.utils import profiling

    # as chip_smoke.py's main: float32 without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    _build.library()
    jpeg.build()
    paths = {}

    def drive(name, fn, needs):
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        paths[name] = dict(_build.LAUNCHES)
        for k in needs:
            if paths[name].get(k, 0) < 1:
                raise AssertionError("the %s path launched no %s"
                                     % (name, k))
        return out

    _, data_dir = smoke.data_phase(smi, profiling.Stopwatch())
    seconds = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        r = smoke.jpeg_phase(drive, paths, smi, profiling.Stopwatch(),
                             data_dir)
        seconds.append(time.perf_counter() - t0)
    print(json.dumps({"root": root, "card": smi, "jpeg_phase_s": seconds,
                      "last": r}), flush=True)


if __name__ == "__main__":
    main()
