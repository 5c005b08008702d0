"""Readings behind `chip_smoke.py`'s gate on procedure (c)'s exact
decodes: the port's exact decodes of the certification val images 0-7
(`run_segmentation_device` at the served settings, on the port's own
float32 maps of `bench_ckpt.npz`) against the JAX package's exact
masks of the same images (`tests/fixtures/certification512/
c_exact_<i>.npz`, written by `tests/jax_certification_ap.py
c_exact_0_7 --save-exact`), sound and with planted faults:

    python tests/torch_port_exact_readings.py [--device cpu|cuda]

The two sides' maps come from two forwards (float32, different
summation orders), and the exact decoder turns their last-bit
differences into boundary pixels that move, so the masks agree up to
renaming on most but not all pixels.  Prints, for the sound decode and
for each fault, every image's pixel agreement and instance counts and
the agreement over the 8 images (`agreement` as `chip_smoke.py`
computes it).  The faults: the offsets in reverse order (maps and
offsets out of step), `merge_logprob_bias` 0 instead of 0.03, and
`object_merge_factor` 0.8 instead of 1.0."""

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures", "certification512")
IMAGES = 8
SERVE = dict(object_merge_factor=1.0, merge_logprob_bias=0.03)
FAULTS = {"sound": ({}, False),
          "offsets reversed": ({}, True),
          "merge_logprob_bias 0": (dict(merge_logprob_bias=0.0), False),
          "object_merge_factor 0.8": (dict(object_merge_factor=0.8), False)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import imgproc
    from mergenet_tpu_torch.decoder.device import run_segmentation_device
    from chip_smoke import agreement

    # the float32 net of chip_smoke.py's (c) phase: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    offsets = io.load_offsets(FIX)
    C = 9
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                            C + len(offsets), device=dev)
    refs = []
    for i in range(IMAGES):
        with np.load(os.path.join(FIX, "c_exact_%d.npz" % i)) as z:
            refs.append(z["mask"])
    with tempfile.TemporaryDirectory() as tmp:
        CT.regenerate(tmp, train_images=0, val_images=IMAGES)
        maps = []
        for i in range(IMAGES):
            img = imgproc.imread_rgb(os.path.join(tmp, "val",
                                                  "val_%05d.png" % i))
            with torch.no_grad():
                x = torch.from_numpy(img.astype(np.float32)[None] / 256.0)
                p = torch.sigmoid(net(x.to(dev)))[0].cpu().numpy()
            maps.append((np.moveaxis(p[..., :C], -1, 0),
                         np.moveaxis(p[..., C:], -1, 0)))
    for name, (kw, reverse) in FAULTS.items():
        agree, rows = 0.0, []
        for i, (cf, sf) in enumerate(maps):
            offs = offsets[::-1] if reverse else offsets
            mask, _ = run_segmentation_device(cf, sf, C, offs, device=dev,
                                              **dict(SERVE, **kw))
            frac, _ = agreement(mask, refs[i])
            agree += frac / IMAGES
            rows.append("%d: %.6f %d/%d" % (i, frac, int(mask.max()),
                                            int(refs[i].max())))
        print("%-24s agreement over the %d images %.6f; per image "
              "(agreement, instances port/JAX): %s"
              % (name, IMAGES, agree, ", ".join(rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
