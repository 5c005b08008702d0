#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mergenet_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written sm_90a kernels (one nvcc per source, started
together), holds each against its plain PyTorch version at the shapes
its paths give it, decodes a committed certification fixture on the
card and on the CPU, then drives each path of the port through its user
entry point, with the launch counts set to 0 just before and read just
after:

- `decode_hierarchical` at C=19 (fixture 0's classes widened), whose
  stats do not pack (floodscan, absorb on unpacked stats);
- the served frame: PSPFPNet-r50 in bf16 on a 1024x2048 image with the
  committed trained weights, logits at 512x1024, `decode_hierarchical`
  (`e2e.build_e2e_infer`; floodscan, absorb, tgather);
- the exact-mode decode of the fixture (`run_segmentation_device`) and
  the served frame in exact mode (`build_e2e_infer(decode_mode="exact")`;
  tgather);
- the certification: hier and exact decodes of the 8 certification512
  fixtures on the card (floodscan, absorb, tgather), scored with the
  port's COCOeval and gated against the committed C++ greedy masks, and
  the port's C++ greedy decoder (`decoder/csegment.py`) on fixture 0;
- the serving pipeline with its overflow fallback
  (`serving.build_serving_pipeline`) on a batch of two served frames;
- the gather bench (`python -m mergenet_tpu_torch.bench_pallas_gather`;
  pgather);
- training: PSPFPNet-r50 at the recipe's configuration (batch 16,
  768x768 crops of the committed val frames, alpha 20), 10 compact
  steps through `train_compact` in float32 and in bf16 (no decode
  kernel may launch), after one step held against the CPU's, and a
  checkpoint saved, loaded and resumed on the card;
- the zoo: FCN-ResNet-18 and -152, FCN-VGG16 (SAME and the reference's
  VALID head), UperNet and PSPNet at full width on a 1024x2048 frame
  through `logits_at`, bf16 against float32, and the space-to-depth
  stem against the 7x7 on the trained PSPFPNet-r50;
- class inference: PSPNet-r101 from a synthetic caffemodel with the
  released naming (`caffemodel_to_npz`, `apply_caffe_weights`, every
  tensor bit-equal), `class_inference` with `tile_predict` (713x713
  windows with flips, 19 classes remapped to 9) over the 4 bench images
  at 1024x2048, the saved maps read back and gated;
- the staged inference: `class_inference` and `offset_inference` of
  PSPFPNet-r50, the saved maps decoded by
  `run_segmentation_device(mode="hier")` on the card (floodscan,
  absorb, tgather) and on the CPU, and their mask-AP;
- PSPNet-r101's aux head in compact train steps (batch 16, 768x768,
  aux_weight 0.4, bf16), after one step held against the CPU's with
  the same dropout masks.

Every check raises; the exit code is 0 only when all phases pass.
Prints one line per phase, `train {...}`, `zoo {...}`,
`class_inference {...}`, `staged {...}` and `train_aux {...}` lines
(times, throughput, peak memory, FLOPs, shares of the bf16 peak), the
new phases' spans (`utils/profiling.Stopwatch`), the summary, then the
card, the kernels line, and last `{"ok": true, "device": {...}}`.

Needs a CUDA device and the repository around it (the port,
tests/fixtures/certification512 and the tests' shared data makers in
tests/torch_port_helpers.py); imports torch, numpy, pytest (through
those helpers) and the standard library besides the port.  Writes
nothing outside mergenet_tpu_torch/_build/ (the train phase's
checkpoints, the synthetic caffemodel and the inference phases' maps go
there and are removed).
"""

import json
import os
import signal
import sys
import time

T0 = time.perf_counter()
LIMIT_S = 600  # wall-clock guard for the whole run
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "tests", "fixtures", "certification512")
sys.path.insert(0, os.path.join(HERE, "tests"))
from torch_port_helpers import (FIXTURE_OFFSETS,  # noqa: E402
                                JAX_AP, SERVE_KW, SPIRAL_OFFSETS,
                                absorb_planes, coco_stats,
                                randomize_batch_norm, wide_classes,
                                write_pspnet_caffemodel)

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the non-tensor
# 32-bit vector rate, the ceiling of the kernels' integer/float work
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12

# decode-phase gate: CUDA's log/exp may round one ulp away from the
# CPU's, so the card's decode may differ from the CPU's in rare near-tie
# merges; the integer kernels themselves are held bit-exact in phase 3
MIN_PIXEL_AGREEMENT = 0.999
MAX_INSTANCE_DIFF = 1

# floodscan shapes held bit-equal beside the served one: (H, W, s, t,
# ccl), chosen to break the kernel's tiling (16-byte path off, one
# sweep, taller than a V strip, wider than an H block, strides over
# half a tile)
FLOOD_SHAPES = ((61, 130, 2, 1, 3), (37, 1000, 3, 2, 3),
                (512, 1024, 2, 1, 1), (1500, 40, 1, 2, 2),
                (9, 5000, 2, 1, 2), (3, 5000, 1300, 1, 1))
# absorb cases held bit-equal beside the served one, packed and unpacked
# (H, W, offsets, frozen share, quantised log-odds, sizes drawn below),
# chosen to break the kernel's 16x32 tiles and its halo of |di| <= 16,
# |dj| <= 32 (five long offsets in one case); sizes mostly over the cap
# of 64 make whole warps skip; the last has more row tiles than a grid's
# y dimension holds
ABSORB_SHAPES = ((77, 301, FIXTURE_OFFSETS, 0.05, True, 120),
                 (7, 5, FIXTURE_OFFSETS, 0.05, True, 120),
                 (40, 130, ((3, -7),), 0.05, True, 120),
                 (70, 260, SPIRAL_OFFSETS, 0.05, True, 120),
                 (512, 1024, SPIRAL_OFFSETS, 0.05, False, 120),
                 (1000, 37, FIXTURE_OFFSETS, 0.05, True, 120),
                 (96, 300, FIXTURE_OFFSETS, 0.05, True, 3000),
                 (100, 300, ((0, 40), (20, 0), (1, 1), (-30, 5), (5, -50),
                             (40, 40), (2, -3)), 0.05, True, 120),
                 (64, 256, FIXTURE_OFFSETS, 1.0, True, 120),
                 (1100000, 1, ((1, 0), (-20, 0), (300, 0)), 0.05, True,
                  120))
# pgather table sizes held bit-equal on out-of-range indices: one
# entry, the bench's two, odd sizes around 227 KB (what one block's
# shared memory holds), and tables of 0.8 MB and 4 MB
PGATHER_SIZES = (1, 8192, 58112, 58113, 65536, 200003, 1 << 20)

# frame-phase gate on the bf16 net against its float32 forward (no TF32)
# on the same card: bf16 keeps 8 mantissa bits, and the error grows
# through ResNet-50's 53 convs
BF16_MAX_ABS = 1.0
BF16_ARGMAX_AGREEMENT = 0.99

# certification gates (tests/test_certification_512.py:97-98 and the
# exact bound of its test_summary_multiseed_gate): AP and AP50 below the
# C++ greedy's by at most these; each card AP within CERT_JAX_AP_TOL of
# the JAX package's figure on the CPU (`JAX_AP`), as the card's decode
# may differ from the CPU's on 0.1% of pixels
CERT_AP_MARGIN = 0.01
CERT_AP50_MARGIN = 0.03
CERT_JAX_AP_TOL = 0.005
# the port's C++ greedy on fixture 0 against the committed
# cpp_mask_0.npz, which was decoded from the float32 maps before they
# were stored as float16 (the JAX package's C++ differs on 1.40%)
CPP_CLASSES_0 = [1, 1, 5, 4]
CPP_MAX_DIFFER = 0.02


# train phase (PSPFPNet-r50 at the recipe's configuration,
# egs/cityscape/local/run_pspfpnet_crop.sh: batch 16, 768x768 crops,
# --alpha 20, SGD lr 0.01, momentum 0.9, nesterov, wd 1e-4)
TRAIN_BATCH, TRAIN_CROP, TRAIN_ALPHA = 16, 768, 20.0
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_TIMED = 10, 3, 5
H100_BF16_DENSE_FLOPS = 989e12  # NVIDIA data sheet, SXM, dense
H100_FP32_FLOPS = 67e12  # non-tensor float32
# card against CPU, one step at batch 2, 256x256 crops, TF32 off: the
# loss; the running statistics (forward only); each parameter's update
# in relative L2 norm: a ResNet-50's train-mode gradient moves ~4-6% per
# leaf between two float32 summation orders (the port's float32 step
# against its float64 one, tests/test_torch_port_train.py)
TRAIN_LOSS_RTOL = 1e-3
TRAIN_STATS_TOL = 1e-3
TRAIN_UPDATE_RTOL = 0.1  # measured: 0.018 at most (PERF.md)
TRAIN_BF16_LOSS_RTOL = 0.02
# a resumed step against the uninterrupted one on the card: the forward
# (loss, running statistics, eval logits) is deterministic and must be
# bit-equal; the backward's atomics (bilinear resize, cuDNN weight
# gradients) reorder float sums between runs (measured: 1.7e-5, 2.15e-4
# and 4.0e-4 in three runs).  The same step resumed with its momentum
# buffers dropped must land above the limit: the script plants that
# fault on a second loaded state and fails if the gate does not see it
TRAIN_RESUME_UPDATE_RTOL = 2e-3

# zoo phase: each arch at full width on a 1024x2048 frame (bench_img.png
# upscaled x2), logits at 512x1024 through `logits_at`, in bf16 compute
# and in float32 (TF32 off), seeded weights (flax-style init, batch
# norms with seeded positive statistics): untrained logits, so the gates
# are relative: the largest bf16 error over the float32 logits' largest
# magnitude, and argmax agreement over the class channels
ZOO_ARCHS = (("fcn8_resnet18", {}), ("fcn32_resnet152", {}),
             ("fcn8_vgg16", {}), ("fcn8_vgg16", {"ref_head": True}),
             ("upernet", {}), ("pspnet", {}))
ZOO_BF16_MAX_REL = 0.05
ZOO_BF16_ARGMAX = 0.9
ZOO_REPS = 3
# PSPFPNet-r50 (the committed trained weights) with the space-to-depth
# stem against the 7x7, float32 (TF32 off): the same function up to the
# stem's summation order; the largest logit error over the largest logit
S2D_MAX_REL = 1e-4

# class inference (PSPNet-r101, hszhao/PSPNet's pspnet101_cityscapes:
# 19 classes, 713x713 windows, flips, caffe-style mean-subtracted BGR
# input; the reference's remap of 11 stuff + 8 thing classes to 9), from
# a synthetic caffemodel with the released naming and every tensor at
# full size, on the 4 bench images upscaled to 1024x2048
CLASS_WINDOW = (713, 713)
CLASS_MODEL_CLASSES, CLASS_INSTANCE_CLASSES = 19, 9
CLASS_SUM_TOL = 1e-5
# bf16 against float32 maps: probabilities, so the gate is their mean
# absolute difference and the argmax agreement; the largest difference
# (a softmax over near-equal untrained logits moves a lot of mass for a
# small logit error) is a reading
CLASS_BF16_MEAN_ABS = 0.02
CLASS_BF16_ARGMAX = 0.95
CAFFE_MEAN_RGB = (123.68, 116.779, 103.939)  # data/dataset.py's caffe mode

# train with PSPNet's aux head: PSPNet-r101 at the recipe's batch 16 of
# 768x768 crops, alpha 20, aux_weight 0.4 (the PSPNet paper's), bf16
TRAIN_AUX_WEIGHT = 0.4
TRAIN_AUX_STEPS, TRAIN_AUX_WARMUP = 5, 2


def phase(name):
    elapsed = time.perf_counter() - T0
    if elapsed > LIMIT_S:
        raise TimeoutError("chip_smoke passed its %d s limit" % LIMIT_S)
    print("[%8.2f s] %s" % (elapsed, name), flush=True)


def _on_alarm(signum, frame):
    raise TimeoutError("chip_smoke passed its %d s limit" % LIMIT_S)


def bound(nbytes, ops):
    """(least ms for the work, which of bytes/operations bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / VECTOR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def agreement(a, b):
    """(fraction of pixels in matched instances, exact) for two label
    grids compared up to renaming: instances are matched one to one
    greedily by overlap; exact means the labelings are the same
    partition."""
    import numpy as np
    a = np.asarray(a).ravel().astype(np.int64)
    b = np.asarray(b).ravel().astype(np.int64)
    K = int(b.max()) + 1
    u, cnt = np.unique(a * K + b, return_counts=True)
    used_a, used_b, agree = set(), set(), 0
    for k in np.argsort(-cnt, kind="stable"):
        i, j = divmod(int(u[k]), K)
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            agree += int(cnt[k])
    exact = len(u) == len(np.unique(a)) == len(np.unique(b))
    return agree / a.size, bool(exact)


def check_decode(tag, mask, ref, names=("card", "cpu")):
    """Gate a decoded mask against a reference decode (up to renaming)."""
    frac, exact = agreement(mask, ref)
    n, n_ref = int(mask.max()), int(ref.max())
    differ = int(round((1.0 - frac) * mask.size))
    print("  %s: exact=%s pixels_differing=%d agreement=%.6f "
          "instances %s=%d %s=%d" % (tag, exact, differ, frac, names[0], n,
                                     names[1], n_ref), flush=True)
    if frac < MIN_PIXEL_AGREEMENT or abs(n - n_ref) > MAX_INSTANCE_DIFF:
        raise AssertionError("%s: %s decode disagrees with the %s one "
                             "(agreement %.6f, instances %d vs %d)"
                             % (tag, names[0], names[1], frac, n, n_ref))
    return {"exact": exact, "pixels_differing": differ, "agreement": frac,
            "instances": n, "instances_ref": n_ref}


def absorb_needed_log_odds(comp2d, packed_own, offsets, size_cap):
    """The log-odds entries the absorb scan needs on these inputs: those
    of the edges (p, p + o) that pass every eligibility test but the
    evidence one (the entry decides the edge in either direction)."""
    from mergenet_tpu_torch.ops.grid import shift2d
    size, cf = packed_own >> 5, packed_own & 31
    n = 0
    for di, dj in offsets:
        nbr = shift2d(comp2d, di, dj, -1)
        ok = ((nbr >= 0) & (nbr != comp2d) & ((cf & 1) == 0)
              & (shift2d(cf, di, dj, 1) == cf)
              & (size.minimum(shift2d(size, di, dj, 0)) <= size_cap))
        n += int(ok.sum())
    return n


def certify(drive):
    """The certification phase: hier (`decode_hierarchical` +
    `relabel_mask`, zero overflow required) and exact
    (`run_segmentation_device`) decodes of the 8 certification512
    fixtures on the card with the launches counted, both scored with the
    port's COCOeval under procedure (a), every image of val_ann.json, and
    (b), the 8 fixture images only, and gated against the committed C++
    greedy masks and the JAX package's figures; then the port's C++
    greedy on fixture 0 on the host."""
    import numpy as np
    import torch
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import COCO
    from mergenet_tpu_torch.decoder import csegment
    from mergenet_tpu_torch.decoder import device as D
    from mergenet_tpu_torch.e2e import masks_to_results

    offsets = io.load_offsets(FIX)
    C = 9
    cats = list(range(C))  # category id = class id, as the fixtures' GT
    ids = list(range(8))
    res = {"hier": [], "exact": [], "cpp": []}
    overflow = {}

    def decode_all():
        for i in ids:
            cp, sp = io.load_probs(FIX, i)
            comp, rc, ii, st = D.decode_hierarchical(
                torch.from_numpy(cp).cuda(), torch.from_numpy(sp).cuda(), C,
                offsets, return_stats=True, **SERVE_KW)
            overflow[i] = {k: int(st[k]) for k in
                           ("edges_dropped", "pairs_dropped", "n_frozen")}
            mask, ic = D.relabel_mask(comp, rc, ii)
            res["hier"] += masks_to_results(mask[None], ic[None], [i], cats)
            em, ec = D.run_segmentation_device(
                np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0), C, offsets,
                **SERVE_KW)
            res["exact"] += masks_to_results(
                em[None], np.asarray(ec + [-1], np.int32)[None], [i], cats)
            with np.load(os.path.join(FIX, "cpp_mask_%d.npz" % i)) as cm:
                res["cpp"] += masks_to_results(cm["mask"][None],
                                               cm["classes"][None], [i], cats)

    t0 = time.perf_counter()
    drive("certification", decode_all, ("floodscan", "absorb", "tgather"))
    decode_s = time.perf_counter() - t0
    print("  8 fixtures decoded on the card (hier + exact) in %.2f s; "
          "overflow %s" % (decode_s, overflow), flush=True)
    if any(v for o in overflow.values() for v in o.values()):
        raise AssertionError("hier decode overflowed: %s" % overflow)

    t0 = time.perf_counter()
    coco = COCO(os.path.join(FIX, "val_ann.json"))
    ap = {proc: {name: tuple(coco_stats(coco, r, None if proc == "a"
                                        else ids)[:2])
                 for name, r in res.items()} for proc in ("a", "b")}
    score_s = time.perf_counter() - t0
    for proc, title in (("a", "every image of val_ann.json"),
                        ("b", "the 8 fixture images")):
        for name, (a, a50) in ap[proc].items():
            j, j50 = JAX_AP[proc][name]
            print("  (%s) %s: %-5s AP %.4f AP50 %.4f | JAX (CPU) AP %.4f "
                  "AP50 %.4f" % (proc, title, name, a, a50, j, j50),
                  flush=True)
    gates = [("(a) hier AP50 >= C++ AP50 - %.2f" % CERT_AP50_MARGIN,
              ap["a"]["hier"][1] >= ap["a"]["cpp"][1] - CERT_AP50_MARGIN)]
    for proc in ("a", "b"):
        for name in ("hier", "exact"):
            gates.append(("(%s) %s AP >= C++ AP - %.2f" % (
                proc, name, CERT_AP_MARGIN),
                ap[proc][name][0] >= ap[proc]["cpp"][0] - CERT_AP_MARGIN))
        for name in ("hier", "exact", "cpp"):
            gates.append(("(%s) %s AP within %.3f of JAX's" % (
                proc, name, CERT_JAX_AP_TOL),
                abs(ap[proc][name][0] - JAX_AP[proc][name][0])
                <= CERT_JAX_AP_TOL))
    failed = [name for name, ok in gates if not ok]
    print("  gates: %d passed, failed: %s" % (len(gates) - len(failed),
                                             failed or "none"), flush=True)
    if failed:
        raise AssertionError("certification gates failed: %s" % failed)

    t0 = time.perf_counter()
    stale = csegment.library_path()
    if os.path.exists(stale):  # measure the real build every run
        os.unlink(stale)
    csegment.build()
    build_s = time.perf_counter() - t0
    cp, sp = io.load_probs(FIX, 0)
    t0 = time.perf_counter()
    cm_mask, cm_cls = csegment.run_segmentation(
        np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0), C, offsets,
        same_different_bias=0.0, **SERVE_KW)
    cpp_s = time.perf_counter() - t0
    with np.load(os.path.join(FIX, "cpp_mask_0.npz")) as cm:
        ref_mask = cm["mask"]
    differ = int((cm_mask != ref_mask).sum())
    print("  C++ greedy (decoder/csegment.py) on fixture 0 (512x1024): g++ "
          "build %.2f s, decode %.2f s on the host; classes %s; %d of %d "
          "pixels differ from cpp_mask_0.npz (limit %.0f%%)" % (
              build_s, cpp_s, cm_cls, differ, ref_mask.size,
              100 * CPP_MAX_DIFFER), flush=True)
    if cm_cls != CPP_CLASSES_0 or differ > CPP_MAX_DIFFER * ref_mask.size:
        raise AssertionError("C++ greedy on fixture 0: classes %s (want %s),"
                             " %d pixels differ" % (cm_cls, CPP_CLASSES_0,
                                                    differ))
    return {"ap": ap, "overflow": overflow, "decode_s": decode_s,
            "score_s": score_s, "cpp_build_s": build_s,
            "cpp_decode_s": cpp_s, "cpp_pixels_differing": differ,
            "cpp_classes": cm_cls}


def bench_images():
    """The 4 committed val images (certification512/bench_img*.png, val
    ids 0-3, 512x1024 uint8 RGB)."""
    from mergenet_tpu_torch import io
    return [io.read_png_rgb(os.path.join(
        FIX, "bench_img.png" if k == 0 else "bench_img_%d.png" % k))
        for k in range(4)]


def upscale2(a):
    """x2 nearest upscale of an (H, W, ...) array: a val frame to a
    Cityscapes frame's 1024x2048."""
    import numpy as np
    return np.repeat(np.repeat(a, 2, 0), 2, 1)


def train_data(rng):
    """The train phase's compact batch: the 4 committed val images
    (`bench_images`, the first four sorted val ids, as
    scripts/export_bench_checkpoint.py took them) and their instance
    masks from val_ann.json (first annotation wins, ids in annotation
    order, classes through [0] + category ids), each upscaled x2
    (nearest) to 1024x2048; TRAIN_BATCH crops of TRAIN_CROP^2 at
    positions drawn from `rng`, frame i % 4 for crop i."""
    import numpy as np
    from mergenet_tpu_torch.data import COCO

    coco = COCO(os.path.join(FIX, "val_ann.json"))
    ids = sorted(coco.imgs)[:4]
    cat_ids = [0] + coco.getCatIds()
    frames = []
    for img_id, img in zip(ids, bench_images()):
        info = coco.imgs[img_id]
        if (ids != [0, 1, 2, 3] or img.shape != (512, 1024, 3)
                or (info["height"], info["width"]) != (512, 1024)):
            raise AssertionError("val image %s: ids %s, png %s, json %sx%s"
                                 % (img_id, ids, img.shape, info["height"],
                                    info["width"]))
        mask = np.zeros((512, 1024), np.int32)
        table = np.zeros(256, np.int32)
        for i, ann in enumerate(coco.loadAnns(coco.getAnnIds(
                imgIds=img_id)), 1):
            m = coco.annToMask(ann).astype(bool)
            mask[m & (mask == 0)] = i
            table[i] = cat_ids.index(ann["category_id"])
        frames.append((upscale2(img), upscale2(mask), table))
    S = TRAIN_CROP
    batch = {"image": [], "mask": [], "object_class": []}
    for i in range(TRAIN_BATCH):
        img, mask, table = frames[i % 4]
        r = int(rng.integers(0, img.shape[0] - S + 1))
        c = int(rng.integers(0, img.shape[1] - S + 1))
        batch["image"].append(img[r:r + S, c:c + S])
        batch["mask"].append(mask[r:r + S, c:c + S])
        batch["object_class"].append(table)
    return {k: np.stack(v) for k, v in batch.items()}, \
        [len(coco.getAnnIds(imgIds=i)) for i in ids]


def _update_rel(new, new_ref, old):
    """Per parameter: |(new - old) - (new_ref - old)| / |new_ref - old|
    (L2), for parameters whose reference update is not ~0 (a conv bias
    before batch norm has an exact-zero gradient)."""
    out = {}
    for k, o in old.items():
        du = new_ref[k].detach().double().cpu() - o
        if float(du.abs().max()) < 1e-6:
            continue
        out[k] = float((new[k].detach().double().cpu() - o - du).norm()
                       / du.norm())
    return out


def train_phase(drive, paths, smi, kernel_names):
    """The train phase on PSPFPNet-r50 at the recipe's configuration
    (TRAIN_* above), from the committed trained weights (float32 params):
    one compact step on the card against the CPU (batch 2, 256^2, TF32
    off), then `build_train_step_compact` through `train_compact`, 10
    steps on one fixed batch 16 x 768^2 in float32 (TF32 off) and in
    bf16 (float32 params and statistics), launches counted (none of the
    decode's kernels may run; `paths` gets their zero counts under
    "train"), the loss falling in both; step ms,
    images/s, peak memory, FLOPs per step (FlopCounterMode) and the
    share of the card's dense bf16 peak; then checkpoints saved and
    loaded on the card, the eval logits and one more step against the
    uninterrupted run."""
    import shutil
    import statistics

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.core import generate_offsets
    from mergenet_tpu_torch.models import PSPFPNet, logits_at
    from mergenet_tpu_torch.parallel import train as T
    from mergenet_tpu_torch.utils.checkpoint import load_checkpoint
    from mergenet_tpu_torch.utils.train_utils import (save_checkpoint,
                                                      train_compact)

    C = 9
    offsets = generate_offsets(80, 10)  # the recipe's (train.py, mode all)
    if tuple(offsets) != io.load_offsets(FIX):
        raise AssertionError("generate_offsets(80, 10) %s != the trained "
                             "weights' offsets" % (offsets,))
    params, stats = io.load_bench_checkpoint(os.path.join(FIX,
                                                          "bench_ckpt.npz"))
    nout = C + len(offsets)
    tx = T.make_optimizer(lr=0.01, momentum=0.9, nesterov=True,
                          weight_decay=1e-4)

    def new_state(device, dtype=None):
        state = T.create_train_state(PSPFPNet(nout, dtype=dtype), tx,
                                     device=device)
        load_flax_weights(state.model, params, stats)  # float32 params
        return state

    t_phase = time.perf_counter()
    batch, n_anns = train_data(np.random.default_rng(0))
    out = {"config": {"model": "PSPFPNet-r50", "classes": C,
                      "offsets": [list(o) for o in offsets],
                      "batch": TRAIN_BATCH, "crop": TRAIN_CROP,
                      "alpha": TRAIN_ALPHA, "lr": 0.01, "momentum": 0.9,
                      "nesterov": True, "weight_decay": 1e-4,
                      "instances_per_frame": n_anns}}

    # -- card against CPU, one step at batch 2, 256^2 -------------------
    small = {k: v[:2, :256, :256] if v.ndim > 2 else v[:2]
             for k, v in batch.items()}
    step = T.build_train_step_compact(C, offsets, alpha=TRAIN_ALPHA)
    res = {}
    for dev in ("cpu", "cuda"):
        state = new_state(dev)
        old = {k: v.detach().double().cpu().clone()
               for k, v in state.model.named_parameters()}
        state, m = step(state, *(small[k] for k in ("image", "mask",
                                                    "object_class")))
        res[dev] = (float(m["loss"]), dict(state.model.named_parameters()),
                    {k: v.cpu() for k, v in state.model.named_buffers()})
        del state
    (l_cpu, p_cpu, b_cpu), (l_card, p_card, b_card) = res["cpu"], res["cuda"]
    upd = _update_rel(p_card, p_cpu, old)
    worst = max(upd, key=upd.get)
    stats_ok = all(torch.allclose(b_card[k], b_cpu[k], rtol=TRAIN_STATS_TOL,
                                  atol=TRAIN_STATS_TOL) for k in b_cpu)
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    out["card_vs_cpu"] = {
        "loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": loss_rel,
        "update_rel_median": statistics.median(upd.values()),
        "update_rel_max": upd[worst], "update_rel_worst": worst,
        "stats_max_abs": max(float((b_card[k] - b_cpu[k]).abs().max())
                             for k in b_cpu)}
    print("  card vs cpu, one step at batch 2, 256^2 (TF32 off): loss "
          "%.6f / %.6f (rel %.2e, limit %.0e); updates rel L2 median "
          "%.4f, max %.4f at %s (limit %.2f); running stats max abs %.2e "
          "(limit %.0e + %.0e rel)" % (
              l_card, l_cpu, loss_rel, TRAIN_LOSS_RTOL,
              out["card_vs_cpu"]["update_rel_median"], upd[worst], worst,
              TRAIN_UPDATE_RTOL, out["card_vs_cpu"]["stats_max_abs"],
              TRAIN_STATS_TOL, TRAIN_STATS_TOL), flush=True)
    if (loss_rel > TRAIN_LOSS_RTOL or upd[worst] > TRAIN_UPDATE_RTOL
            or not stats_ok):
        raise AssertionError("train step: card disagrees with the CPU")
    del res, p_cpu, p_card

    # -- the main path: 10 steps in float32 and in bf16 ------------------
    dev_batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}

    def run(dtype):
        state = new_state(None, dtype)
        step = T.build_train_step_compact(C, offsets, alpha=TRAIN_ALPHA)
        losses, times = [], []

        def timed(state, *args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, *args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            return state, m

        torch.cuda.reset_peak_memory_stats()
        state, iters = train_compact([dev_batch] * TRAIN_STEPS, state, timed,
                                     TRAIN_BATCH, 0, 0, print_freq=5)
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times[TRAIN_WARMUP:TRAIN_WARMUP
                                     + TRAIN_TIMED])
        return state, {"losses": losses, "step_ms": ms, "steps_ms": times,
                       "images_per_s": TRAIN_BATCH / ms * 1e3,
                       "peak_bytes": peak, "remat": False}

    runs = {}

    def main_path():
        # float32 at batch 16 fits the card's 80 GB without the
        # recipe's --remat (PERF.md: 31.8 GB peak)
        state, runs["float32"] = run(None)
        runs["float32"]["tf32"] = bool(torch.backends.cudnn.allow_tf32)
        _, runs["bf16"] = run(torch.bfloat16)
        return state

    state32 = drive("train", main_path, ())
    paths_train = {k: int(paths["train"].get(k, 0)) for k in kernel_names}
    paths["train"] = paths_train
    for name, r in runs.items():
        print("  %s: losses %s; step %.1f ms (median of %d after %d "
              "warm-up), %.2f images/s, peak %.2f GB allocated, remat %s "
              "(%s)" % (name, ["%.4f" % v for v in r["losses"]],
                        r["step_ms"], TRAIN_TIMED, TRAIN_WARMUP,
                        r["images_per_s"], r["peak_bytes"] / 1e9,
                        r["remat"], smi), flush=True)
    l32, l16 = runs["float32"]["losses"], runs["bf16"]["losses"]
    bf16_rel = abs(l16[0] - l32[0]) / abs(l32[0])
    print("  launches on the train path: %s; first-step loss bf16 vs "
          "float32: rel %.2e (limit %.2f)" % (paths_train, bf16_rel,
                                              TRAIN_BF16_LOSS_RTOL),
          flush=True)
    if any(paths_train.values()):
        raise AssertionError("the train path launched a decode kernel")
    for name, r in runs.items():
        if not (np.all(np.isfinite(r["losses"]))
                and r["losses"][-1] < r["losses"][0]):
            raise AssertionError("%s: the loss did not fall over %d steps "
                                 "on one batch: %s" % (name, TRAIN_STEPS,
                                                       r["losses"]))
    if bf16_rel > TRAIN_BF16_LOSS_RTOL:
        raise AssertionError("bf16 first-step loss %.6f vs float32 %.6f"
                             % (l16[0], l32[0]))

    # -- FLOPs per step and the share of the card's bf16 peak -----------
    args = [dev_batch[k] for k in ("image", "mask", "object_class")]
    with FlopCounterMode(display=False) as fc:
        state32, _ = T.build_train_step_compact(
            C, offsets, alpha=TRAIN_ALPHA)(state32, *args)
    flops = fc.get_total_flops()
    out["flops_per_step"] = flops
    out["bf16_peak_share"] = flops / (runs["bf16"]["step_ms"] / 1e3) \
        / H100_BF16_DENSE_FLOPS
    out["fp32_peak_share"] = flops / (runs["float32"]["step_ms"] / 1e3) \
        / H100_FP32_FLOPS
    print("  %.4g FLOPs per step (FlopCounterMode, forward + backward); "
          "bf16 step reaches %.4f of the dense bf16 peak %.0f TFLOP/s, "
          "float32 (TF32 off) %.4f of the %.0f TFLOP/s non-tensor peak "
          "(%s)" % (flops, out["bf16_peak_share"],
                    H100_BF16_DENSE_FLOPS / 1e12, out["fp32_peak_share"],
                    H100_FP32_FLOPS / 1e12, smi), flush=True)

    # -- checkpoints: save, load into a fresh state, resume -------------
    ckdir = os.path.join(HERE, "mergenet_tpu_torch", "_build", "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    save_checkpoint(ckdir, state32, True, epoch=1, best_iou=0.5,
                    offsets=offsets)
    small_img = torch.from_numpy(small["image"]).cuda().float() / 256.0
    logits_saved = logits_at(state32.model, small_img, (256, 256))
    step = T.build_train_step_compact(C, offsets, alpha=TRAIN_ALPHA)
    fresh = T.create_train_state(PSPFPNet(nout), tx, seed=1)
    fresh, meta = load_checkpoint(os.path.join(ckdir, "model_best"), fresh)
    logits_loaded = logits_at(fresh.model, small_img, (256, 256))
    old = {k: v.detach().double().cpu() for k, v in
           state32.model.named_parameters()}
    # the planted fault: the same checkpoint, its momentum buffers lost
    dropped = T.create_train_state(PSPFPNet(nout), tx, seed=1)
    dropped, _ = load_checkpoint(os.path.join(ckdir, "model_best"), dropped)
    dropped.optimizer.state.clear()
    state32, m_run = step(state32, *args)
    fresh, m_res = step(fresh, *args)
    dropped, _ = step(dropped, *args)
    torch.cuda.synchronize()
    run_params = dict(state32.model.named_parameters())
    upd = _update_rel(dict(fresh.model.named_parameters()), run_params, old)
    upd_dropped = _update_rel(dict(dropped.model.named_parameters()),
                              run_params, old)
    del dropped
    bufs_equal = all(torch.equal(a, b) for a, b in zip(
        fresh.model.buffers(), state32.model.buffers()))
    params_equal = all(torch.equal(a, b) for a, b in zip(
        fresh.model.parameters(), state32.model.parameters()))
    out["checkpoint"] = {
        "eval_logits_equal": bool(torch.equal(logits_loaded,
                                              logits_saved)),
        "meta": {"epoch": meta.get("epoch"), "step": fresh.step},
        "resumed_loss": float(m_res["loss"]), "run_loss": float(m_run["loss"]),
        "stats_equal": bufs_equal, "params_equal": params_equal,
        "update_rel_max": max(upd.values()),
        "momentum_dropped_update_rel_max": max(upd_dropped.values())}
    print("  checkpoint: eval logits bit-equal %s; resumed step: loss %.6f "
          "vs %.6f, running stats bit-equal %s, params bit-equal %s, "
          "updates rel L2 max %.2e (limit %.0e); with the momentum "
          "buffers dropped on load: %.2e" % (
              out["checkpoint"]["eval_logits_equal"], m_res["loss"],
              m_run["loss"], bufs_equal, params_equal,
              out["checkpoint"]["update_rel_max"],
              TRAIN_RESUME_UPDATE_RTOL,
              out["checkpoint"]["momentum_dropped_update_rel_max"]),
          flush=True)
    shutil.rmtree(ckdir, ignore_errors=True)
    if not (out["checkpoint"]["eval_logits_equal"] and bufs_equal
            and float(m_res["loss"]) == float(m_run["loss"])
            and out["checkpoint"]["update_rel_max"]
            <= TRAIN_RESUME_UPDATE_RTOL
            and out["checkpoint"]["momentum_dropped_update_rel_max"]
            > TRAIN_RESUME_UPDATE_RTOL and fresh.step == state32.step
            and meta.get("epoch") == 1
            and meta.get("offsets") == [tuple(o) for o in offsets]):
        raise AssertionError("checkpoint round trip on the card failed: %s"
                             % out["checkpoint"])
    out.update(runs)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _twin(make, model):
    """`make()` (the same architecture, e.g. with another compute dtype)
    built on the meta device and given `model`'s parameters and
    statistics, shared, not copied."""
    import torch
    with torch.device("meta"):
        twin = make()
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.eval()


def _relative_gap(got, ref, classes):
    """(largest |got - ref| over the largest |ref|, argmax agreement over
    the first `classes` channels) of two channel-last maps."""
    err = float((got.float() - ref).abs().max() / ref.abs().max())
    agree = float((got[..., :classes].argmax(-1)
                   == ref[..., :classes].argmax(-1)).float().mean())
    return err, agree


def top_device_ops(fn, n=6):
    """Run `fn` once under torch.profiler: (device busy ms, the union of
    its kernels' intervals; the `n` aten ops with the most self device
    ms, their kernels' time)."""
    import torch
    from mergenet_tpu_torch.profile_frame import _busy_ms
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    busy = _busy_ms([(ev.time_range.start, ev.time_range.end)
                     for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA])
    ops = sorted(((e.key, e.self_device_time_total / 1e3)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    return busy, [[k, ms] for k, ms in ops[:n]]


def zoo_phase(drive, smi, sw):
    """Every family of the zoo at full width (ZOO_ARCHS) on a 1024x2048
    frame, logits at 512x1024: ms per forward in bf16 and float32 (TF32
    off), parameters, FLOPs (FlopCounterMode), peak memory, and the
    relative bf16 gates; then the space-to-depth stem against the 7x7 on
    the committed trained PSPFPNet-r50.  No decode kernel may launch."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.models import (PSPFPNet, get_model, init_model,
                                           logits_at, param_count)
    from mergenet_tpu_torch.timing import median_ms

    cuda = torch.device("cuda")
    x32 = torch.from_numpy(upscale2(bench_images()[0])).to(cuda)[None]
    x32 = x32.float() / 256.0
    size = (512, 1024)
    rows = []

    def forwards():
        for seed, (arch, kw) in enumerate(ZOO_ARCHS):
            with sw.span("zoo build", sync=cuda):
                with torch.device("meta"):  # no default init on the host
                    m32 = get_model(9, 10, arch, **kw)
                m32 = randomize_batch_norm(init_model(
                    m32.to_empty(device=cuda), seed), seed + 100).eval()
                m16 = _twin(lambda: get_model(9, 10, arch,
                                              dtype=torch.bfloat16, **kw),
                            m32)
            row = {"arch": arch, **kw, "params": param_count(m32)}
            with sw.span("zoo forwards", sync=cuda):
                for name, m in (("float32", m32), ("bf16", m16)):
                    torch.cuda.reset_peak_memory_stats()
                    row[name + "_ms"] = median_ms(
                        lambda: logits_at(m, x32, size), reps=ZOO_REPS)
                    row[name + "_peak_bytes"] = \
                        torch.cuda.max_memory_allocated()
                lg32 = logits_at(m32, x32, size)
                lg16 = logits_at(m16, x32, size)
                with FlopCounterMode(display=False) as fc:
                    logits_at(m16, x32, size)
            row["flops"] = fc.get_total_flops()
            row["finite"] = bool(torch.isfinite(lg32).all()
                                 and torch.isfinite(lg16).all())
            row["bf16_max_rel"], row["bf16_argmax"] = _relative_gap(
                lg16, lg32, 9)
            row["max_abs_logit"] = float(lg32.abs().max())
            row["shape"] = list(lg32.shape)
            rows.append(row)
            print("  %-16s %s params %.2fM, %.4g FLOPs; float32 %.2f ms, "
                  "bf16 %.2f ms per forward; peak %.2f / %.2f GB; bf16 vs "
                  "float32: max rel %.2e (limit %.2f), argmax %.5f (limit "
                  "%.2f) (%s)" % (
                      arch, kw or "", row["params"] / 1e6, row["flops"],
                      row["float32_ms"], row["bf16_ms"],
                      row["float32_peak_bytes"] / 1e9,
                      row["bf16_peak_bytes"] / 1e9, row["bf16_max_rel"],
                      ZOO_BF16_MAX_REL, row["bf16_argmax"],
                      ZOO_BF16_ARGMAX, smi), flush=True)
            del m32, m16, lg32, lg16
            torch.cuda.empty_cache()

        params, stats = io.load_bench_checkpoint(os.path.join(
            FIX, "bench_ckpt.npz"))
        with sw.span("zoo s2d stem", sync=cuda):
            base, s2d = (load_flax_weights(PSPFPNet(19, s2d_stem=v), params,
                                           stats).to(cuda).eval()
                         for v in (False, True))
            ref = logits_at(base, x32, size)
            got = logits_at(s2d, x32, size)
        rel, agree = _relative_gap(got, ref, 9)
        print("  pspfpnet s2d stem vs 7x7 stem (bench_ckpt.npz, float32, "
              "TF32 off): max abs %.3e over max |logit| %.3f = %.3e "
              "(limit %.0e); argmax agreement %.6f" % (
                  float((got - ref).abs().max()), float(ref.abs().max()),
                  rel, S2D_MAX_REL, agree), flush=True)
        return {"s2d_max_rel": rel, "s2d_argmax": agree,
                "s2d_finite": bool(torch.isfinite(got).all())}

    s2d = drive("zoo", forwards, ())
    bad = [r["arch"] for r in rows if not (
        r["finite"] and r["bf16_max_rel"] <= ZOO_BF16_MAX_REL
        and r["bf16_argmax"] >= ZOO_BF16_ARGMAX)]
    if bad:
        raise AssertionError("zoo: bf16 vs float32 gates failed for %s"
                             % bad)
    if not (s2d["s2d_finite"] and s2d["s2d_max_rel"] <= S2D_MAX_REL):
        raise AssertionError("s2d stem differs from the 7x7: %s" % s2d)
    return {"archs": rows, **s2d}


def class_inference_phase(drive, smi, sw):
    """PSPNet-r101 at the released Cityscapes configuration: a synthetic
    caffemodel (the released naming, every tensor at full size, weights
    from a seeded PSPNet with positive batch-norm statistics) written to
    _build/, converted (`caffemodel_to_npz`) and loaded
    (`apply_caffe_weights`) into a fresh model, every tensor bit-equal;
    then `class_inference` with `tile_predict` (713^2 windows, flips, 19
    classes remapped to 9) over the 4 bench images upscaled to
    1024x2048, in bf16 and float32 (TF32 off); the saved maps read back
    and gated.  No decode kernel may launch."""
    import shutil

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mergenet_tpu_torch.models import get_model, init_model, tile_predict
    from mergenet_tpu_torch.models.tiling import _tile_grid
    from mergenet_tpu_torch.parallel import train as T
    from mergenet_tpu_torch.timing import median_ms
    from mergenet_tpu_torch.utils.caffe_import import caffemodel_to_npz
    from mergenet_tpu_torch.utils.inference_utils import class_inference
    from mergenet_tpu_torch.utils.weight_import import apply_caffe_weights

    cuda = torch.device("cuda")
    work = os.path.join(HERE, "mergenet_tpu_torch", "_build", "class_infer")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {"config": {"model": "PSPNet-r101", "classes":
                      CLASS_MODEL_CLASSES, "instance_classes":
                      CLASS_INSTANCE_CLASSES, "window": CLASS_WINDOW,
                      "flip": True}}
    try:
        t = time.perf_counter()
        src = randomize_batch_norm(init_model(get_model(
            CLASS_MODEL_CLASSES, 0, "pspnet"), 7), 8)
        out["init_s"] = time.perf_counter() - t
        cm = os.path.join(work, "pspnet101_synthetic.caffemodel")
        with sw.span("caffe write"):
            out["caffemodel_bytes"] = write_pspnet_caffemodel(cm, src, 101)
        with sw.span("caffe to npz"):
            names = caffemodel_to_npz(cm, os.path.join(work, "w.npz"))
        os.unlink(cm)
        model = get_model(CLASS_MODEL_CLASSES, 0, "pspnet")
        with sw.span("caffe apply"):
            with np.load(os.path.join(work, "w.npz")) as npz:
                report = apply_caffe_weights(model, npz, layer=101)
        os.unlink(os.path.join(work, "w.npz"))
        ref = src.state_dict()
        unequal = [k for k, v in model.state_dict().items()
                   if not torch.equal(v, ref[k])]
        out["caffe"] = {"bytes": out.pop("caffemodel_bytes"),
                        "npz_keys": len(names),
                        "layers_loaded": len(report["loaded"]),
                        "unused_npz_keys": report["unused_npz_keys"],
                        "tensors": len(ref), "tensors_unequal": unequal,
                        "params": sum(p.numel() for p in src.parameters())}
        print("  synthetic caffemodel: %d bytes, %d blobs, %d layers "
              "loaded, %d parameters; unused npz keys %s; tensors "
              "unequal to their source: %d of %d (write %.2f s, convert "
              "%.2f s, apply %.2f s)" % (
                  out["caffe"]["bytes"], len(names), len(report["loaded"]),
                  out["caffe"]["params"], report["unused_npz_keys"],
                  len(unequal), len(ref), sw.totals["caffe write"],
                  sw.totals["caffe to npz"], sw.totals["caffe apply"]),
              flush=True)
        if unequal or report["unused_npz_keys"]:
            raise AssertionError("caffemodel round trip: %s" % out["caffe"])
        del src, ref

        model = model.to(cuda).eval()
        mean = np.asarray(CAFFE_MEAN_RGB, np.float32)
        loader = [(np.array([i]), (upscale2(img).astype(np.float32)
                                   - mean)[None, :, :, ::-1].copy())
                  for i, img in enumerate(bench_images())]
        tx = T.make_optimizer()
        runs = {}

        def tile_fn(m):
            @torch.no_grad()
            def fn(img):
                return tile_predict(m, img, CLASS_INSTANCE_CLASSES,
                                    CLASS_WINDOW,
                                    n_model_classes=CLASS_MODEL_CLASSES)
            return fn

        def bf16():
            return _twin(lambda: get_model(CLASS_MODEL_CLASSES, 0, "pspnet",
                                           dtype=torch.bfloat16), model)

        frame = loader[0][1].shape[1:3]  # 1024x2048
        windows = 2 * len(_tile_grid(frame[0], CLASS_WINDOW[0])) * len(
            _tile_grid(frame[1], CLASS_WINDOW[1]))

        def infer_all():
            for name, m in (("bf16", bf16()), ("float32", model)):
                state = T.TrainState(step=0, model=m, optimizer=tx.init(
                    model.parameters()), tx=tx)
                torch.cuda.reset_peak_memory_stats()
                with sw.span("class inference " + name, sync=cuda):
                    class_inference(loader, os.path.join(work, name), state,
                                    CLASS_INSTANCE_CLASSES, 1, print_freq=1,
                                    tile_predict_fn=tile_fn(m))
                span = sw.totals["class inference " + name]
                runs[name] = {"ms_per_image": span / len(loader) * 1e3,
                              "windows_per_s": windows * len(loader) / span,
                              "peak_bytes":
                                  torch.cuda.max_memory_allocated()}
            img = torch.from_numpy(loader[0][1]).to(cuda)
            for name, m in (("bf16", bf16()), ("float32", model)):
                # the tiled forward alone, warm: no first-call set-up, no
                # host copy or file write
                runs[name]["tiled_forward_ms"] = median_ms(
                    lambda: tile_fn(m)(img), reps=3)
            runs["bf16"]["device_busy_ms"], runs["bf16"]["top_ops_ms"] = \
                top_device_ops(lambda: tile_fn(bf16())(img))
            with FlopCounterMode(display=False) as fc:
                tile_fn(bf16())(img)
            return fc.get_total_flops()

        flops = drive("class inference", infer_all, ())
        maps = {name: [np.load(os.path.join(work, name, "npy",
                                            "%d.class.npy" % i))
                       for i in range(len(loader))] for name in runs}
        shape_ok = all(a.dtype == np.float32 and a.shape == (
            CLASS_INSTANCE_CLASSES,) + frame for v in maps.values()
            for a in v)
        sum_err = max(float(np.abs(a.sum(0, dtype=np.float64) - 1).max())
                      for v in maps.values() for a in v)
        m16, m32 = (torch.from_numpy(np.stack(maps[k])).movedim(1, -1)
                    for k in ("bf16", "float32"))
        max_abs, agree = _relative_gap(m16, m32, CLASS_INSTANCE_CLASSES)
        mean_abs = float((m16 - m32).abs().mean())
        out.update(runs)
        out["config"]["frame"] = list(frame)
        share = {k: flops / (runs["bf16"][k] / 1e3) / H100_BF16_DENSE_FLOPS
                 for k in ("ms_per_image", "tiled_forward_ms")}
        out.update({"flops_per_image": flops, "windows_per_image": windows,
                    "bf16_peak_share": share["ms_per_image"],
                    "bf16_forward_peak_share": share["tiled_forward_ms"],
                    "maps_shape_ok": shape_ok, "sum_max_err": sum_err,
                    "bf16_max_abs": max_abs, "bf16_mean_abs": mean_abs,
                    "bf16_argmax": agree})
        for name, r in runs.items():
            print("  %s: %.1f ms per %dx%d image through class_inference "
                  "(%d windows of %dx%d, flips included; the tiled forward "
                  "alone, warm: %.1f ms), %.1f windows/s, peak %.2f GB (%s)"
                  % (name, r["ms_per_image"], frame[0], frame[1], windows,
                     CLASS_WINDOW[0],
                     CLASS_WINDOW[1], r["tiled_forward_ms"],
                     r["windows_per_s"], r["peak_bytes"] / 1e9, smi),
                  flush=True)
        print("  bf16 tiled forward, device busy %.1f ms; top ops (self "
              "device ms): %s" % (runs["bf16"]["device_busy_ms"],
                                  runs["bf16"]["top_ops_ms"]), flush=True)
        print("  %.4g FLOPs per image (FlopCounterMode); bf16 at %.4f of the "
              "dense bf16 peak through class_inference, %.4f in the tiled "
              "forward alone; maps (9, H, W) float32: %s; per-pixel "
              "sums within %.1e of 1 (limit %.0e); bf16 vs float32 maps: "
              "mean abs %.2e (limit %.2f), max abs %.3f, argmax %.5f "
              "(limit %.2f)" % (
                  flops, out["bf16_peak_share"],
                  out["bf16_forward_peak_share"], shape_ok, sum_err,
                  CLASS_SUM_TOL, mean_abs, CLASS_BF16_MEAN_ABS, max_abs,
                  agree, CLASS_BF16_ARGMAX), flush=True)
        if not (shape_ok and sum_err <= CLASS_SUM_TOL
                and mean_abs <= CLASS_BF16_MEAN_ABS
                and agree >= CLASS_BF16_ARGMAX):
            raise AssertionError("class inference maps failed their gates")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def staged_phase(drive, smi, sw):
    """The staged inference of `infer_pspfpnet.sh` stages 0-2 (class and
    offset heads -> saved maps -> `segment.py --decoder device`):
    `class_inference` and `offset_inference` of PSPFPNet-r50 with the
    committed trained weights on the 4 bench images (512x1024, /256),
    the saved maps read back and decoded by
    `run_segmentation_device(mode="hier")` on the card and on the CPU,
    held to the decode gates; mask-AP against val_ann.json as a
    reading."""
    import shutil

    import numpy as np
    import torch

    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.data import COCO
    from mergenet_tpu_torch.decoder.device import run_segmentation_device
    from mergenet_tpu_torch.e2e import masks_to_results
    from mergenet_tpu_torch.models import PSPFPNet
    from mergenet_tpu_torch.parallel import train as T
    from mergenet_tpu_torch.utils.inference_utils import (class_inference,
                                                          offset_inference)

    cuda = torch.device("cuda")
    C = 9
    offsets = io.load_offsets(FIX)
    params, stats = io.load_bench_checkpoint(os.path.join(FIX,
                                                          "bench_ckpt.npz"))
    model = load_flax_weights(PSPFPNet(C + len(offsets)), params,
                              stats).to(cuda).eval()
    tx = T.make_optimizer()
    state = T.TrainState(step=0, model=model,
                         optimizer=tx.init(model.parameters()), tx=tx)
    imgs = [img.astype(np.float32) / 256.0 for img in bench_images()]
    loader = [(np.array([0, 1]), np.stack(imgs[:2])),
              (np.array([2, 3]), np.stack(imgs[2:]))]
    work = os.path.join(HERE, "mergenet_tpu_torch", "_build", "staged")
    shutil.rmtree(work, ignore_errors=True)
    masks = {}

    def maps(i):
        return (np.load(os.path.join(work, "class", "npy",
                                     "%d.class.npy" % i)),
                np.load(os.path.join(work, "offset", "npy",
                                     "%d.offset.npy" % i)))

    def card_path():
        with sw.span("staged heads", sync=cuda):
            class_inference(loader, os.path.join(work, "class"), state, C, 2)
            offset_inference(loader, os.path.join(work, "offset"), state,
                             offsets, 2)
        with sw.span("staged card decode", sync=cuda):
            for i in range(4):
                masks[i] = run_segmentation_device(*maps(i), C, offsets,
                                                   mode="hier", **SERVE_KW)

    try:
        drive("staged", card_path, ("floodscan", "absorb", "tgather"))
        checks, results = [], []
        coco = COCO(os.path.join(FIX, "val_ann.json"))
        cats = [0] + coco.getCatIds()
        with sw.span("staged cpu decode"):
            for i in range(4):
                cp, sp = maps(i)
                hw = imgs[i].shape[:2]  # 512x1024
                if cp.shape != (C,) + hw or sp.shape != (
                        len(offsets),) + hw or cp.dtype != np.float32:
                    raise AssertionError("staged maps: %s %s %s" % (
                        cp.shape, sp.shape, cp.dtype))
                ref, _ = run_segmentation_device(cp, sp, C, offsets,
                                                 mode="hier", device="cpu",
                                                 **SERVE_KW)
                mask, classes = masks[i]
                checks.append(check_decode("staged image %d" % i, mask,
                                           ref))
                results += masks_to_results(
                    mask[None], np.asarray(list(classes) + [-1],
                                           np.int32)[None], [i], cats)
        ap, ap50 = coco_stats(coco, results, [0, 1, 2, 3])[:2]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("  staged: heads %.2f s, card decodes %.2f s, CPU decodes %.2f s "
          "for 4 images; mask-AP %.4f, AP50 %.4f over the 4 images "
          "(port's COCOeval, a reading) (%s)" % (
              sw.totals["staged heads"], sw.totals["staged card decode"],
              sw.totals["staged cpu decode"], ap, ap50, smi), flush=True)
    return {"checks": checks, "mask_ap": ap, "mask_ap50": ap50}


def train_aux_phase(drive, smi, sw):
    """PSPNet-r101 with its aux head at the recipe's configuration (batch
    16, 768^2 crops, alpha 20) and aux_weight 0.4 in bf16: first one
    step at batch 2, 256^2 (float32, TF32 off) on the card against the
    CPU with the same dropout masks (drawn on the CPU, moved to the
    card); then TRAIN_AUX_STEPS compact steps with a seeded dropout
    generator on the card, without remat if they fit (else with it, and
    said so): finite losses, `aux_loss` reported, no decode kernel."""
    import statistics

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.models import get_model
    from mergenet_tpu_torch.models.layers import Dropout
    from mergenet_tpu_torch.parallel import train as T

    C = 9
    offsets = io.load_offsets(FIX)
    tx = T.make_optimizer(lr=0.01, momentum=0.9, nesterov=True,
                          weight_decay=1e-4)
    batch, _ = train_data(np.random.default_rng(0))
    args = ("image", "mask", "object_class")

    # -- card against CPU, one step, the same dropout masks -------------
    small = {k: v[:2, :256, :256] if v.ndim > 2 else v[:2]
             for k, v in batch.items()}
    drawn = []
    res = {}
    for dev in ("cpu", "cuda"):
        state = T.create_train_state(get_model(C, len(offsets), "pspnet"),
                                     tx, seed=3, device=dev)
        drops = [m for m in state.model.modules() if isinstance(m, Dropout)]
        for i, d in enumerate(drops):
            if dev == "cpu":  # draw from the CPU generator, keep them
                d.mask = (lambda orig: lambda x: drawn.append(orig(x))
                          or drawn[-1])(d.mask)
            else:  # the same masks, moved to the card
                d.mask = lambda x, i=i: drawn[i].to(x.device)
        step = T.build_train_step_compact(C, offsets, alpha=TRAIN_ALPHA,
                                          aux_weight=TRAIN_AUX_WEIGHT)
        state, m = step(state, *(small[k] for k in args),
                        torch.Generator(device=dev).manual_seed(4))
        res[dev] = (float(m["loss"]), float(m["aux_loss"]))
        del state
    loss_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    aux_rel = abs(res["cuda"][1] - res["cpu"][1]) / abs(res["cpu"][1])
    print("  card vs cpu, one aux step at batch 2, 256^2 (TF32 off, the "
          "same %d dropout masks): loss %.6f / %.6f (rel %.2e, limit %.0e),"
          " aux loss %.6f / %.6f (rel %.2e)" % (
              len(drawn), res["cuda"][0], res["cpu"][0], loss_rel,
              TRAIN_LOSS_RTOL, res["cuda"][1], res["cpu"][1], aux_rel),
          flush=True)
    if len(drawn) != 2 or loss_rel > TRAIN_LOSS_RTOL:
        raise AssertionError("aux train step: card disagrees with the CPU")

    # -- the main path: compact steps in bf16 ----------------------------
    dev_batch = [torch.from_numpy(batch[k]).cuda() for k in args]
    out = {"card_vs_cpu": {"loss_card": res["cuda"][0],
                           "loss_cpu": res["cpu"][0], "loss_rel": loss_rel,
                           "aux_card": res["cuda"][1],
                           "aux_cpu": res["cpu"][1], "aux_rel": aux_rel}}

    def run(remat):
        state = T.create_train_state(get_model(
            C, len(offsets), "pspnet", dtype=torch.bfloat16), tx, seed=0)
        step = T.build_train_step_compact(
            C, offsets, alpha=TRAIN_ALPHA, aux_weight=TRAIN_AUX_WEIGHT,
            remat=remat)
        rng = torch.Generator(device="cuda").manual_seed(0)
        losses, auxes, times = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TRAIN_AUX_STEPS):
            with sw.span("train aux step", sync=torch.device("cuda")):
                t = time.perf_counter()
                state, m = step(state, *dev_batch, rng)
                losses.append(float(m["loss"]))
                auxes.append(float(m["aux_loss"]))
                times.append((time.perf_counter() - t) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        with FlopCounterMode(display=False) as fc:
            step(state, *dev_batch, rng)
        busy, top = top_device_ops(lambda: step(state, *dev_batch, rng))
        ms = statistics.median(times[TRAIN_AUX_WARMUP:])
        return {"remat": remat, "losses": losses, "aux_losses": auxes,
                "steps_ms": times, "step_ms": ms,
                "images_per_s": TRAIN_BATCH / ms * 1e3, "peak_bytes": peak,
                "flops_per_step": fc.get_total_flops(),
                "device_busy_ms": busy, "top_ops_ms": top}

    def main_path():
        try:
            return run(False)
        except torch.cuda.OutOfMemoryError:
            pass  # leaving the handler frees the failed run's tensors
        torch.cuda.empty_cache()
        return run(True)

    r = drive("train aux", main_path, ())
    r["bf16_peak_share"] = r["flops_per_step"] / (r["step_ms"] / 1e3) \
        / H100_BF16_DENSE_FLOPS
    out.update(r)
    print("  bf16, batch %d, %d^2, remat %s: losses %s, aux losses %s; step "
          "%.1f ms (median after %d warm-up), %.2f images/s, peak %.2f GB, "
          "%.4g FLOPs per step, %.4f of the dense bf16 peak (%s)" % (
              TRAIN_BATCH, TRAIN_CROP, r["remat"],
              ["%.4f" % v for v in r["losses"]],
              ["%.4f" % v for v in r["aux_losses"]], r["step_ms"],
              TRAIN_AUX_WARMUP, r["images_per_s"], r["peak_bytes"] / 1e9,
              r["flops_per_step"], r["bf16_peak_share"], smi), flush=True)
    print("  one profiled step: device busy %.1f ms; top ops (self device "
          "ms): %s" % (r["device_busy_ms"], r["top_ops_ms"]), flush=True)
    if not (np.all(np.isfinite(r["losses"]))
            and np.all(np.isfinite(r["aux_losses"]))
            and min(r["aux_losses"]) > 0):
        raise AssertionError("aux train steps: losses %s, aux %s"
                             % (r["losses"], r["aux_losses"]))
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from mergenet_tpu_torch import bench_pallas_gather, e2e, io, serving
    from mergenet_tpu_torch.timing import card, eager_ms, graph_ms, median_ms
    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.decoder import device as D
    from mergenet_tpu_torch.models import PSPFPNet, logits_at, probs_at
    from mergenet_tpu_torch.ops import (_build, absorb, floodscan, pgather,
                                        tgather)
    from mergenet_tpu_torch.utils import profiling

    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(LIMIT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda")

    # ---- 1. card ----
    phase("card")
    smi = card()
    kind = torch.cuda.get_device_name(0)
    print("  nvidia-smi: %s | torch %s CUDA %s | python %s"
          % (smi, torch.__version__, torch.version.cuda,
             sys.version.split()[0]), flush=True)

    # ---- 2. build ----
    phase("build")
    stale = _build.library_path()
    if os.path.exists(stale):  # measure the real build every run
        os.unlink(stale)
    _build.library()
    print("  nvcc: %d sources, one nvcc each in parallel, then a link, "
          "%.2f s -> %s"
          % (len(_build.sources()), _build.build_seconds,
             os.path.relpath(_build.library_path(), HERE)), flush=True)

    # ---- 3. kernels against their plain versions, at the slice's shapes --
    phase("kernels vs plain versions")
    offsets = io.load_offsets(FIX)
    cp, sp = io.load_probs(FIX, 0)
    num_classes = cp.shape[-1]
    O = len(offsets)
    cp_d = torch.from_numpy(cp).to(cuda)
    sp_d = torch.from_numpy(sp).to(cuda)
    omf = float(np.float32(1.0))
    bias = float(np.float32(0.03))
    cls_lp_pix, log_odds = D._log_domain(cp_d, sp_d, 0.0)
    argmax_pix = torch.argmax(cls_lp_pix, dim=-1)
    H, W = argmax_pix.shape
    N = H * W
    ccl = 3
    h_links, v_links = D._flood_links(argmax_pix, log_odds, offsets, "sum",
                                      omf, bias, 2.0)
    h_S, s = h_links[0].contiguous(), h_links[1]
    v_S, t = v_links[0].contiguous(), v_links[1]
    results = {}

    def measure(kernel, plain, library=None):
        """Device ms per call from CUDA-graph replay (host launch
        overhead excluded) for the kernel, its plain version and the
        library call, plus the kernel's eager per-call ms."""
        return dict(ms=graph_ms(kernel),
                    call_ms=eager_ms(kernel),
                    plain_ms=graph_ms(plain, iters=5),
                    library_ms=(None if library is None
                                else graph_ms(library)))

    k = floodscan.flood_scan(h_S, v_S, s, t, ccl)
    p = floodscan.flood_scan_plain(h_S, v_S, s, t, ccl)
    torch.cuda.synchronize()
    b_ms, b_by = bound(2 * N + 4 * N, 2 * 4 * ccl * N)
    results["floodscan"] = dict(
        equal=bool(torch.equal(k, p)),
        max_abs_err=float((k - p).abs().max()),
        bound_ms=b_ms, bound_by=b_by,
        shape="(%d, %d) s=%d t=%d ccl=%d" % (H, W, s, t, ccl),
        **measure(lambda: floodscan.flood_scan(h_S, v_S, s, t, ccl),
                  lambda: floodscan.flood_scan_plain(h_S, v_S, s, t, ccl)))

    flood_extra = []
    rng = np.random.default_rng(0)
    for (fh, fw, fs, ft, fc) in FLOOD_SHAPES:
        lh = torch.from_numpy(rng.random((fh, fw)) < 0.93).to(cuda)
        lv = torch.from_numpy(rng.random((fh, fw)) < 0.93).to(cuda)
        for hh, vv, planes in ((lh, lv, "h+v"), (lh, None, "h"),
                               (None, lv, "v")):
            eq = bool(torch.equal(
                floodscan.flood_scan(hh, vv, fs, ft, fc),
                floodscan.flood_scan_plain(hh, vv, fs, ft, fc)))
            flood_extra.append(dict(shape="(%d, %d) s=%d t=%d ccl=%d %s"
                                    % (fh, fw, fs, ft, fc, planes),
                                    equal=eq))
    results["floodscan"]["shapes"] = flood_extra

    label = D._flood_fill(argmax_pix, log_odds, offsets, "sum", omf, bias,
                          ccl, 2.0)
    M = 65536
    comp2d, cls_lp, size, frozen, _, runs = D._densify_stats(
        label, cls_lp_pix, M, return_runs=True)
    packed, = D.absorb_stats(cls_lp, size, frozen, True)
    packed_own = D._run_apply(packed, runs[1], comp2d, runs).contiguous()
    comp2d = comp2d.contiguous()
    kp, kq = absorb.absorb_best_edges(comp2d, packed_own, log_odds, offsets,
                                      1.0, 64)
    pp, pq = absorb.absorb_plain(comp2d, packed_own, log_odds, offsets,
                                 1.0, 64)
    torch.cuda.synchronize()
    b_ms, b_by = bound((4 + 4 + 4 + 4) * N + 4 * absorb_needed_log_odds(
        comp2d, packed_own, offsets, 64), 2 * O * 24 * N)
    results["absorb"] = dict(
        equal=bool(torch.equal(kp, pp) and torch.equal(kq, pq)),
        max_abs_err=max(float((kp - pp).abs().max()),
                        float((kq - pq).abs().max())),
        bound_ms=b_ms, bound_by=b_by,
        shape="(%d, %d) O=%d theta=1.0 cap=64" % (H, W, O),
        **measure(lambda: absorb.absorb_best_edges(
            comp2d, packed_own, log_odds, offsets, 1.0, 64),
            lambda: absorb.absorb_plain(comp2d, packed_own, log_odds,
                                        offsets, 1.0, 64)))
    # the same scan on unpacked stats (the C > 16 layout), same inputs
    clsfz_own, size_own = (t[comp2d].contiguous() for t in D.absorb_stats(
        cls_lp, size, frozen, False))
    ku, kuq = absorb.absorb_best_edges_unpacked(
        comp2d, clsfz_own, size_own, log_odds, offsets, 1.0, 64)
    torch.cuda.synchronize()
    results["absorb"]["unpacked"] = dict(
        equal=bool(torch.equal(ku, pp) and torch.equal(kuq, pq)),
        ms=graph_ms(lambda: absorb.absorb_best_edges_unpacked(
            comp2d, clsfz_own, size_own, log_odds, offsets, 1.0, 64)))

    absorb_extra = []
    arng = np.random.default_rng(7)
    for (ah, aw, aoffs, afroz, aties, asz) in ABSORB_SHAPES:
        planes = [torch.from_numpy(a).to(cuda) for a in absorb_planes(
            arng, ah, aw, len(aoffs), frozen=afroz, ties=aties,
            size_hi=asz)]
        acomp, asize, aargc, afz, alo = planes
        apk = (asize << 5) | (aargc << 1) | afz
        eq_p = all(torch.equal(a, b) for a, b in zip(
            absorb.absorb_best_edges(acomp, apk, alo, aoffs, 1.0, 64),
            absorb.absorb_plain(acomp, apk, alo, aoffs, 1.0, 64)))
        eq_u = all(torch.equal(a, b) for a, b in zip(
            absorb.absorb_best_edges_unpacked(
                acomp, (aargc << 1) | afz, asize, alo, aoffs, 1.0, 64),
            absorb.absorb_plain_unpacked(acomp, aargc, asize, afz == 1,
                                         alo, aoffs, 1.0, 64)))
        absorb_extra.append(dict(
            shape="(%d, %d) O=%d offsets %s frozen %.2f %s, sizes < %d"
            % (ah, aw, len(aoffs), list(aoffs), afroz,
               "quantised log-odds" if aties else "gaussian log-odds", asz),
            equal=eq_p, equal_unpacked=eq_u))
    results["absorb"]["shapes"] = absorb_extra

    tg = {}
    for m in (16384, 65536, 131072, N):  # N: the exact path's tables
        table = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, m)
                                 .astype(np.int32)).to(cuda)
        idx = torch.from_numpy(rng.integers(-m - 4096, m + 4096, N)
                               .astype(np.int32)).to(cuda)
        kg = tgather.table_gather(table, idx)
        pg = tgather.table_gather_plain(table, idx)
        torch.cuda.synchronize()
        idx_c = torch.where(idx < 0, idx + m, idx).clamp(0, m - 1).long()
        b_ms, b_by = bound(4 * m + 8 * N, 4 * N)
        tg[m] = dict(
            equal=bool(torch.equal(kg, pg)),
            max_abs_err=float((kg.long() - pg.long()).abs().max()),
            bound_ms=b_ms, bound_by=b_by,
            **measure(lambda: tgather.table_gather(table, idx),
                      lambda: tgather.table_gather_plain(table, idx),
                      lambda: torch.take(table, idx_c)))
    # the decoder's own indices: the run-budget overflow branch's
    # (comp2d_s1 into the packed stats) and relabel_mask's (the final
    # component grid into the instance ids)
    comp_f, root_class, is_root = D.decode_hierarchical(
        cp_d, sp_d, num_classes, offsets, object_merge_factor=1.0,
        merge_logprob_bias=0.03)
    ids, _ = D._instance_tables(root_class, is_root)
    tg_own = {}
    for name, table, idx in (
            ("overflow comp2d_s1", packed.contiguous(), comp2d.reshape(-1)),
            ("relabel label", ids.contiguous(),
             comp_f.reshape(-1).to(torch.int32).contiguous())):
        kg = tgather.table_gather(table, idx)
        pg = tgather.table_gather_plain(table, idx)
        idx_l = idx.long()  # in range: what torch.take needs
        torch.cuda.synchronize()
        m = table.numel()
        b_ms, b_by = bound(4 * m + 8 * N, 4 * N)
        tg_own[name] = dict(
            M=m, equal=bool(torch.equal(kg, pg)),
            max_abs_err=float((kg.long() - pg.long()).abs().max()),
            bound_ms=b_ms, bound_by=b_by,
            **measure(lambda: tgather.table_gather(table, idx),
                      lambda: tgather.table_gather_plain(table, idx),
                      lambda: torch.take(table, idx_l)))
    results["tgather"] = dict(tg[65536], shape="M=65536 N=%d" % N,
                              sizes={str(m): v for m, v in tg.items()},
                              decoder_indices=tg_own)

    pg = {}
    for m in bench_pallas_gather.SIZES:
        table = torch.from_numpy(rng.integers(0, 2 ** 30, m)
                                 .astype(np.int32)).to(cuda)
        idx = torch.from_numpy(rng.integers(0, m, N)
                               .astype(np.int32)).to(cuda)
        kg = pgather.pgather(table, idx)
        pgp = pgather.pgather_plain(table, idx)
        torch.cuda.synchronize()
        b_ms, b_by = bound(4 * m + 8 * N, N)
        pg[m] = dict(
            equal=bool(torch.equal(kg, pgp)),
            max_abs_err=float((kg.long() - pgp.long()).abs().max()),
            bound_ms=b_ms, bound_by=b_by,
            **measure(lambda: pgather.pgather(table, idx),
                      lambda: pgather.pgather_plain(table, idx),
                      lambda: table[idx]))
    # every size, bit-equal on out-of-range indices with N not a
    # multiple of 4, through the kernel's int4 branch (aligned, with a
    # scalar tail) and its scalar branch (indices 4 bytes off alignment)
    pg_sizes = []
    n_odd = N + 3
    for m in PGATHER_SIZES:
        table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, m)
                                 .astype(np.int32)).to(cuda)
        idx = torch.from_numpy(rng.integers(-m // 8, m + m // 8 + 1, n_odd)
                               .astype(np.int32)).to(cuda)
        idx[:2] = torch.tensor([-2 ** 31, 2 ** 31 - 1], dtype=torch.int32)
        for ix in (idx, idx[1:]):
            branch = ("int4" if table.data_ptr() % 16 == 0
                      and ix.data_ptr() % 16 == 0 else "scalar")
            eq = bool(torch.equal(pgather.pgather(table, ix),
                                  pgather.pgather_plain(table, ix)))
            pg_sizes.append(dict(M=m, N=ix.numel(), equal=eq,
                                 branch=branch))
    pg_oob = all(r["equal"] for r in pg_sizes)
    results["pgather"] = dict(
        pg[65536], shape="M=65536 N=%d" % N,
        sizes={str(m): v for m, v in pg.items()},
        out_of_range_equal=pg_oob, branches=pg_sizes)
    for name, r in results.items():
        print("  %s %s: equal=%s max_abs_err=%g kernel %.4f ms (eager "
              "call %.4f ms), plain %.4f ms, library %s, bound %.4f ms "
              "(%s)" % (name, r["shape"], r["equal"], r["max_abs_err"],
                        r["ms"], r["call_ms"], r["plain_ms"],
                        "%.4f ms" % r["library_ms"]
                        if r["library_ms"] is not None else "none",
                        r["bound_ms"], r["bound_by"]), flush=True)
    for m, r in tg.items():
        print("  tgather M=%d: equal=%s kernel %.4f ms plain %.4f ms "
              "take %.4f ms" % (m, r["equal"], r["ms"], r["plain_ms"],
                                r["library_ms"]), flush=True)
        if not r["equal"]:
            raise AssertionError("tgather kernel != plain at M=%d" % m)
    for name, r in tg_own.items():
        print("  tgather on the decoder's %s (M=%d): equal=%s kernel %.4f "
              "ms plain %.4f ms take %.4f ms" % (
                  name, r["M"], r["equal"], r["ms"], r["plain_ms"],
                  r["library_ms"]), flush=True)
        if not r["equal"]:
            raise AssertionError("tgather kernel != plain on the %s" % name)
    r = results["absorb"]["unpacked"]
    print("  absorb unpacked stats (%d, %d) O=%d: equal=%s kernel %.4f ms"
          % (H, W, O, r["equal"], r["ms"]), flush=True)
    if not r["equal"]:
        raise AssertionError("absorb kernel != plain on unpacked stats")
    for r in absorb_extra:
        print("  absorb %s: equal=%s unpacked equal=%s"
              % (r["shape"], r["equal"], r["equal_unpacked"]), flush=True)
    if not all(r["equal"] and r["equal_unpacked"] for r in absorb_extra):
        raise AssertionError("absorb kernel != plain at a tiling shape")
    for m, r in pg.items():
        print("  pgather M=%d: equal=%s kernel %.4f ms (eager call %.4f "
              "ms) plain %.4f ms table[idx] %.4f ms bound %.4f ms"
              % (m, r["equal"], r["ms"], r["call_ms"], r["plain_ms"],
                 r["library_ms"], r["bound_ms"]), flush=True)
        if not r["equal"]:
            raise AssertionError("pgather kernel != plain at M=%d" % m)
    for r in pg_sizes:
        print("  pgather M=%d N=%d (out-of-range indices clamped): "
              "equal=%s, %s branch" % (r["M"], r["N"], r["equal"],
                                       r["branch"]), flush=True)
    if not pg_oob:
        raise AssertionError("pgather kernel != plain on a branch")
    for r in flood_extra:
        print("  floodscan %s: equal=%s" % (r["shape"], r["equal"]),
              flush=True)
    if not all(r["equal"] for r in flood_extra):
        raise AssertionError("floodscan kernel != plain at a tiling shape")
    for name, r in results.items():
        if not r["equal"]:
            raise AssertionError("%s kernel != its plain version" % name)

    paths = {}

    def drive(name, fn, needs):
        """Run one path with the launch counts set to 0 just before and
        read just after; every kernel in `needs` must have launched."""
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        paths[name] = dict(_build.LAUNCHES)
        print("  launches on the %s path: %s" % (name, paths[name]),
              flush=True)
        for k in needs:
            if paths[name].get(k, 0) < 1:
                raise AssertionError("the %s path launched no %s"
                                     % (name, k))
        return out

    # ---- 4. decode: card vs CPU on fixture 0 ----
    phase("decode fixture 0: card vs cpu")
    kw = dict(object_merge_factor=1.0, merge_logprob_bias=0.03,
              relabel=True, return_stats=True)
    _build.reset_launches()
    t = time.perf_counter()
    m_card, c_card, st_card = D.decode_hierarchical(cp_d, sp_d, num_classes,
                                                    offsets, **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t) * 1e3
    m_card2, c_card2, _ = D.decode_hierarchical(cp_d, sp_d, num_classes,
                                                offsets, **kw)
    if not (torch.equal(m_card, m_card2) and torch.equal(c_card, c_card2)):
        raise AssertionError("two card decodes of one input differ")
    m_cpu, _, st_cpu = D.decode_hierarchical(cp, sp, num_classes, offsets,
                                             device="cpu", **kw)
    print("  card decode %.1f ms (first call); stats card %s cpu %s; "
          "deterministic over 2 runs" % (
              first_ms, {k: int(v) for k, v in st_card.items()},
              {k: int(v) for k, v in st_cpu.items()}), flush=True)
    decode_check = check_decode("default", m_card.cpu().numpy(),
                                m_cpu.numpy())
    decode_launches = dict(_build.LAUNCHES)

    phase("decode fixture 0, run-budget overflow branch: card vs cpu")
    saved = D.RUN_SLOTS
    D.RUN_SLOTS = 1024  # the fixture has ~10k column runs
    try:
        _build.reset_launches()
        mo_card, _, _ = D.decode_hierarchical(cp_d, sp_d, num_classes,
                                              offsets, **kw)
        torch.cuda.synchronize()
        overflow_launches = dict(_build.LAUNCHES)
        mo_cpu, _, _ = D.decode_hierarchical(cp, sp, num_classes, offsets,
                                             device="cpu", **kw)
    finally:
        D.RUN_SLOTS = saved
    overflow_check = check_decode("overflow", mo_card.cpu().numpy(),
                                  mo_cpu.numpy())
    print("  launches: default %s, overflow %s"
          % (decode_launches, overflow_launches), flush=True)
    if overflow_launches.get("tgather", 0) < 1:
        raise AssertionError("the overflow decode launched no tgather")

    phase("decode fixture 0 with its classes widened to C=19: card vs cpu")
    cp19 = wide_classes(cp)
    m19, c19, st19 = drive("hier decode C=19", lambda: D.decode_hierarchical(
        torch.from_numpy(cp19).to(cuda), sp_d, 19, offsets, **kw),
        ("floodscan", "absorb"))
    m19_cpu, c19_cpu, st19_cpu = D.decode_hierarchical(
        cp19, sp, 19, offsets, device="cpu", **kw)
    c19_check = check_decode("C=19", m19.cpu().numpy(), m19_cpu.numpy())
    print("  C=19 stats card %s cpu %s; instance classes card %s"
          % ({k: int(v) for k, v in st19.items()},
             {k: int(v) for k, v in st19_cpu.items()},
             c19[:int(m19.max())].tolist()), flush=True)
    if int(c19.max()) < 16:  # the classes must not fit 4 bits
        raise AssertionError("C=19 decode found no class id past 15")

    # ---- 5. the served frame ----
    phase("frame: load weights, f32 vs bf16 net")
    params, batch_stats = io.load_bench_checkpoint(
        os.path.join(FIX, "bench_ckpt.npz"))
    num_outputs = num_classes + O
    net32 = load_flax_weights(PSPFPNet(num_outputs), params, batch_stats)
    img = io.read_png_rgb(os.path.join(FIX, "bench_img.png"))
    up = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(2, 0, 1)[None].float(),
        size=(1024, 2048), mode="bilinear", align_corners=False)
    img_full = up.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous().to(cuda)  # (1, 1024, 2048, 3)
    DH, DW = 512, 1024
    net32 = net32.to(cuda).eval()
    x32 = img_full.float() / 256.0
    with torch.no_grad():
        ref = logits_at(net32, x32, (DH, DW))
    del net32
    net16 = load_flax_weights(PSPFPNet(num_outputs).to(torch.bfloat16),
                              params, batch_stats)
    # the user entry point; it moves net16 to the card in bf16
    infer = e2e.build_e2e_infer(net16, num_classes, offsets,
                                decode_size=(DH, DW), dtype=torch.bfloat16)
    x16 = x32.to(torch.bfloat16)
    with torch.no_grad():
        lg16 = logits_at(net16, x16, (DH, DW))
    err = float((lg16 - ref).abs().max())
    agree = float((lg16[..., :num_classes].argmax(-1)
                   == ref[..., :num_classes].argmax(-1)).float().mean())
    print("  bf16 vs f32 logits (1, %d, %d, %d): max_abs_err %.4f "
          "(limit %.2f), class argmax agreement %.5f (limit %.2f)"
          % (DH, DW, num_outputs, err, BF16_MAX_ABS, agree,
             BF16_ARGMAX_AGREEMENT), flush=True)
    if not (err <= BF16_MAX_ABS and agree >= BF16_ARGMAX_AGREEMENT):
        raise AssertionError("bf16 net disagrees with its f32 forward")

    phase("frame: main path (served frames, launches counted)")
    _build.reset_launches()
    masks, classes = infer(x32)
    D.RUN_SLOTS = 1024  # a frame whose label grid overflows the run budget
    try:
        masks_o, classes_o = infer(x32)
    finally:
        D.RUN_SLOTS = saved
    torch.cuda.synchronize()
    main_launches = dict(_build.LAUNCHES)
    print("  launches on the main path: %s" % main_launches, flush=True)
    for name in ("floodscan", "absorb", "tgather"):
        if main_launches.get(name, 0) < 1:
            raise AssertionError("main path launched no %s" % name)
    mask = masks[0]
    K = int((classes[0] >= 0).sum())
    ids = torch.unique(mask).cpu().numpy()
    if (tuple(mask.shape) != (1024, 2048) or mask.dtype != torch.int32
            or K < 1 or not set(ids.tolist()) <= set(range(K + 1))
            or not set(range(1, K + 1)) <= set(ids.tolist())
            or int((classes[0][:K] < 1).sum()) != 0):
        raise AssertionError("malformed frame output: shape %s, %d "
                             "instances, ids %s" % (tuple(mask.shape), K,
                                                    ids[:20]))
    with torch.no_grad():
        lg = logits_at(net16, x16, (DH, DW))[0]
    m_frame_cpu, _ = D.decode_hierarchical(
        lg[..., :num_classes].cpu(), lg[..., num_classes:].cpu(),
        num_classes, offsets, object_merge_factor=1.0,
        merge_logprob_bias=0.03, relabel=True, from_logits=True,
        device="cpu")
    m_frame_card, _ = D.decode_hierarchical(
        lg[..., :num_classes], lg[..., num_classes:], num_classes, offsets,
        object_merge_factor=1.0, merge_logprob_bias=0.03, relabel=True,
        from_logits=True)
    frame_check = check_decode("frame", m_frame_card.cpu().numpy(),
                               m_frame_cpu.numpy())
    frame_overflow = check_decode("frame, overflow branch vs default",
                                  masks_o[0].cpu().numpy(),
                                  masks[0].cpu().numpy(),
                                  names=("overflow", "default"))

    phase("frame: timing (median of 5)")
    net_ms = median_ms(lambda: logits_at(net16, x16, (DH, DW)))
    dec_ms = median_ms(lambda: D.decode_hierarchical(
        lg[..., :num_classes], lg[..., num_classes:], num_classes, offsets,
        object_merge_factor=1.0, merge_logprob_bias=0.03, relabel=True,
        from_logits=True))
    frame_ms = median_ms(lambda: infer(x32))
    print("  frame 1024x2048 -> 512x1024 decode: %d instances; net %.2f ms, "
          "decode %.2f ms, frame %.2f ms (bf16, %s)"
          % (K, net_ms, dec_ms, frame_ms, smi), flush=True)

    paths["hier frame"] = main_launches

    # ---- 6. exact mode ----
    phase("exact decode fixture 0 (run_segmentation_device): card vs cpu")
    cf, sf = np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0)
    hyper = dict(object_merge_factor=1.0, merge_logprob_bias=0.03)
    t = time.perf_counter()
    me_card, ce_card, se_card = drive(
        "exact decode", lambda: D.run_segmentation_device(
            cf, sf, num_classes, offsets, mode="exact", return_stats=True,
            **hyper), ("tgather",))
    exact_first_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    me_cpu, ce_cpu, se_cpu = D.run_segmentation_device(
        cf, sf, num_classes, offsets, mode="exact", return_stats=True,
        device="cpu", **hyper)
    exact_cpu_ms = (time.perf_counter() - t) * 1e3
    print("  exact: classes card %s cpu %s; stats card %s cpu %s"
          % (ce_card, ce_cpu, se_card, se_cpu), flush=True)
    exact_check = check_decode("exact", me_card, me_cpu)
    if se_card != se_cpu:
        raise AssertionError("exact decode stats differ: card %s cpu %s"
                             % (se_card, se_cpu))
    exact_ms = median_ms(lambda: D.run_segmentation_device(
        cf, sf, num_classes, offsets, mode="exact", **hyper), reps=3)
    print("  exact decode of fixture 0 (512x1024): card %.1f ms (median "
          "of 3; first call %.1f ms), cpu %.1f ms" % (
              exact_ms, exact_first_ms, exact_cpu_ms), flush=True)

    phase("certification: hier and exact decodes of the 8 certification512 "
          "fixtures, mask-AP against the C++ greedy")
    t = time.perf_counter()
    cert = certify(drive)
    cert["phase_s"] = time.perf_counter() - t
    print("  certification phase %.2f s (%s)" % (cert["phase_s"], smi),
          flush=True)

    phase("exact frame (build_e2e_infer decode_mode='exact')")
    infer_exact = e2e.build_e2e_infer(net16, num_classes, offsets,
                                      decode_size=(DH, DW),
                                      dtype=torch.bfloat16,
                                      decode_mode="exact")
    masks_e, classes_e = drive("exact frame", lambda: infer_exact(x32),
                               ("tgather",))
    K_e = int((classes_e[0] >= 0).sum())
    if (tuple(masks_e.shape) != (1, 1024, 2048) or K_e < 1
            or int(masks_e.max()) != K_e):
        raise AssertionError("malformed exact frame: shape %s, %d classes, "
                             "max id %d" % (tuple(masks_e.shape), K_e,
                                            int(masks_e.max())))
    exact_frame_ms = median_ms(lambda: infer_exact(x32), reps=3)
    print("  exact frame 1024x2048: %d instances (hier frame %d); %.1f ms "
          "(median of 3, bf16, %s)" % (K_e, K, exact_frame_ms, smi),
          flush=True)

    # ---- 7. serving pipeline with the overflow fallback ----
    phase("serving: build_serving_pipeline(overflow_fallback=True), "
          "2 frames")
    img2 = io.read_png_rgb(os.path.join(FIX, "bench_img_1.png"))
    up2 = torch.nn.functional.interpolate(
        torch.from_numpy(img2).permute(2, 0, 1)[None].float(),
        size=(1024, 2048), mode="bilinear", align_corners=False)
    img2_full = up2.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).to(cuda)
    batch = torch.cat([img_full, img2_full]).float() / 256.0
    serve = serving.build_serving_pipeline(
        net16, num_classes, offsets, decode_size=(DH, DW),
        dtype=torch.bfloat16, overflow_fallback=True)
    tight = dict(max_components=4096, pair_components=1024,
                 pair_slots=1024, edge_slots=16384)
    serve_tight = serving.build_serving_pipeline(
        net16, num_classes, offsets, decode_size=(DH, DW),
        dtype=torch.bfloat16, hier_kwargs=tight, overflow_fallback=True)
    sm, sc, sov = drive("serving", lambda: serve(batch),
                        ("floodscan", "absorb"))
    sov = sov.tolist()
    if sov[0] != 0:
        raise AssertionError("certified capacities overflowed on frame 0: "
                             "%s" % sov)
    if not torch.equal(sm[0], masks[0]):
        raise AssertionError("served frame 0 != the e2e hier frame")
    tm_, tc_, tov = drive("serving fallback", lambda: serve_tight(batch),
                          ("floodscan", "absorb", "tgather"))
    tov = tov.tolist()
    if min(tov) < 1:
        raise AssertionError("tight capacities did not overflow: %s" % tov)
    fallback_equal = []
    with torch.no_grad():
        for b in range(2):
            small = probs_at(net16, batch[b:b + 1].to(torch.bfloat16),
                             (DH, DW))[0]
            em, ecls = D.run_segmentation_device(
                small[..., :num_classes].movedim(-1, 0),
                small[..., num_classes:].movedim(-1, 0), num_classes,
                offsets, mode="exact", **hyper)
            full = e2e.upsample_nearest(torch.as_tensor(em, device=cuda),
                                        (1024, 2048))
            fallback_equal.append(
                bool(torch.equal(tm_[b], full))
                and tc_[b][:len(ecls)].tolist() == ecls
                and bool((tc_[b][len(ecls):] == -1).all()))
    print("  overflow counts: certified %s, tight %s; tight frames equal "
          "to their exact decode upsampled: %s" % (sov, tov,
                                                   fallback_equal),
          flush=True)
    if not all(fallback_equal):
        raise AssertionError("a fallback frame differs from its exact "
                             "decode")
    serve_ms = median_ms(lambda: serve(batch), reps=3)
    serve_tight_ms = median_ms(lambda: serve_tight(batch), reps=1)
    print("  serve 2 frames: certified %.1f ms (median of 3), all-fallback "
          "%.1f ms (bf16, %s)" % (serve_ms, serve_tight_ms, smi), flush=True)

    # ---- 8. the gather bench ----
    phase("gather bench (python -m mergenet_tpu_torch.bench_pallas_gather)")
    bench_rows = drive("gather bench", bench_pallas_gather.main,
                       ("pgather",))
    if not all(r["correct"] for r in bench_rows):
        raise AssertionError("gather bench: pgather != table[idx]")

    # ---- 9. training ----
    phase("train: PSPFPNet-r50, batch %d, %d^2 crops, alpha %g, float32 "
          "and bf16" % (TRAIN_BATCH, TRAIN_CROP, TRAIN_ALPHA))
    sources = {"floodscan": "floodscan.cu", "absorb": "absorb.cu",
               "tgather": "tgather.cu", "pgather": "pgather.cu"}
    train = train_phase(drive, paths, smi, tuple(sources))
    print("train " + json.dumps({
        "card": smi, "config": train["config"],
        **{name: {k: train[name][k] for k in (
            "step_ms", "images_per_s", "peak_bytes", "remat", "losses")}
           for name in ("float32", "bf16")},
        "tf32": train["float32"]["tf32"],
        "flops_per_step": train["flops_per_step"],
        "bf16_peak_share": train["bf16_peak_share"],
        "bf16_peak_flops": H100_BF16_DENSE_FLOPS,
        "launches": paths["train"], "phase_s": train["phase_s"]}),
        flush=True)

    # ---- 10. the rest of the zoo, tiled class inference, the staged
    # inference and the aux head's train steps ----
    sw = profiling.Stopwatch()
    phase("zoo: every family at full width on a 1024x2048 frame, bf16 and "
          "float32; the s2d stem")
    zoo = zoo_phase(drive, smi, sw)
    print("zoo " + json.dumps({"card": smi, **zoo}), flush=True)
    phase("class inference: PSPNet-r101 from a synthetic caffemodel, "
          "713x713 windows with flips over 1024x2048 frames")
    cls_inf = class_inference_phase(drive, smi, sw)
    print("class_inference " + json.dumps({"card": smi, **cls_inf}),
          flush=True)
    phase("staged inference: PSPFPNet-r50 class and offset heads -> saved "
          "maps -> run_segmentation_device(mode='hier')")
    staged = staged_phase(drive, smi, sw)
    print("staged " + json.dumps({"card": smi, **staged}), flush=True)
    phase("train: PSPNet-r101 with the aux head, batch %d, %d^2 crops, "
          "aux_weight %g, bf16" % (TRAIN_BATCH, TRAIN_CROP,
                                   TRAIN_AUX_WEIGHT))
    train_aux = train_aux_phase(drive, smi, sw)
    print("train_aux " + json.dumps({"card": smi, **train_aux}), flush=True)
    for name in ("zoo", "class inference", "train aux"):
        if any(paths[name].values()):
            raise AssertionError("the %s path launched a decode kernel: %s"
                                 % (name, paths[name]))
    print("  spans of the new phases (utils/profiling.Stopwatch):", flush=True)
    sw.summary()

    # ---- 11. kernels line and device line ----
    phase("done")
    replaces = {"floodscan": "mergenet_tpu/ops/pallas/floodscan.py:105",
                "absorb": "mergenet_tpu/ops/pallas/absorb.py:153",
                "tgather": "mergenet_tpu/ops/pallas/tgather.py:83",
                "pgather": "scripts/bench_pallas_gather.py:38"}
    kernels = []
    for name in ("floodscan", "absorb", "tgather", "pgather"):
        r = results[name]
        by_path = {p: int(c.get(name, 0)) for p, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mergenet_tpu_torch/csrc/" + sources[name],
            "replaces": replaces[name],
            "launches": sum(by_path.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "call_ms": r["call_ms"], "equal": r["equal"],
            "shape": r["shape"], "launches_by_path": by_path,
            "launches_decode_phase": int(decode_launches.get(name, 0)),
            "launches_overflow_decode": int(overflow_launches.get(name, 0)),
        })
    summary = {"build_s": _build.build_seconds, "net_ms": net_ms,
               "decode_ms": dec_ms, "frame_ms": frame_ms, "instances": K,
               "decode_check": decode_check,
               "overflow_check": overflow_check, "frame_check": frame_check,
               "frame_overflow_check": frame_overflow,
               "bf16_max_abs_err": err, "bf16_argmax_agreement": agree,
               "tgather_sizes": results["tgather"]["sizes"],
               "pgather_sizes": results["pgather"]["sizes"],
               "pgather_branches": results["pgather"]["branches"],
               "floodscan_shapes": results["floodscan"]["shapes"],
               "absorb_shapes": results["absorb"]["shapes"],
               "absorb_unpacked": results["absorb"]["unpacked"],
               "tgather_decoder_indices":
                   results["tgather"]["decoder_indices"],
               "c19_check": c19_check,
               "exact_check": exact_check, "exact_stats": se_card,
               "exact_decode_ms": exact_ms,
               "exact_decode_cpu_ms": exact_cpu_ms,
               "exact_frame_ms": exact_frame_ms,
               "exact_frame_instances": K_e,
               "serve_overflow": sov, "serve_tight_overflow": tov,
               "serve_2frames_ms": serve_ms,
               "serve_2frames_fallback_ms": serve_tight_ms,
               "gather_bench": bench_rows, "certification": cert,
               "train": train, "zoo": zoo, "class_inference": cls_inf,
               "staged": staged, "train_aux": train_aux,
               "launches_by_path": paths,
               "total_s": time.perf_counter() - T0}
    print("summary " + json.dumps(summary), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
