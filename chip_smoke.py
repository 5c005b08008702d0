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
  the port's C++ greedy decoder (`decoder/csegment.py`) on fixture 0,
  in a host thread beside the card's decodes;
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
  windows with flips, 19 classes remapped to 9) over 2 bench images
  at 1024x2048, the saved maps read back and gated;
- the staged inference: `class_inference` and `offset_inference` of
  PSPFPNet-r50, the saved maps decoded by
  `run_segmentation_device(mode="hier")` on the card (floodscan,
  absorb, tgather) and on the CPU, and their mask-AP;
- the data slice: the certification dataset regenerated by the port's
  generator (`data/synthetic.py`) in a child process started before the
  train phase (with the containers split written after it there), held
  equal to the committed val json and bench images when the jpeg phase
  joins it;
- JPEG reading: the port's decoder (`data/jpeg.py`, host C++ built
  with g++) on the committed JPEGs (arithmetic-coded, lossless, CMYK
  and YCCK files among them) and an Adam7 PNG against cv2's digests,
  the arithmetic transcodings against their Huffman files (and timed
  against them and the CMYK file), procedure
  (c)'s hier column scored from the q90 JPEGs of the 50 val images
  (floodscan, absorb, tgather) against the JAX package's AP on the same
  files, the images that scoring read held to cv2's digests, and the
  coco recipe's train loader on JPEG and PNG, its stages timed;
- WebP: the port's reader (`data/webp.py`, host C++
  `data/native/webp.cc` built with g++ after the raster decompressors)
  on the committed `tests/fixtures/webp` (VP8, VP8L, alpha, EXIF, an
  animation) against cv2's digests, its lossless files against the
  regenerated PNGs, procedure (c)'s hier column scored from the q90
  WebPs of the 50 val images (floodscan, absorb, tgather) against the
  JAX package's AP on the same files, each read held to cv2's digest,
  and the host's ms per 512x1024 image for VP8 and VP8L;
- JPEG 2000: the port's reader (`data/jp2.py`, host C++
  `data/native/jp2.cc` built with g++ after the WebP decoders) on the
  committed `tests/fixtures/jp2` (cv2's and Pillow's files, the
  crafted code-block styles, progressions, POC, packed headers, colour
  spaces, palettes and channel definitions, the files cv2 refuses and
  those the port does not read yet) against cv2's digests, its lossless
  files against the regenerated PNGs, procedure (c)'s hier column
  scored from the JP2s of the 50 val images (floodscan, absorb,
  tgather) against the JAX package's AP on the same files, each read
  held to cv2's digest, and the host's ms per 512x1024 image for 9/7 +
  ICT, 5/3 + RCT and cv2's own 5/3 files;
- TIFF: the 50 committed q90 val JPEGs rewrapped as JPEG-in-TIFF
  (`tests/tiff_craft.py`; one strip, and JPEGTables with an abbreviated
  strip) read by `data/tiff.py` (JPEG strips through
  `data/native/jpeg.cc`) and held to the JPEGs' cv2 digests, procedure
  (c)'s hier column scored from them (floodscan, absorb, tgather)
  against the jpeg phase's AP and the JAX package's `c_jpeg`, and the
  host's ms per 512x1024 image for the TIFF kinds PR 20 reads (CCITT,
  YCbCr, FillOrder 2, JPEG tiles);
- from here the recipes' subprocesses (below) run beside the converter,
  certification (c), containers and certification (d) phases;
- the Cityscapes converter: the 50 regenerated val images as a gtFine
  tree (16-bit `*_gtFine_instanceIds.png`), converted by the
  `prepare_data.sh` twin as a subprocess, the converted masks held
  against the source masks, and one hier decode of the 50 images on the
  card (floodscan, absorb, tgather) scored against the original and the
  converted json;
- certification (c): the committed bench_ckpt.npz as a float32 net on
  the 50 regenerated val images, hier decodes on the card and exact
  decodes of images 0-7 (`certify.score`; floodscan, absorb, tgather),
  hier mask-AP against the JAX package's, the exact masks against the
  JAX package's exact masks of those images;
- containers: the port's raster readers (`data/{tiff,bmp,pxm,sunras,
  hdr,gif}.py`, host C++ `data/native/codecs.cc` built with g++ beside
  the JPEG decoder) on the committed `tests/fixtures/images` against
  cv2's digests, procedure (c)'s hier column scored from the 50 val
  images written in a rotation of lossless TIFF, BMP, PPM, PAM and Sun
  raster layouts (`tests/container_craft.py`; floodscan, absorb,
  tgather), every read held to the PNG pixels and the AP to (c)'s,
  and the host's ms per 512x1024 image for each layout;
- certification (d): seed 0 trained on the regenerated data through the
  port's loader (`data/pipeline.py`, `certify.train_seed`), 24 epochs,
  then scored with hier decodes;
- the recipes as users run them (`mergenet_tpu_torch/egs/cityscape`),
  as subprocesses on the 50 regenerated val images: the committed net
  split into class-only and offset-only checkpoints through
  `infer_pspfpnet.sh` stages 0-4 (class_infer, offset_infer, segment
  with the card's hier decode and the overlay, evaluate, submit),
  `infer_e2e`, and the train recipe plainly and under `torchrun`
  (NCCL, the data-parallel mesh at world size 1); then data-parallel
  serving at world size 1 against the plain serve;
- the spatial mesh axis (its 2 ranks start with the recipes and wait):
  2 ranks on the one card (gloo; the halo exchange's device tensors
  staged through host memory) height-shard PSPFPNet-r50 as the JAX
  package's multi-chip dry run does: 2 compact steps at batch 8 of
  256x512 in float32 (and a float64 twin) against the one-process
  steps, the 1024x2048 frame's forward sharded and its logits decoded
  (floodscan, absorb) against the unsharded frame's decode, and
  serving on the (1, 2, 1) mesh against plain serving;
- PSPNet-r101's aux head in compact train steps (batch 16, 768x768,
  aux_weight 0.4, bf16), after one step held against the CPU's with
  the same dropout masks.

`python3 chip_smoke.py --cards` runs the card and build phases and the
spatial phase alone over NCCL, one rank per card of a machine with an
even number of cards (2 or more): the steps and serving on
(cards/2, 2, 1), the dry run's layout, the frame on (1, cards, 1).

Every check raises; the exit code is 0 only when all phases pass.
Prints one line per phase, `train {...}`, `zoo {...}`,
`class_inference {...}`, `staged {...}`, `data {...}`, `jpeg {...}`,
`webp {...}`, `jp2 {...}`, `tiff {...}`, `converter {...}`,
`certification_c {...}`,
`containers {...}`, `certification_d {...}`,
`recipes {...}`, `spatial {...}` and `train_aux {...}` lines
(times, throughput, peak memory, FLOPs, shares of the bf16 peak), the
new phases' spans (`utils/profiling.Stopwatch`), the summary, then the
card, the kernels line, and last `{"ok": true, "device": {...}}`.

Needs a CUDA device and the repository around it (the port,
tests/fixtures/certification512, images, jpeg, webp and jp2, the tests'
shared data makers in tests/torch_port_helpers.py, the containers'
writer in tests/container_craft.py and the TIFF and JPEG writers in
tests/tiff_craft.py and tests/jpeg_craft.py); imports torch, numpy, scipy (the
converter phase), pytest (through those helpers) and the standard
library besides the port.  Writes nothing outside
mergenet_tpu_torch/_build/ (the train phase's checkpoints, the synthetic
caffemodel, the inference phases' maps, the regenerated dataset, the
converter's tree and json, the containers split, the trained seed,
the recipes' experiments, the JPEG-in-TIFF files and the spatial
ranks' files go there).
"""

import json
import os
import signal
import sys
import time

T0 = time.perf_counter()
LIMIT_S = 600  # wall-clock guard for the whole run
#: stops for the child processes main() starts, run however it ends
_STOPS = []
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "tests", "fixtures", "certification512")
sys.path.insert(0, os.path.join(HERE, "tests"))
from torch_port_helpers import (FIXTURE_OFFSETS,  # noqa: E402
                                JAX_AP, SERVE_KW, SPIRAL_OFFSETS,
                                absorb_planes,
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
# full size, on the first CLASS_FRAMES bench images upscaled to
# 1024x2048 (2 of the 4: the run's 600 s guard on a slow
# host; the gates hold each frame's maps)
CLASS_FRAMES = 2
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

# the certification workload (scripts/make_certification_fixtures.py,
# the committed summary.json's config, `certify.regenerate`'s defaults):
# the dataset regenerated by the port's generator, then (c) the committed
# bench_ckpt.npz scored on the 50 val images and (d) seed 0 trained
# through the port's loader
# (c): the float32 net's maps on val images 0-7 against the committed
# probs_<i>.npz (float16, a TPU's float32 net before its parameters were
# stored as float16); the JAX package's net on the CPU with these weights
# gives at most 0.051 and 0.00056 (`tests/jax_certification_ap.py c`)
CERT_PROBS_MAX_ABS = 0.1
CERT_PROBS_ARGMAX_DIFFER = 0.002
# the reference's summary.json, seed 0 (the float32 net): a reading
CERT_SUMMARY_SEED0 = {"hier": (0.6895, 0.8145), "exact": (0.6489, 0.8092)}
# (c)'s exact decodes on val images 0-7 only (1.4 s each): the run's
# 600 s guard (ROADMAP.md's second cut); their masks held to the JAX
# package's exact masks of the same images (c_exact_<i>.npz,
# `tests/jax_certification_ap.py c_exact_0_7 --save-exact`): each
# image's instance count within MAX_INSTANCE_DIFF, and the pixel
# agreement (up to renaming) over the 8 images at least
# CERT_C_EXACT_AGREEMENT.  The two sides decode maps of two float32
# forwards, and the exact decoder moves boundary pixels on their
# last-bit differences: the port's CPU decodes read 0.997561 (worst
# image 0.991638), planted faults 0.779409 (offsets reversed), 0.992338
# (merge_logprob_bias 0) and 0.993905 (object_merge_factor 0.8)
# (`tests/torch_port_exact_readings.py`, PERF.md).  Their AP over the 8
# images is a reading: one instance moves it by ~0.004
CERT_C_EXACT_IMAGES = 8
CERT_C_EXACT_AGREEMENT = 0.996
# (d): the reference's 24 epochs, batch 8, 384^2 crops, lr 0.02; its
# three seeds' lowest hier AP (0.6693) less their spread (0.6919 - 0.6693)
CERT_D_EPOCHS = 24
CERT_D_MIN_HIER_AP = 0.6467
# recipes phase: the train recipe at run_pspfpnet_crop.sh's arch and
# alpha, cut to 2 steps (16 train images at batch 8, 384^2 crops) and 8
# validation images; the same command plainly and under torchrun
RECIPE_CROP = 384
RECIPE_BATCH = 8
RECIPE_TRAIN_ARGS = ["--limits", "16", "--val-limits", "8", "--epochs", "1"]
RECIPE_LOSS_RTOL = 1e-3
# the jobs beside the staged chain (the train recipes, infer_e2e, the
# 2x-shrink segments) run at this niceness, so the chain, the phase's
# critical path, takes the host's cores first
RECIPE_BESIDE_NICE = 10
RECIPE_HEAD_TOL = 1e-5
RECIPE_TIMEOUT_S = 300
RECIPE_HALF_IMAGES = 4  # segment at the recipe's 2x shrink, card vs CPU
# converter phase: the Cityscapes label id of each certification class
# 1-8 (person, rider, car, truck, bus, train, motorcycle, bicycle), which
# the converter maps back to category ids 1-8
CONVERTER_LABEL_IDS = (24, 25, 26, 27, 28, 31, 32, 33)
CONVERTER_TIMEOUT_S = 300

# spatial phase: the JAX package's multi-chip dry run
# (__graft_entry__.py:108-160 dryrun_multichip: PSPFPNet-r50, 256x512
# crops, global batch 8, spatial=2) as 2 ranks on the one card over gloo
# (NCCL refuses two ranks on one device), float32 with TF32 off, against
# the one-process step on the same batch and weights; then the served
# frame's forward height-sharded over the ranks and decoded (floodscan,
# absorb), and serving on the (1, 2, 1) mesh
SPATIAL_RANKS = 2
SPATIAL_BATCH, SPATIAL_CROP, SPATIAL_STEPS = 8, (256, 512), 2
# gates of (i): float32 losses of both steps within 1e-3 relative, the
# running statistics of the first step within 1e-3 (+ 1e-3 relative, the
# train phase's rule); after the second step float32 lies further from
# float64 than that in the one-process step itself (the first step's
# update of a ResNet-50 moves with the summation order: PERF.md), so the
# float64 twin of both steps is held to 1e-9
SPATIAL_LOSS_RTOL = 1e-3
SPATIAL_STATS_TOL = 1e-3
SPATIAL_F64_TOL = 1e-9
SPATIAL_FRAME, SPATIAL_DECODE = (1024, 2048), (512, 1024)
SPATIAL_TIMEOUT_S = 150
SPATIAL_MAX_S = 60  # the phase's budget within the run
# jpeg phase: decodes of each arithmetic transcoding, its Huffman source
# and of JPEG_CMYK for their ms per 512x1024 image
JPEG_REPS = 5
JPEG_CMYK = "matrix/cmyk_444.jpg"


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
    greedy masks and the JAX package's figures; the port's C++ greedy on
    fixture 0 runs on the host meanwhile, in a thread (its ctypes call
    releases the GIL), and is joined and gated last."""
    import threading

    import numpy as np
    import torch
    from mergenet_tpu_torch import certify as CT
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

    greedy = {}

    def cpp_greedy():
        try:
            t0 = time.perf_counter()
            stale = csegment.library_path()
            if os.path.exists(stale):  # measure the real build every run
                os.unlink(stale)
            csegment.build()
            greedy["build_s"] = time.perf_counter() - t0
            cp, sp = io.load_probs(FIX, 0)
            t0 = time.perf_counter()
            greedy["mask"], greedy["classes"] = csegment.run_segmentation(
                np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0), C, offsets,
                same_different_bias=0.0, **SERVE_KW)
            greedy["decode_s"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised after the join
            greedy["error"] = e

    host = threading.Thread(target=cpp_greedy, daemon=True)
    host.start()
    t0 = time.perf_counter()
    drive("certification", decode_all, ("floodscan", "absorb", "tgather"))
    decode_s = time.perf_counter() - t0
    print("  8 fixtures decoded on the card (hier + exact) in %.2f s; "
          "overflow %s" % (decode_s, overflow), flush=True)
    if any(v for o in overflow.values() for v in o.values()):
        raise AssertionError("hier decode overflowed: %s" % overflow)

    t0 = time.perf_counter()
    coco = COCO(os.path.join(FIX, "val_ann.json"))
    ap = {proc: {name: CT.coco_ap(coco, r, None if proc == "a" else ids)
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

    host.join()
    if "error" in greedy:
        raise greedy["error"]
    build_s, cpp_s = greedy["build_s"], greedy["decode_s"]
    cm_mask, cm_cls = greedy["mask"], greedy["classes"]
    with np.load(os.path.join(FIX, "cpp_mask_0.npz")) as cm:
        ref_mask = cm["mask"]
    differ = int((cm_mask != ref_mask).sum())
    print("  C++ greedy (decoder/csegment.py) on fixture 0 (512x1024): g++ "
          "build %.2f s, decode %.2f s on the host (a thread beside the "
          "card's decodes); classes %s; %d of %d "
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


def train_data(rng, n=TRAIN_BATCH, size=(TRAIN_CROP, TRAIN_CROP)):
    """The train phase's compact batch: the 4 committed val images
    (`bench_images`, the first four sorted val ids, as
    scripts/export_bench_checkpoint.py took them) and their instance
    masks from val_ann.json (first annotation wins, ids in annotation
    order, classes through [0] + category ids), each upscaled x2
    (nearest) to 1024x2048; `n` crops of `size` (h, w) at positions
    drawn from `rng`, frame i % 4 for crop i."""
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
    h, w = size
    batch = {"image": [], "mask": [], "object_class": []}
    for i in range(n):
        img, mask, table = frames[i % 4]
        r = int(rng.integers(0, img.shape[0] - h + 1))
        c = int(rng.integers(0, img.shape[1] - w + 1))
        batch["image"].append(img[r:r + h, c:c + w])
        batch["mask"].append(mask[r:r + h, c:c + w])
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
    classes remapped to 9) over CLASS_FRAMES bench images upscaled to
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
                  for i, img in enumerate(bench_images()[:CLASS_FRAMES])]
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

    from mergenet_tpu_torch import certify as CT
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
        ap, ap50 = CT.coco_ap(coco, results, [0, 1, 2, 3])
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


def _data_child(data_dir, container_dir, out):
    """The data phase's host work, in a child process at the lowest
    priority: the certification dataset regenerated into `data_dir`
    (`certify.regenerate`, whose two worker processes inherit the
    priority), then the 50 val images written into `container_dir` in a
    rotation of `container_craft.LAYOUTS`, with the val json naming
    them; writes {seconds, images, container_write_s, files: {name:
    layout, shape, sha256 of the PNG's pixels}} to `out`."""
    os.nice(19)  # the card phases it runs beside keep the host's cores
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import hashlib

    import container_craft as cc
    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io

    gen_s, n = CT.regenerate(data_dir)
    t0 = time.perf_counter()
    os.makedirs(os.path.join(container_dir, "val"))
    os.makedirs(os.path.join(container_dir, "annotations"))
    with open(os.path.join(data_dir, "annotations",
                           "instancesonly_val.json")) as f:
        ann = json.load(f)
    files = {}
    for k, im in enumerate(ann["images"]):
        rgb = io.read_png_rgb(os.path.join(data_dir, "val",
                                           im["file_name"]))
        layout, ext = cc.LAYOUTS[k % len(cc.LAYOUTS)]
        im["file_name"] = os.path.splitext(im["file_name"])[0] + ext
        cc.write_layout(os.path.join(container_dir, "val", im["file_name"]),
                        rgb, layout)
        files[im["file_name"]] = {
            "layout": layout, "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(container_dir, "annotations",
                           "instancesonly_val.json"), "w") as f:
        json.dump(ann, f)
    with open(out, "w") as f:
        json.dump({"seconds": gen_s, "images": n,
                   "container_write_s": time.perf_counter() - t0,
                   "files": files}, f)


def data_start():
    """Spawn `_data_child` into `_build/cert_data` and
    `_build/container_data` (both emptied first); `data_phase` joins it.
    Returns the run's state."""
    import multiprocessing
    import shutil

    build = os.path.join(HERE, "mergenet_tpu_torch", "_build")
    run = {"data_dir": os.path.join(build, "cert_data"),
           "container_dir": os.path.join(build, "container_data"),
           "out": os.path.join(build, "data_child.json")}
    for d in (run["data_dir"], run["container_dir"]):
        shutil.rmtree(d, ignore_errors=True)
    if os.path.exists(run["out"]):
        os.unlink(run["out"])
    os.makedirs(build, exist_ok=True)
    run["proc"] = multiprocessing.get_context("spawn").Process(
        target=_data_child, args=(run["data_dir"], run["container_dir"],
                                  run["out"]))
    run["t_start"] = time.perf_counter()
    run["proc"].start()
    return run


def data_stop(run):
    """Kill and join the data child if it is still alive."""
    if run["proc"].is_alive():
        run["proc"].kill()
        run["proc"].join()


def data_phase(smi, sw, run):
    """Join the child `data_start` started before the train phase: the
    certification dataset regenerated by the port's generator
    (`certify.regenerate`) under `_build/cert_data`, whose val json must
    equal the committed val_ann.json and whose first four val images the
    committed bench_img*.png, and the containers split.  Returns
    (readings, data directory)."""
    import numpy as np

    from mergenet_tpu_torch import io

    data_dir = run["data_dir"]
    with sw.span("data wait"):
        run["proc"].join()
    if run["proc"].exitcode != 0:
        raise AssertionError("the data child process exited with %s"
                             % run["proc"].exitcode)
    with open(run["out"]) as f:
        child = json.load(f)
    gen_s, n = child["seconds"], child["images"]
    ann = os.path.join(data_dir, "annotations", "instancesonly_val.json")
    ref_path = os.path.join(FIX, "val_ann.json")
    with open(ann) as f, open(ref_path) as g:
        json_equal = json.load(f) == json.load(g)
    with open(ann, "rb") as f, open(ref_path, "rb") as g:
        bytes_equal = f.read() == g.read()
    imgs_equal = [bool(np.array_equal(io.read_png_rgb(os.path.join(
        data_dir, "val", "val_%05d.png" % k)), ref))
        for k, ref in enumerate(bench_images())]
    out = {"seconds": gen_s, "images": n, "images_per_s": n / gen_s,
           "container_write_s": child["container_write_s"],
           "child_s": time.perf_counter() - run["t_start"],
           "waited_s": sw.totals["data wait"],
           "val_json_equal": json_equal, "val_json_bytes_equal": bytes_equal,
           "bench_images_equal": imgs_equal}
    print("  %d images of 512x1024 in %.2f s (%.2f images/s on the host, "
          "in a child process started before the train phase; the "
          "containers split written after it in %.2f s; %.2f s waited "
          "here); val json equal to val_ann.json: %s (bytes: %s); "
          "val_00000-00003 equal to bench_img*.png: %s" % (
              n, gen_s, n / gen_s, child["container_write_s"],
              out["waited_s"], json_equal, bytes_equal, imgs_equal),
          flush=True)
    if not json_equal or not all(imgs_equal):
        raise AssertionError("the regenerated dataset differs from the "
                             "committed fixtures")
    run["files"] = child["files"]
    return out, data_dir


def start_jpeg_build():
    """The g++ builds of the JPEG decoder (`data/native/jpeg.cc`), then
    of the raster decompressors (`data/native/codecs.cc`), the WebP
    decoders (`data/native/webp.cc`), the JPEG 2000 decoder
    (`data/native/jp2.cc`) and the AV1 decoder (`data/native/avif.cc`)
    in a thread, started once the kernels' nvcc build is done, so that
    they run beside the card phases that follow; returns (thread, result
    dict), which the jpeg phase joins (the dict holds build_s,
    codecs_build_s, webp_build_s, jp2_build_s and avif_build_s, None for
    a library already built, or the error)."""
    import threading

    from mergenet_tpu_torch.data import avif, codecs, jp2, jpeg, webp
    result = {}

    def run():
        try:
            for key, mod in (("build_s", jpeg), ("codecs_build_s", codecs),
                             ("webp_build_s", webp), ("jp2_build_s", jp2),
                             ("avif_build_s", avif)):
                built = not os.path.exists(mod.library_path())
                t0 = time.perf_counter()
                mod.build()
                result[key] = time.perf_counter() - t0 if built else None
        except BaseException as e:  # re-raised by the jpeg phase
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread, result


def jpeg_phase(drive, paths, smi, sw, data_dir, build=None):
    """JPEG reading (`data/jpeg.py`, host C++ built with g++ by
    `start_jpeg_build`, after the nvcc build, or here): every
    committed file of tests/fixtures/jpeg (JPEGs: baseline to
    progressive, arithmetic-coded, lossless, CMYK and YCCK; an Adam7
    PNG through `io.read_png_rgb`) decoded and held to cv2's SHA-256
    (`cv2_digests.json`); the arithmetic transcodings held equal to the
    Huffman files they came from, and timed against them per 512x1024
    image with the CMYK file (JPEG_REPS decodes each, in turns);
    procedure (c)'s hier column scored
    from the 50 committed q90 JPEGs of the val images (`certify.score`
    on the card: floodscan, absorb and tgather once per image), AP and
    AP50 gated within CERT_JAX_AP_TOL of JAX's `c_jpeg` figure and every
    image that scoring read held to cv2's digest; and the coco recipe's
    train loader (`COCODataset` + `DataLoader`, crop 384, scale 2, batch
    16, no step) timed on the JPEGs and on the PNGs of the same images,
    with a span for each stage of an item (read, masks, resize, crop,
    targets)."""
    import contextlib
    import hashlib
    import io as _io
    import json
    import shutil

    import numpy as np

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import COCODataset, DataLoader, imgproc, jpeg
    from mergenet_tpu_torch.data import dataset as DS

    fixj = os.path.join(HERE, "tests", "fixtures", "jpeg")
    with open(os.path.join(fixj, "cv2_digests.json")) as f:
        digests = json.load(f)
    thread, built = build or start_jpeg_build()
    with sw.span("jpeg build"):  # the wait for the build, if it still runs
        thread.join()
    if "error" in built:
        raise built["error"]
    build_s = built["build_s"]
    codecs_build_s = built["codecs_build_s"]
    blobs = {}
    for rel in digests:
        with open(os.path.join(fixj, rel), "rb") as f:
            blobs[rel] = f.read()
    jpeg.decode_jpeg(blobs["val/val_00000.jpg"])  # load the library

    def read(rel):
        if rel.endswith(".png"):
            return io.read_png_rgb(os.path.join(fixj, rel))
        return jpeg.decode_jpeg(blobs[rel], rel)

    fixtures_t0 = time.perf_counter()
    wrong = []
    val_s = 0.0
    decoded = {}
    pairs = {rel: d["transcoded_from"] for rel, d in digests.items()
             if "transcoded_from" in d}
    for rel in blobs:
        t0 = time.perf_counter()
        img = read(rel)
        dt = time.perf_counter() - t0
        if rel.startswith("val/"):
            val_s += dt
        if [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] \
                != [digests[rel]["shape"], digests[rel]["sha256"]]:
            wrong.append(rel)
        if rel in pairs or rel in pairs.values():
            decoded[rel] = img
    val = sorted(r for r in blobs if r.startswith("val/"))
    val_bytes = sum(len(blobs[r]) for r in val)
    ms_img = val_s / len(val) * 1e3
    mb_s = val_bytes / val_s / 1e6
    print("  decoder %s, codecs %s (g++, after the nvcc build; %.2f s "
          "waited here); "
          "%d files decoded, %d differ from cv2's digest; 512x1024 q90 "
          "4:2:0: %.3f ms per image, %.2f MB/s of JPEG, %.2f Mpixel/s "
          "(host, %s)" % (
              "cached" if build_s is None else "built in %.2f s" % build_s,
              "cached" if codecs_build_s is None
              else "built in %.2f s" % codecs_build_s,
              sw.totals["jpeg build"], len(blobs), len(wrong), ms_img, mb_s,
              512 * 1024 * len(val) / val_s / 1e6, smi), flush=True)
    if wrong:
        raise AssertionError("JPEG decodes differ from cv2's: %s" % wrong)
    unequal = [rel for rel, src in pairs.items()
               if not np.array_equal(decoded[rel], decoded[src])]
    if not pairs or unequal:
        raise AssertionError("arithmetic transcodings differ from their "
                             "Huffman files: %s of %s" % (unequal, pairs))
    # ms per 512x1024 image: each transcoding, its Huffman source and the
    # CMYK file, decoded JPEG_REPS times in turns (host)
    timed = sorted(set(pairs) | set(pairs.values()) | {JPEG_CMYK})
    spent = dict.fromkeys(timed, 0.0)
    for _ in range(JPEG_REPS):
        for rel in timed:
            t0 = time.perf_counter()
            jpeg.decode_jpeg(blobs[rel], rel)
            spent[rel] += time.perf_counter() - t0
    per = {rel: spent[rel] / JPEG_REPS * 1e3 for rel in timed}
    fixtures_s = time.perf_counter() - fixtures_t0
    coding_ms = {
        "arith_seq": [per[r] for r in sorted(pairs) if "_seq" in r],
        "arith_prog": [per[r] for r in sorted(pairs) if "_prog" in r],
        "huffman_sources": [per[s] for s in sorted(set(pairs.values()))],
        "cmyk_444": per[JPEG_CMYK]}
    print("  arithmetic transcodings equal to their Huffman files (%d); ms "
          "per 512x1024 image, %d decodes each (host, %s): arithmetic "
          "sequential %s, progressive %s; their Huffman sources %s; CMYK "
          "4:4:4 %.3f; the fixtures' decodes and timing %.2f s" % (
              len(pairs), JPEG_REPS, smi,
              " ".join("%.3f" % v for v in coding_ms["arith_seq"]),
              " ".join("%.3f" % v for v in coding_ms["arith_prog"]),
              " ".join("%.3f" % v for v in coding_ms["huffman_sources"]),
              coding_ms["cmyk_444"], fixtures_s), flush=True)

    jdir = os.path.join(HERE, "mergenet_tpu_torch", "_build", "jpeg_data")
    shutil.rmtree(jdir, ignore_errors=True)
    os.makedirs(os.path.join(jdir, "annotations"))
    shutil.copytree(os.path.join(fixj, "val"), os.path.join(jdir, "val"))
    with open(os.path.join(data_dir, "annotations",
                           "instancesonly_val.json")) as f:
        ann = json.load(f)
    for im in ann["images"]:
        im["file_name"] = os.path.splitext(im["file_name"])[0] + ".jpg"
    with open(os.path.join(jdir, "annotations", "instancesonly_val.json"),
              "w") as f:
        json.dump(ann, f)
    offsets = io.load_offsets(FIX)
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                            9 + len(offsets))
    reads = {}  # what certify.score itself read: held to cv2's digests
    imread = imgproc.imread_rgb

    def hashed_imread(path):
        img = imread(path)
        reads["val/" + os.path.basename(path)] = [
            list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]
        return img

    imgproc.imread_rgb = hashed_imread
    try:
        with sw.span("jpeg (c) hier"):
            r = drive("jpeg", lambda: CT.score(net, jdir, 9, offsets,
                                               ("hier",)),
                      ("floodscan", "absorb", "tgather"))
    finally:
        imgproc.imread_rgb = imread
    del net
    reads_equal = reads == {rel: [digests[rel]["shape"],
                                  digests[rel]["sha256"]] for rel in val}
    ap, jref = r["hier"], JAX_AP["c_jpeg"]["hier"]
    png = JAX_AP["c"]["hier"]
    print("  (c) hier from JPEG: AP %.4f AP50 %.4f | JAX (CPU, cv2.imread) "
          "AP %.4f AP50 %.4f | from PNG, JAX: AP %.4f AP50 %.4f (JPEG q90 "
          "minus PNG: AP %+.4f, AP50 %+.4f); %d images, overflow %s, net "
          "%.2f s, hier %.2f s" % (
              ap[0], ap[1], jref[0], jref[1], png[0], png[1], ap[0] - png[0],
              ap[1] - png[1], r["images"], r["overflow"], r["times_s"]["net"],
              r["times_s"]["hier"]), flush=True)
    launches = dict(paths["jpeg"])
    gates = [("AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[0] - jref[0]) <= CERT_JAX_AP_TOL),
             ("AP50 within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[1] - jref[1]) <= CERT_JAX_AP_TOL),
             ("score's reads of the %d JPEGs equal to cv2's digests"
              % len(val), reads_equal),
             ("zero overflow", not any(r["overflow"].values())),
             ("one launch of each kernel per image",
              all(launches.get(k) == r["images"]
                  for k in ("floodscan", "absorb", "tgather")))]

    # the loader's stages, each a span: the functions an item goes
    # through are wrapped for the pass (imgproc.imread_rgb the read;
    # dataset.py's anns_to_mask, resize_image_and_mask,
    # crop_image_and_mask and mask_to_target_np); "other" is the rest
    # (float conversion, batching)
    stages = (("read", imgproc, "imread_rgb"),
              ("masks", DS, "anns_to_mask"),
              ("resize", DS, "resize_image_and_mask"),
              ("crop", DS, "crop_image_and_mask"),
              ("targets", DS, "mask_to_target_np"))

    def spanned(name, fn):
        def run(*a, **kw):
            with sw.span(name):
                return fn(*a, **kw)
        return run

    def loader_pass(kind, d):
        with contextlib.redirect_stdout(_io.StringIO()):
            ds = COCODataset(os.path.join(d, "val"), os.path.join(
                d, "annotations", "instancesonly_val.json"), 9, offsets,
                scale=2, crop=True, crop_size=384, seed=0)
        loader = DataLoader(ds, batch_size=16, shuffle=True, drop_last=True)
        saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in stages]
        for (stage, mod, attr), (_, _, fn) in zip(stages, saved):
            setattr(mod, attr, spanned("jpeg loader %s %s" % (kind, stage),
                                       fn))
        try:
            with sw.span("jpeg loader " + kind):
                n = sum(len(b[0]) for b in loader)
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        total = sw.totals["jpeg loader " + kind]
        ms = {st: sw.totals["jpeg loader %s %s" % (kind, st)] / n * 1e3
              for st, _, _ in stages}
        ms["other"] = total / n * 1e3 - sum(ms.values())
        return {"images_per_s": n / total, "images": n,
                "ms_per_item": total / n * 1e3, "stage_ms_per_item": ms}

    # both sets were just written: warm reads
    loaders = {kind: loader_pass(kind, d)
               for kind, d in (("jpeg", jdir), ("png", data_dir))}
    print("  coco train loader (crop 384, scale 2, batch 16, no step) on the "
          "50 val images, %d images a pass, warm reads, host:" %
          loaders["jpeg"]["images"], flush=True)
    for kind, lr in loaders.items():
        print("    from %s: %.2f images/s, %.2f ms per item: %s" % (
            kind.upper(), lr["images_per_s"], lr["ms_per_item"], ", ".join(
                "%s %.2f" % kv for kv in sorted(
                    lr["stage_ms_per_item"].items(),
                    key=lambda kv: -kv[1]))), flush=True)
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("jpeg gates failed: %s" % failed)
    return {"files": len(blobs), "differ": wrong,
            "transcodings_equal_huffman": pairs,
            "coding_ms_per_512x1024": coding_ms, "fixtures_s": fixtures_s,
            "build_s": build_s, "codecs_build_s": codecs_build_s,
            "decode_ms_per_512x1024": ms_img, "decode_mb_per_s": mb_s,
            "ap": ap, "jax_ap": jref, "png_jax_ap": png,
            "ap_minus_png": [ap[0] - png[0], ap[1] - png[1]],
            "overflow": r["overflow"], "times_s": r["times_s"],
            "launches": launches,
            "reads_equal_digests": reads_equal, "loader": loaders,
            "phase_s": sum(sw.totals[k] for k in (
                "jpeg build", "jpeg (c) hier", "jpeg loader jpeg",
                "jpeg loader png"))}


def converter_phase(drive, smi, sw, data_dir):
    """The Cityscapes converter on a gtFine tree built from the
    regenerated val split: each image's visible instances written as a
    16-bit `*_gtFine_instanceIds.png` (label id * 1000 + k), its
    `*_gtFine_polygons.json` without objects and its image linked as
    `*_leftImg8bit.png`; then the port's `prepare_data.sh` twin as a
    subprocess.  Gates: every converted annotation has its source's class
    and pixel count; its polygons, filled by `imgproc.poly_mask`, equal
    the source mask wherever that is one 8-connected component without
    holes; the 50 images decoded once with hier on the card score the
    same AP against the converted json as against the original json with
    each differing mask replaced by its filled polygons and the
    converted image and annotation ids.  The ids matter: the converter
    numbers annotations from 0, as the reference does, and COCOeval (the
    reference's and the port's) records a match by the ground truth's
    id, so it never matches the one of id 0; and every detection scores
    1, so the precision-recall curve follows the image order, which the
    converter takes from the sorted file names."""
    import contextlib
    import io as _io
    import shutil
    import subprocess
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from scipy import ndimage

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import COCO, imgproc, rle

    t_phase = time.perf_counter()
    work = os.path.join(HERE, "mergenet_tpu_torch", "_build", "converter")
    shutil.rmtree(work, ignore_errors=True)
    download = os.path.join(work, "download")
    gt_dir = os.path.join(download, "gtFine_trainvaltest", "gtFine", "val",
                          "cert")
    left_dir = os.path.join(download, "leftImg8bit_trainvaltest",
                            "leftImg8bit", "val", "cert")
    with sw.span("converter tree"):
        os.makedirs(gt_dir)
        os.makedirs(left_dir)
        with open(os.path.join(data_dir, "annotations",
                               "instancesonly_val.json")) as f:
            src = json.load(f)
        sources = {}  # image id -> [(instance id, class, mask)]
        src_keys = []  # (image id, instance id) of each annotation
        for a in src["annotations"]:
            inst = sources.setdefault(a["image_id"], [])
            iid = CONVERTER_LABEL_IDS[a["category_id"] - 1] * 1000 + len(inst)
            inst.append((iid, a["category_id"], rle.decode(a["segmentation"])))
            src_keys.append((a["image_id"], iid))
        for img in src["images"]:
            ids = np.zeros((img["height"], img["width"]), np.uint16)
            for iid, _, m in sources.get(img["id"], []):
                ids[m > 0] = iid  # the visible masks are disjoint
            stem = "cert_%d_" % img["id"]
            io.write_png(os.path.join(gt_dir, stem + "gtFine_instanceIds.png"),
                         ids)
            with open(os.path.join(gt_dir, stem + "gtFine_polygons.json"),
                      "w") as f:
                json.dump({"imgWidth": img["width"],
                           "imgHeight": img["height"], "objects": []}, f)
            os.symlink(os.path.join(data_dir, "val", img["file_name"]),
                       os.path.join(left_dir, stem + "leftImg8bit.png"))
    tree_s = sw.totals["converter tree"]

    out_dir = os.path.join(work, "data")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))

    def convert():
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["bash", os.path.join(HERE, "mergenet_tpu_torch", "egs",
                                  "cityscape", "prepare_data.sh"),
             "--dataset-dir", download, "--out-dir", out_dir], cwd=work,
            env=env, capture_output=True, text=True,
            timeout=CONVERTER_TIMEOUT_S)
        return proc, time.perf_counter() - t0

    # the conversion runs on the host beside the decode on the card
    with ThreadPoolExecutor(1) as pool:
        converting = pool.submit(convert)
        offsets = io.load_offsets(FIX)
        net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                                9 + len(offsets))
        with sw.span("converter decode"):
            r = drive("converter", lambda: CT.score(
                net, data_dir, 9, offsets, ("hier",)),
                ("floodscan", "absorb", "tgather"))
        del net
        proc, convert_s = converting.result()
    decode_s = sw.totals["converter decode"]
    if proc.returncode != 0:
        raise AssertionError("prepare_data.sh exited %d: %s" % (
            proc.returncode, (proc.stdout + proc.stderr)[-3000:]))
    conv_path = os.path.join(out_dir, "annotations",
                             "instancesonly_filtered_gtFine_val.json")
    with open(conv_path) as f:
        conv = json.load(f)
    linked = len(os.listdir(os.path.join(out_dir, "val")))

    # match each converted annotation to its source: both lists run in
    # increasing instance id, the key is (class, bbox of the source mask)
    src_of = {int(im["file_name"][len("cert_"):].split("_")[0]): im["id"]
              for im in conv["images"]}
    conv_anns = {}
    for a in conv["annotations"]:
        conv_anns.setdefault(a["image_id"], []).append(a)
    checked = {"annotations": len(conv["annotations"]),
               "sources": sum(len(v) for v in sources.values()),
               "single_hole_free": 0, "single_hole_free_equal": 0,
               "other": 0, "other_equal": 0, "class_area_equal": 0,
               "missing": 0}
    differing, refilled, ann_id = [], {}, {}
    for i, conv_id in sorted(src_of.items()):
        pending = list(conv_anns.get(conv_id, []))
        for iid, cls, m in sorted(sources.get(i, []), key=lambda t: t[0]):
            ys, xs = np.nonzero(m)
            key = (cls, [float(xs.min()), float(ys.min()),
                         float(xs.max() - xs.min() + 1),
                         float(ys.max() - ys.min() + 1)])
            if not pending or (pending[0]["category_id"],
                               pending[0]["bbox"]) != key:
                checked["missing"] += 1
                differing.append({"image": i, "instance": iid,
                                  "missing": True})
                continue
            a = pending.pop(0)
            ann_id[(i, iid)] = a["id"]
            checked["class_area_equal"] += int(a["area"] == float(ys.size))
            # on the box around the mask and the polygons, one pixel wider
            # where the image allows: the same components, holes and fill
            pts = np.concatenate([np.reshape(p, (-1, 2))
                                  for p in a["segmentation"]])
            x0 = max(int(min(xs.min(), pts[:, 0].min())) - 1, 0)
            y0 = max(int(min(ys.min(), pts[:, 1].min())) - 1, 0)
            x1 = int(max(xs.max(), pts[:, 0].max())) + 2
            y1 = int(max(ys.max(), pts[:, 1].max())) + 2
            box = m[y0:y1, x0:x1]
            filled = np.zeros_like(box)
            for poly in a["segmentation"]:
                shifted = (np.reshape(poly, (-1, 2)) - [x0, y0]).reshape(-1)
                filled |= imgproc.poly_mask(shifted, *box.shape)
            equal = bool(np.array_equal(filled, box))
            _, parts = ndimage.label(box, structure=np.ones((3, 3)))
            simple = parts == 1 and bool(np.array_equal(
                ndimage.binary_fill_holes(box), box > 0))
            kind = "single_hole_free" if simple else "other"
            checked[kind] += 1
            checked[kind + "_equal"] += int(equal)
            if not equal:
                differing.append({"image": i, "instance": iid,
                                  "simple": simple, "pixels": int(
                                      (filled != box).sum())})
                refilled[(i, iid)] = np.zeros_like(m)
                refilled[(i, iid)][y0:y1, x0:x1] = filled
        if pending:
            raise AssertionError("image %d: %d converted annotations match "
                                 "no source" % (i, len(pending)))
    print("  tree of %d images (%d instances) in %.2f s; prepare_data.sh "
          "in %.2f s: %d annotations, %d images linked; class and area "
          "equal: %d; one 8-connected component without holes: %d, masks "
          "equal %d; other instances: %d (not gated), masks equal %d; "
          "sources without an annotation: %d" % (
              len(src["images"]), checked["sources"], tree_s, convert_s,
              checked["annotations"], linked, checked["class_area_equal"],
              checked["single_hole_free"], checked["single_hole_free_equal"],
              checked["other"], checked["other_equal"], checked["missing"]),
          flush=True)

    with sw.span("converter score"):
        with contextlib.redirect_stdout(_io.StringIO()):
            coco_conv = COCO(conv_path)
        res = [dict(d, image_id=src_of[d["image_id"]])
               for d in r["results"]["hier"]]
        ap_conv = CT.coco_ap(coco_conv, res)
        # the original json with each differing mask replaced by its
        # filled polygons, then also with the converted json's image and
        # annotation ids: the converted json must score as the latter
        def refilled_ap(tag, ids):
            anns = []
            spare = max([a["id"] for a in conv["annotations"]], default=0)
            for a, key in zip(src["annotations"], src_keys):
                if ids:
                    spare += key not in ann_id
                    a = dict(a, id=ann_id.get(key, spare),
                             image_id=src_of[a["image_id"]])
                if key in refilled:
                    code = rle.encode(np.asfortranarray(refilled[key]))
                    a = dict(a, segmentation={
                        "size": code["size"],
                        "counts": code["counts"].decode("ascii")})
                anns.append(a)
            images = [dict(im, id=src_of[im["id"]]) if ids else im
                      for im in src["images"]]
            path = os.path.join(work, "refilled_%s_val.json" % tag)
            with open(path, "w") as f:
                json.dump(dict(src, images=images, annotations=anns), f)
            with contextlib.redirect_stdout(_io.StringIO()):
                coco = COCO(path)
            return CT.coco_ap(coco, res if ids else r["results"]["hier"])

        ap_masks = refilled_ap("masks", False)
        ap_ref = refilled_ap("ids", True)
    score_s = sw.totals["converter score"]
    ap_orig = r["hier"]
    same_ref = ap_ref == ap_conv
    print("  hier on the card, AP / AP50: %.4f / %.4f against "
          "instancesonly_val.json; %.4f / %.4f with the %d differing "
          "masks refilled from their polygons (%+.4f); %.4f / %.4f with "
          "the converted image and annotation ids too (%+.4f); %.4f / %.4f "
          "against the converted json (exact: %r, %r, %r, %r); differing: "
          "%s" % (
              ap_orig[0], ap_orig[1], ap_masks[0], ap_masks[1],
              len(differing), ap_masks[0] - ap_orig[0], ap_ref[0],
              ap_ref[1], ap_ref[0] - ap_masks[0], ap_conv[0], ap_conv[1],
              ap_orig, ap_masks, ap_ref, ap_conv, differing), flush=True)
    phase_s = time.perf_counter() - t_phase
    print("  converter phase %.2f s: tree %.2f s, conversion %.2f s (a "
          "subprocess beside the decode), hier decode of the 50 images "
          "%.2f s, three COCOevals %.2f s (%s)" % (
              phase_s, tree_s, convert_s, decode_s, score_s, smi),
          flush=True)
    gates = [("class and area", checked["class_area_equal"]
              == checked["annotations"] == checked["sources"]
              - checked["missing"]),
             ("hole-free single components equal",
              checked["single_hole_free_equal"]
              == checked["single_hole_free"]),
             ("AP equal to the refilled original's", same_ref)]
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("converter gates failed: %s" % failed)
    return {"checked": checked, "differing": differing,
            "ap_original": ap_orig, "ap_refilled_masks": ap_masks,
            "ap_refilled_masks_ids": ap_ref, "ap_converted": ap_conv,
            "images_linked": linked,
            "seconds": {"phase": phase_s, "tree": tree_s,
                        "convert": convert_s, "decode": decode_s,
                        "score": score_s},
            "hier_s": r["times_s"]["hier"], "net_s": r["times_s"]["net"]}


def cert_c_phase(drive, smi, sw, data_dir):
    """Procedure (c): the committed bench_ckpt.npz (float16 parameters
    widened) as a float32 net (TF32 off) on the 50 regenerated val
    images, hier decodes on the card and exact decodes of images 0-7
    (the run's budget: ROADMAP.md), scored with the port's COCOeval;
    gates: the maps of images 0-7 against the committed fixtures, zero
    overflow, hier AP within CERT_JAX_AP_TOL of JAX's over the 50, and
    the exact masks of images 0-7 against the JAX package's exact masks
    of those images (c_exact_<i>.npz; CERT_C_EXACT_AGREEMENT above); the
    exact AP over them beside JAX's (`JAX_AP["c_exact_0_7"]`) is a
    reading."""
    import numpy as np

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io

    offsets = io.load_offsets(FIX)
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                            9 + len(offsets))
    diffs = []

    def on_probs(n, img_id, cp, sp):
        if img_id < 8:
            fcp, fsp = io.load_probs(FIX, img_id)
            d = np.abs(np.concatenate([cp, sp], -1)
                       - np.concatenate([fcp, fsp], -1))
            diffs.append({"max_abs": float(d.max()),
                          "mean_abs": float(d.mean()),
                          "argmax_differ": float(
                              (cp.argmax(-1) != fcp.argmax(-1)).mean())})

    exact = {}

    def on_exact(n, img_id, mask, classes):
        exact[n] = np.asarray(mask)

    with sw.span("certification (c)"):
        r = drive("certification (c)", lambda: CT.score(
            net, data_dir, 9, offsets, ("hier", "exact"),
            on_probs=on_probs, exact_images=CERT_C_EXACT_IMAGES,
            on_exact=on_exact), ("floodscan", "absorb", "tgather"))
    del net
    worst = {k: max(d[k] for d in diffs) for k in diffs[0]}
    print("  net maps on val images 0-7 vs the committed probs_<i>.npz: "
          "max abs %.4f (limit %.2f), mean abs %.3e, argmax differing %.5f "
          "(limit %.4f)" % (worst["max_abs"], CERT_PROBS_MAX_ABS,
                            worst["mean_abs"], worst["argmax_differ"],
                            CERT_PROBS_ARGMAX_DIFFER), flush=True)
    jref = JAX_AP["c"]["hier"]
    print("  (c) hier  AP %.4f AP50 %.4f | JAX (CPU) AP %.4f AP50 %.4f | "
          "summary.json seed 0 AP %.4f AP50 %.4f" % (
              r["hier"][0], r["hier"][1], jref[0], jref[1],
              CERT_SUMMARY_SEED0["hier"][0], CERT_SUMMARY_SEED0["hier"][1]),
          flush=True)
    jref = JAX_AP["c_exact_0_7"]["exact"]
    print("  (c) exact AP %.4f AP50 %.4f over images 0-%d | JAX (CPU) AP "
          "%.4f AP50 %.4f over them (a reading)" % (
              r["exact"][0], r["exact"][1], CERT_C_EXACT_IMAGES - 1,
              jref[0], jref[1]), flush=True)
    exact_vs_jax = []
    for i in range(CERT_C_EXACT_IMAGES):
        with np.load(os.path.join(FIX, "c_exact_%d.npz" % i)) as z:
            ref = z["mask"]
        frac, same = agreement(exact[i], ref)
        exact_vs_jax.append({"agreement": frac, "exact": same,
                             "instances": int(exact[i].max()),
                             "instances_jax": int(ref.max())})
    exact_agree = sum(e["agreement"] for e in exact_vs_jax) / len(
        exact_vs_jax)
    counts_ok = all(abs(e["instances"] - e["instances_jax"])
                    <= MAX_INSTANCE_DIFF for e in exact_vs_jax)
    print("  (c) exact masks of images 0-%d against JAX's: agreement %.6f "
          "over them (limit %.3f); per image (agreement, instances card/"
          "JAX): %s" % (
              CERT_C_EXACT_IMAGES - 1, exact_agree, CERT_C_EXACT_AGREEMENT,
              ", ".join("%.6f %d/%d" % (e["agreement"], e["instances"],
                                        e["instances_jax"])
                        for e in exact_vs_jax)), flush=True)
    print("  (c) %d images, %d of them exact; overflow %s; net %.2f s, "
          "hier %.2f s, exact %.2f s (%s)" % (
              r["images"], CERT_C_EXACT_IMAGES, r["overflow"],
              r["times_s"]["net"], r["times_s"]["hier"],
              r["times_s"]["exact"], smi), flush=True)
    gates = [("maps max abs", worst["max_abs"] <= CERT_PROBS_MAX_ABS),
             ("maps argmax", worst["argmax_differ"]
              <= CERT_PROBS_ARGMAX_DIFFER),
             ("zero overflow", not any(r["overflow"].values())),
             ("hier AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(r["hier"][0] - JAX_AP["c"]["hier"][0]) <= CERT_JAX_AP_TOL),
             ("exact masks' agreement with JAX's over images 0-%d"
              % (CERT_C_EXACT_IMAGES - 1),
              exact_agree >= CERT_C_EXACT_AGREEMENT),
             ("exact instance counts within %d of JAX's"
              % MAX_INSTANCE_DIFF, counts_ok)]
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("certification (c) gates failed: %s" % failed)
    return {"ap": {k: r[k] for k in ("hier", "exact")},
            "exact_vs_jax": exact_vs_jax,
            "exact_agreement": exact_agree,
            "exact_images": CERT_C_EXACT_IMAGES,
            "jax_ap": {"hier": JAX_AP["c"]["hier"],
                       "exact": JAX_AP["c_exact_0_7"]["exact"]},
            "summary_seed0": CERT_SUMMARY_SEED0, "maps_vs_fixtures": diffs,
            "overflow": r["overflow"], "times_s": r["times_s"],
            "images": r["images"],
            "phase_s": sw.totals["certification (c)"]}


def containers_phase(drive, paths, smi, sw, run, cert_c):
    """The raster containers cv2.imread reads (`data/{tiff,bmp,pxm,
    sunras,hdr,gif}.py` over `data/native/codecs.cc`, built by
    `start_jpeg_build`): every committed file of tests/fixtures/images
    decoded by `imgproc.imread_rgb` and held to cv2's SHA-256
    (`cv2_digests.json`); procedure (c)'s hier column scored from the 50
    val images as the data child wrote them in the lossless layouts
    (`certify.score` on the card: floodscan, absorb and tgather once per
    image), every read held to the SHA-256 of the same image's PNG
    pixels, AP and AP50 equal to "certification (c)"'s hier figures of
    this run and within CERT_JAX_AP_TOL of JAX's; the host's ms per
    512x1024 image for each layout (JPEG_REPS decodes of one file each,
    in turns)."""
    import hashlib

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import imgproc

    fixi = os.path.join(HERE, "tests", "fixtures", "images")
    with open(os.path.join(fixi, "cv2_digests.json")) as f:
        digests = json.load(f)
    wrong = []
    with sw.span("containers fixtures"):
        for rel, d in sorted(digests.items()):
            img = imgproc.imread_rgb(os.path.join(fixi, rel))
            if [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] \
                    != [d["shape"], d["sha256"]]:
                wrong.append(rel)
    print("  %d committed files (TIFF, BMP, PxM, PAM, PFM, Sun raster, "
          "HDR, GIF) decoded in %.2f s, %d differ from cv2's digest: %s"
          % (len(digests), sw.totals["containers fixtures"], len(wrong),
             wrong), flush=True)
    if wrong:
        raise AssertionError("container decodes differ from cv2's: %s"
                             % wrong)

    cdir, files = run["container_dir"], run["files"]
    offsets = io.load_offsets(FIX)
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                            9 + len(offsets))
    reads = {}  # what certify.score itself read, against the PNG pixels
    imread = imgproc.imread_rgb

    def hashed_imread(path):
        img = imread(path)
        reads[os.path.basename(path)] = [
            list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]
        return img

    imgproc.imread_rgb = hashed_imread
    try:
        with sw.span("containers (c) hier"):
            r = drive("containers", lambda: CT.score(net, cdir, 9, offsets,
                                                     ("hier",)),
                      ("floodscan", "absorb", "tgather"))
    finally:
        imgproc.imread_rgb = imread
    del net
    reads_equal = reads == {n: [f["shape"], f["sha256"]]
                            for n, f in files.items()}
    ap, cref, jref = r["hier"], cert_c["ap"]["hier"], JAX_AP["c"]["hier"]
    layouts = sorted({f["layout"] for f in files.values()})
    print("  (c) hier from %d files in %d layouts (%s): AP %.4f AP50 %.4f "
          "| certification (c) from PNG, this run: AP %.4f AP50 %.4f | JAX "
          "(CPU): AP %.4f AP50 %.4f; reads equal to the PNG pixels: %s; "
          "overflow %s, net %.2f s, hier %.2f s" % (
              len(files), len(layouts), " ".join(layouts), ap[0], ap[1],
              cref[0], cref[1], jref[0], jref[1], reads_equal,
              r["overflow"], r["times_s"]["net"], r["times_s"]["hier"]),
          flush=True)
    launches = dict(paths["containers"])
    gates = [("AP and AP50 equal to certification (c)'s",
              list(ap) == list(cref)),
             ("AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[0] - jref[0]) <= CERT_JAX_AP_TOL),
             ("AP50 within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[1] - jref[1]) <= CERT_JAX_AP_TOL),
             ("score's reads of the %d files equal to the PNG pixels"
              % len(files), reads_equal),
             ("zero overflow", not any(r["overflow"].values())),
             ("one launch of each kernel per image",
              all(launches.get(k) == r["images"]
                  for k in ("floodscan", "absorb", "tgather")))]

    # host ms per 512x1024 image, one file per layout, decoded in turns
    first = {}
    for name, f in sorted(files.items()):
        first.setdefault(f["layout"], name)
    spent = dict.fromkeys(first, 0.0)
    with sw.span("containers timing"):
        for _ in range(JPEG_REPS):
            for layout, name in first.items():
                t0 = time.perf_counter()
                imgproc.imread_rgb(os.path.join(cdir, "val", name))
                spent[layout] += time.perf_counter() - t0
    ms = {layout: spent[layout] / JPEG_REPS * 1e3 for layout in first}
    print("  ms per 512x1024 image, %d decodes each (host, %s): %s" % (
        JPEG_REPS, smi, ", ".join("%s %.3f" % kv for kv in sorted(
            ms.items()))), flush=True)
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("containers gates failed: %s" % failed)
    return {"fixtures": len(digests), "differ": wrong,
            "files": len(files), "layouts": layouts, "ap": ap,
            "certification_c_ap": cref, "jax_ap": jref,
            "reads_equal_png": reads_equal, "overflow": r["overflow"],
            "times_s": r["times_s"], "launches": launches,
            "ms_per_512x1024": ms, "reps": JPEG_REPS,
            "phase_s": sum(sw.totals[k] for k in (
                "containers fixtures", "containers (c) hier",
                "containers timing"))}


def webp_phase(drive, paths, smi, sw, data_dir, built):
    """WebP reading (`data/webp.py` over `data/native/webp.cc`, built by
    `start_jpeg_build`): every committed file of tests/fixtures/webp
    (lossy and lossless, crafted partitions, filters, palettes, alpha,
    EXIF and an animation) read by `imgproc.imread_rgb` and held to
    cv2's SHA-256 (`cv2_digests.json`); the lossless files held equal to
    the regenerated PNGs they came from; procedure (c)'s hier column
    scored from the 50 committed q90 WebPs of the val images
    (`certify.score` on the card: floodscan, absorb and tgather once per
    image), every read held to cv2's digest, AP and AP50 within
    CERT_JAX_AP_TOL of JAX's `c_webp` figure, zero overflow; the host's
    ms per 512x1024 image for VP8 and VP8L (JPEG_REPS decodes each, in
    turns)."""
    import hashlib
    import shutil

    import numpy as np

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import imgproc

    fixw = os.path.join(HERE, "tests", "fixtures", "webp")
    with open(os.path.join(fixw, "cv2_digests.json")) as f:
        digests = json.load(f)
    build_s = built.get("webp_build_s")
    wrong, lossless_equal, val_s = [], {}, 0.0
    with sw.span("webp fixtures"):
        for rel, d in sorted(digests.items()):
            t0 = time.perf_counter()
            img = imgproc.imread_rgb(os.path.join(fixw, rel))
            if rel.startswith("val/"):
                val_s += time.perf_counter() - t0
            if [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] \
                    != [d["shape"], d["sha256"]]:
                wrong.append(rel)
            if "png" in d:
                lossless_equal[rel] = bool(np.array_equal(img, io.read_png_rgb(
                    os.path.join(data_dir, "val", d["png"]))))
    val = sorted(r for r in digests if r.startswith("val/"))
    print("  decoder %s (g++, after the nvcc build); %d committed files "
          "decoded in %.2f s, %d differ from cv2's digest: %s; lossless "
          "files equal to the PNGs they came from: %s; 512x1024 q90 VP8 in "
          "(c)'s set: %.3f ms per image (host, %s)" % (
              "cached" if build_s is None else "built in %.2f s" % build_s,
              len(digests), sw.totals["webp fixtures"], len(wrong), wrong,
              lossless_equal, val_s / len(val) * 1e3, smi), flush=True)

    wdir = os.path.join(HERE, "mergenet_tpu_torch", "_build", "webp_data")
    shutil.rmtree(wdir, ignore_errors=True)
    os.makedirs(os.path.join(wdir, "annotations"))
    shutil.copytree(os.path.join(fixw, "val"), os.path.join(wdir, "val"))
    with open(os.path.join(data_dir, "annotations",
                           "instancesonly_val.json")) as f:
        ann = json.load(f)
    for im in ann["images"]:
        im["file_name"] = os.path.splitext(im["file_name"])[0] + ".webp"
    with open(os.path.join(wdir, "annotations", "instancesonly_val.json"),
              "w") as f:
        json.dump(ann, f)
    offsets = io.load_offsets(FIX)
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                            9 + len(offsets))
    reads = {}  # what certify.score itself read: held to cv2's digests
    imread = imgproc.imread_rgb

    def hashed_imread(path):
        img = imread(path)
        reads["val/" + os.path.basename(path)] = [
            list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]
        return img

    imgproc.imread_rgb = hashed_imread
    try:
        with sw.span("webp (c) hier"):
            r = drive("webp", lambda: CT.score(net, wdir, 9, offsets,
                                               ("hier",)),
                      ("floodscan", "absorb", "tgather"))
    finally:
        imgproc.imread_rgb = imread
    del net
    shutil.rmtree(wdir, ignore_errors=True)
    reads_equal = reads == {rel: [digests[rel]["shape"],
                                  digests[rel]["sha256"]] for rel in val}
    ap, jref = r["hier"], JAX_AP["c_webp"]["hier"]
    png = JAX_AP["c"]["hier"]
    print("  (c) hier from WebP: AP %.4f AP50 %.4f | JAX (CPU, cv2.imread) "
          "AP %.4f AP50 %.4f | from PNG, JAX: AP %.4f AP50 %.4f; reads of "
          "the %d WebPs equal to cv2's digests: %s; %d images, overflow %s, "
          "net %.2f s, hier %.2f s" % (
              ap[0], ap[1], jref[0], jref[1], png[0], png[1], len(val),
              reads_equal, r["images"], r["overflow"], r["times_s"]["net"],
              r["times_s"]["hier"]), flush=True)
    launches = dict(paths["webp"])
    gates = [("every committed file equal to cv2's digest", not wrong),
             ("the lossless files equal to their PNGs",
              bool(lossless_equal) and all(lossless_equal.values())),
             ("AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[0] - jref[0]) <= CERT_JAX_AP_TOL),
             ("AP50 within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[1] - jref[1]) <= CERT_JAX_AP_TOL),
             ("score's reads of the %d WebPs equal to cv2's digests"
              % len(val), reads_equal),
             ("zero overflow", not any(r["overflow"].values())),
             ("one launch of each kernel per image",
              all(launches.get(k) == r["images"]
                  for k in ("floodscan", "absorb", "tgather")))]

    # host ms per 512x1024 image: a lossy (VP8) and a lossless (VP8L)
    # file, decoded JPEG_REPS times in turns
    timed = {"vp8": "val/val_00000.webp", "vp8l": "lossless/val_00000.webp"}
    spent = dict.fromkeys(timed, 0.0)
    with sw.span("webp timing"):
        for _ in range(JPEG_REPS):
            for kind, rel in timed.items():
                t0 = time.perf_counter()
                imgproc.imread_rgb(os.path.join(fixw, rel))
                spent[kind] += time.perf_counter() - t0
    ms = {kind: spent[kind] / JPEG_REPS * 1e3 for kind in timed}
    print("  ms per 512x1024 image, %d decodes each (host, %s): VP8 q90 "
          "%.3f, VP8L %.3f" % (JPEG_REPS, smi, ms["vp8"], ms["vp8l"]),
          flush=True)
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("webp gates failed: %s" % failed)
    return {"build_s": build_s, "fixtures": len(digests), "differ": wrong,
            "lossless_equal_png": lossless_equal, "ap": ap, "jax_ap": jref,
            "png_jax_ap": png, "reads_equal_digests": reads_equal,
            "overflow": r["overflow"], "times_s": r["times_s"],
            "launches": launches, "ms_per_512x1024": ms, "reps": JPEG_REPS,
            "phase_s": sum(sw.totals[k] for k in (
                "webp fixtures", "webp (c) hier", "webp timing"))}


def jp2_phase(drive, paths, smi, sw, data_dir, built):
    """JPEG 2000 reading (`data/jp2.py` over `data/native/jp2.cc`, built
    by `start_jpeg_build`): every committed file of tests/fixtures/jp2
    read by `imgproc.imread_rgb` and held to cv2's SHA-256
    (`cv2_digests.json`; a file cv2 refuses must raise ValueError), the
    HTJ2K and Part 2 files among them; the four lossless files (an HTJ2K
    one among them) held equal to the regenerated PNGs they came from;
    procedure (c)'s hier column
    scored from the 50 committed val JP2s (`certify.score` on the card:
    floodscan, absorb and tgather once per image), each of score's reads
    held to cv2's digest (the val files are read there, once), AP and
    AP50 within CERT_JAX_AP_TOL of JAX's `c_jp2` figure, zero overflow;
    the host's ms per 512x1024 image for 9/7 + ICT and 5/3 + RCT files
    (Pillow's), cv2's own 5/3 files, lossy and lossless, and the HTJ2K
    files (5/3 + RCT lossless, 9/7 + ICT in three HT passes; JPEG_REPS
    decodes each, in turns)."""
    import hashlib
    import shutil

    import numpy as np

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import imgproc

    fixj = os.path.join(HERE, "tests", "fixtures", "jp2")
    with open(os.path.join(fixj, "cv2_digests.json")) as f:
        digests = json.load(f)
    build_s = built.get("jp2_build_s")
    val = sorted(r for r in digests if r.startswith("val/"))
    wrong, refused, lossless_equal = [], 0, {}
    with sw.span("jp2 fixtures"):
        for rel, d in sorted(digests.items()):
            if rel in val:
                continue  # read, and held to the digests, by the scoring
            path = os.path.join(fixj, rel)
            if d.get("cv2", 1) is None:
                try:
                    imgproc.imread_rgb(path)
                    wrong.append(rel)
                except ValueError:
                    refused += 1
                continue
            img = imgproc.imread_rgb(path)
            if [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] \
                    != [d["shape"], d["sha256"]]:
                wrong.append(rel)
            if "png" in d:
                lossless_equal[rel] = bool(np.array_equal(img, io.read_png_rgb(
                    os.path.join(data_dir, "val", d["png"]))))
    print("  decoder %s (g++, after the nvcc build); %d committed files "
          "outside val/ in %.2f s (%d refused as cv2 refuses them), %d "
          "differ from cv2: %s; lossless files equal to the PNGs they came "
          "from: %s" % (
              "cached" if build_s is None else "built in %.2f s" % build_s,
              len(digests) - len(val), sw.totals["jp2 fixtures"], refused,
              len(wrong), wrong, lossless_equal), flush=True)

    jdir = os.path.join(HERE, "mergenet_tpu_torch", "_build", "jp2_data")
    shutil.rmtree(jdir, ignore_errors=True)
    os.makedirs(os.path.join(jdir, "annotations"))
    shutil.copytree(os.path.join(fixj, "val"), os.path.join(jdir, "val"))
    with open(os.path.join(data_dir, "annotations",
                           "instancesonly_val.json")) as f:
        ann = json.load(f)
    for im in ann["images"]:
        im["file_name"] = os.path.splitext(im["file_name"])[0] + ".jp2"
    with open(os.path.join(jdir, "annotations", "instancesonly_val.json"),
              "w") as f:
        json.dump(ann, f)
    offsets = io.load_offsets(FIX)
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                            9 + len(offsets))
    reads, read_s = {}, [0.0]  # what certify.score read: held to cv2's
    imread = imgproc.imread_rgb

    def hashed_imread(path):
        t0 = time.perf_counter()
        img = imread(path)
        read_s[0] += time.perf_counter() - t0
        reads["val/" + os.path.basename(path)] = [
            list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]
        return img

    imgproc.imread_rgb = hashed_imread
    try:
        with sw.span("jp2 (c) hier"):
            r = drive("jp2", lambda: CT.score(net, jdir, 9, offsets,
                                              ("hier",)),
                      ("floodscan", "absorb", "tgather"))
    finally:
        imgproc.imread_rgb = imread
    del net
    shutil.rmtree(jdir, ignore_errors=True)
    reads_equal = reads == {rel: [digests[rel]["shape"],
                                  digests[rel]["sha256"]] for rel in val}
    ap, jref = r["hier"], JAX_AP["c_jp2"]["hier"]
    png = JAX_AP["c"]["hier"]
    print("  (c) hier from JPEG 2000: AP %.4f AP50 %.4f | JAX (CPU, "
          "cv2.imread) AP %.4f AP50 %.4f | from PNG, JAX: AP %.4f AP50 "
          "%.4f; reads of the %d JP2s equal to cv2's digests: %s (%.3f ms "
          "per image, host, %s); %d images, overflow %s, net %.2f s, hier "
          "%.2f s" % (
              ap[0], ap[1], jref[0], jref[1], png[0], png[1], len(val),
              reads_equal, read_s[0] / max(1, len(reads)) * 1e3, smi,
              r["images"], r["overflow"], r["times_s"]["net"],
              r["times_s"]["hier"]), flush=True)
    launches = dict(paths["jp2"])
    gates = [("every committed file as cv2's digest says", not wrong),
             ("the lossless files equal to their PNGs",
              len(lossless_equal) == 4 and all(lossless_equal.values())),
             ("the lossless HTJ2K read of val 0 equal to its PNG",
              lossless_equal.get("ht/val_00000_53_rct_ht.jp2") is True),
             ("AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[0] - jref[0]) <= CERT_JAX_AP_TOL),
             ("AP50 within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[1] - jref[1]) <= CERT_JAX_AP_TOL),
             ("score's reads of the %d JP2s equal to cv2's digests"
              % len(val), reads_equal),
             ("zero overflow", not any(r["overflow"].values())),
             ("one launch of each kernel per image",
              all(launches.get(k) == r["images"]
                  for k in ("floodscan", "absorb", "tgather")))]

    # host ms per 512x1024 image, JPEG_REPS decodes each in turns
    timed = {"97_ict": "pillow/val_00000_97_ict.jp2",
             "53_rct_lossless": "pillow/val_00000_53_rct.jp2",
             "cv2_53_lossy": "val/val_00000.jp2",
             "cv2_53_lossless": "lossless/val_00000.jp2",
             "ht_53_rct_lossless": "ht/val_00000_53_rct_ht.jp2",
             "ht_97_ict": "ht/val_00000_97_ict_ht.jp2"}
    spent = dict.fromkeys(timed, 0.0)
    with sw.span("jp2 timing"):
        for _ in range(JPEG_REPS):
            for kind, rel in timed.items():
                t0 = time.perf_counter()
                imgproc.imread_rgb(os.path.join(fixj, rel))
                spent[kind] += time.perf_counter() - t0
    ms = {kind: spent[kind] / JPEG_REPS * 1e3 for kind in timed}
    print("  ms per 512x1024 image, %d decodes each (host, %s): 9/7 + ICT "
          "(157 KB) %.3f, 5/3 + RCT lossless %.3f, cv2's 5/3 at 1/10 %.3f, "
          "cv2's 5/3 lossless %.3f; HTJ2K 5/3 + RCT lossless (1.1 MB) %.3f, "
          "HTJ2K 9/7 + ICT, 3 passes (249 KB) %.3f" % (
              JPEG_REPS, smi, ms["97_ict"], ms["53_rct_lossless"],
              ms["cv2_53_lossy"], ms["cv2_53_lossless"],
              ms["ht_53_rct_lossless"], ms["ht_97_ict"]), flush=True)
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("jp2 gates failed: %s" % failed)
    return {"build_s": build_s, "fixtures": len(digests), "differ": wrong,
            "refused": refused, "lossless_equal_png": lossless_equal,
            "ap": ap, "jax_ap": jref, "png_jax_ap": png,
            "reads_equal_digests": reads_equal,
            "read_ms_per_image": read_s[0] / max(1, len(reads)) * 1e3,
            "overflow": r["overflow"], "times_s": r["times_s"],
            "launches": launches, "ms_per_512x1024": ms, "reps": JPEG_REPS,
            "phase_s": sum(sw.totals[k] for k in (
                "jp2 fixtures", "jp2 (c) hier", "jp2 timing"))}


def avif_phase(smi, sw, data_dir, built):
    """AVIF reading (`data/avif.py` over `data/native/avif.cc`, built by
    `start_jpeg_build`; host only, no kernel): every committed file of
    tests/fixtures/avif read by `imgproc.imread_rgb` and held to cv2's
    SHA-256 (`cv2_digests.json`; a file cv2 refuses must raise
    ValueError, a file with a tool the port does not read yet must raise
    "not yet read" naming it); val 0 and val 1, written lossless by cv2
    (identity matrix, 4:4:4), held equal to the regenerated PNGs they
    came from; the host's ms per 512x1024 image for cv2's lossless file,
    Pillow's lossless 4:2:0, Pillow's 4:2:0 with the in-loop filters off
    at qualities 70 and 30, and cv2's 10-bit file with its later tools
    switched off (JPEG_REPS decodes each, in turns)."""
    import hashlib

    import numpy as np

    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import avif, imgproc

    fixa = os.path.join(HERE, "tests", "fixtures", "avif")
    with open(os.path.join(fixa, "cv2_digests.json")) as f:
        digests = json.load(f)
    build_s = built.get("avif_build_s")
    wrong, refused, not_yet, lossless_equal = [], 0, 0, {}
    with sw.span("avif fixtures"):
        for rel, d in sorted(digests.items()):
            path = os.path.join(fixa, rel)
            if d["sha256"] is None or "not_yet" in d:
                try:
                    imgproc.imread_rgb(path)
                    wrong.append(rel)
                except ValueError as e:
                    later = avif.NOT_YET in str(e)
                    if "not_yet" in d and later and d["not_yet"] in str(e):
                        not_yet += 1
                    elif "not_yet" not in d and not later:
                        refused += 1
                    else:
                        wrong.append(rel)
                continue
            img = imgproc.imread_rgb(path)
            if [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()] \
                    != [d["shape"], d["sha256"]]:
                wrong.append(rel)
            if "png" in d:
                lossless_equal[rel] = bool(np.array_equal(img, io.read_png_rgb(
                    os.path.join(data_dir, "val", d["png"]))))
    print("  decoder %s (g++, after the nvcc build); %d committed files in "
          "%.2f s (%d refused as cv2 refuses them, %d not yet read), %d "
          "differ from cv2: %s; lossless files equal to the PNGs they came "
          "from: %s" % (
              "cached" if build_s is None else "built in %.2f s" % build_s,
              len(digests), sw.totals["avif fixtures"], refused, not_yet,
              len(wrong), wrong, lossless_equal), flush=True)
    gates = [("every committed file as cv2's digest says", not wrong),
             ("the lossless files equal to their PNGs",
              len(lossless_equal) == 2 and all(lossless_equal.values()))]

    # host ms per 512x1024 image, JPEG_REPS decodes each in turns
    timed = {"cv2_lossless": "lossless/val_00000.avif",
             "pillow_lossless_420": "val/pil_lossless_420.avif",
             "pillow_q70_420": "val/pil_q70_nofilter.avif",
             "pillow_q30_420": "val/pil_q30_nofilter.avif",
             "cv2_10bit_q60": "val/cv2_10bit_q60_stripped.avif"}
    spent = dict.fromkeys(timed, 0.0)
    with sw.span("avif timing"):
        for _ in range(JPEG_REPS):
            for kind, rel in timed.items():
                t0 = time.perf_counter()
                imgproc.imread_rgb(os.path.join(fixa, rel))
                spent[kind] += time.perf_counter() - t0
    ms = {kind: spent[kind] / JPEG_REPS * 1e3 for kind in timed}
    sizes = {kind: os.path.getsize(os.path.join(fixa, rel))
             for kind, rel in timed.items()}
    print("  ms per 512x1024 image, %d decodes each (host, %s): cv2 "
          "lossless 4:4:4 (%d B) %.3f, Pillow lossless 4:2:0 (%d B) %.3f, "
          "Pillow q70 4:2:0 (%d B) %.3f, Pillow q30 4:2:0 (%d B) %.3f, "
          "cv2 10-bit q60 (%d B) %.3f" % (
              JPEG_REPS, smi, sizes["cv2_lossless"], ms["cv2_lossless"],
              sizes["pillow_lossless_420"], ms["pillow_lossless_420"],
              sizes["pillow_q70_420"], ms["pillow_q70_420"],
              sizes["pillow_q30_420"], ms["pillow_q30_420"],
              sizes["cv2_10bit_q60"], ms["cv2_10bit_q60"]), flush=True)
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("avif gates failed: %s" % failed)
    return {"build_s": build_s, "fixtures": len(digests), "differ": wrong,
            "refused": refused, "not_yet": not_yet,
            "lossless_equal_png": lossless_equal, "ms_per_512x1024": ms,
            "bytes": sizes, "reps": JPEG_REPS,
            "phase_s": sum(sw.totals[k] for k in ("avif fixtures",
                                                  "avif timing"))}


def tiff_phase(drive, paths, smi, sw, data_dir, jpeg_r):
    """JPEG-in-TIFF reading (`data/tiff.py` over `data/native/jpeg.cc`'s
    strip entry): the 50 committed q90 val JPEGs rewrapped as TIFFs
    (compression 7, photometric 6, YCbCrSubsampling 2x2;
    `tests/tiff_craft.jpeg_tiff`) in two layouts, the whole stream as
    the one strip and its tables in a JPEGTables tag before an
    abbreviated strip, each read by `imgproc.imread_rgb` and held to
    cv2's digest of the JPEG (what the jpeg phase's reads were held to);
    procedure (c)'s hier column scored from the JPEGTables layout
    (`certify.score` on the card: floodscan, absorb and tgather once per
    image), its reads hashed, AP and AP50 equal to the jpeg phase's of
    this run and within CERT_JAX_AP_TOL of JAX's `c_jpeg`, zero
    overflow; the host's ms per 512x1024 image for each layout and for
    the other TIFF kinds this slice reads, written at 512x1024 from
    bench_img.png (CCITT T.4 2-D and T.6, YCbCr 2x2 LZW, FillOrder 2
    LZW with predictor 2, a 4:4:4 JPEG in 256x256 tiles as RGB, CIELab,
    SGILog LogLuv and LogLuv24, ThunderScan raw pixels; JPEG_REPS
    decodes each, in turns)."""
    import hashlib
    import shutil

    import numpy as np

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import imgproc

    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import container_craft as cc
    import tiff_craft as tc

    fixj = os.path.join(HERE, "tests", "fixtures", "jpeg")
    with open(os.path.join(fixj, "cv2_digests.json")) as f:
        digests = json.load(f)
    val = sorted(r for r in digests if r.startswith("val/"))
    tdir = os.path.join(HERE, "mergenet_tpu_torch", "_build", "tiff_data")
    shutil.rmtree(tdir, ignore_errors=True)
    layouts = ("strip", "tables")
    want = {}
    with sw.span("tiff write"):
        for layout in layouts:
            os.makedirs(os.path.join(tdir, layout, "val"))
        for rel in val:
            with open(os.path.join(fixj, rel), "rb") as f:
                stream = f.read()
            name = os.path.splitext(os.path.basename(rel))[0] + ".tif"
            for layout in layouts:
                with open(os.path.join(tdir, layout, "val", name), "wb") as f:
                    f.write(tc.jpeg_tiff([stream], tc.jpeg_size(stream),
                                         tables=layout == "tables"))
            want["val/" + name] = [digests[rel]["shape"],
                                   digests[rel]["sha256"]]
    wrong = []
    read_s = dict.fromkeys(layouts, 0.0)
    with sw.span("tiff reads"):
        for layout in layouts:
            for rel in sorted(want):
                t0 = time.perf_counter()
                img = imgproc.imread_rgb(os.path.join(tdir, layout, rel))
                read_s[layout] += time.perf_counter() - t0
                if [list(img.shape), hashlib.sha256(
                        img.tobytes()).hexdigest()] != want[rel]:
                    wrong.append((layout, rel))
    print("  %d q90 val JPEGs rewrapped as JPEG-in-TIFF in %d layouts "
          "(%.2f s); %d reads differ from the JPEGs' cv2 digests: %s; ms "
          "per image, first reads (host, %s): %s" % (
              len(val), len(layouts), sw.totals["tiff write"], len(wrong),
              wrong[:4], smi, ", ".join(
                  "%s %.3f" % (k, read_s[k] / len(val) * 1e3)
                  for k in layouts)), flush=True)

    sdir = os.path.join(tdir, "tables")
    os.makedirs(os.path.join(sdir, "annotations"))
    with open(os.path.join(data_dir, "annotations",
                           "instancesonly_val.json")) as f:
        ann = json.load(f)
    for im in ann["images"]:
        im["file_name"] = os.path.splitext(im["file_name"])[0] + ".tif"
    with open(os.path.join(sdir, "annotations", "instancesonly_val.json"),
              "w") as f:
        json.dump(ann, f)
    offsets = io.load_offsets(FIX)
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"),
                            9 + len(offsets))
    reads = {}
    imread = imgproc.imread_rgb

    def hashed_imread(path):
        img = imread(path)
        reads["val/" + os.path.basename(path)] = [
            list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]
        return img

    imgproc.imread_rgb = hashed_imread
    try:
        with sw.span("tiff (c) hier"):
            r = drive("tiff", lambda: CT.score(net, sdir, 9, offsets,
                                               ("hier",)),
                      ("floodscan", "absorb", "tgather"))
    finally:
        imgproc.imread_rgb = imread
    del net
    reads_equal = reads == want
    ap, jref, jpeg_ap = r["hier"], JAX_AP["c_jpeg"]["hier"], jpeg_r["ap"]
    print("  (c) hier from JPEG-in-TIFF (JPEGTables layout): AP %.4f AP50 "
          "%.4f | this run's jpeg phase AP %.4f AP50 %.4f | JAX (CPU, "
          "cv2.imread of the JPEGs) AP %.4f AP50 %.4f; score's reads equal "
          "to the JPEGs' digests: %s; %d images, overflow %s, net %.2f s, "
          "hier %.2f s" % (
              ap[0], ap[1], jpeg_ap[0], jpeg_ap[1], jref[0], jref[1],
              reads_equal, r["images"], r["overflow"], r["times_s"]["net"],
              r["times_s"]["hier"]), flush=True)
    launches = dict(paths["tiff"])
    gates = [("every read equal to the JPEG's", not wrong),
             ("AP and AP50 equal to the jpeg phase's",
              list(ap) == list(jpeg_ap)),
             ("AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[0] - jref[0]) <= CERT_JAX_AP_TOL),
             ("AP50 within %.3f of JAX's" % CERT_JAX_AP_TOL,
              abs(ap[1] - jref[1]) <= CERT_JAX_AP_TOL),
             ("score's reads of the %d TIFFs equal to the JPEGs' digests"
              % len(val), reads_equal),
             ("zero overflow", not any(r["overflow"].values())),
             ("one launch of each kernel per image",
              all(launches.get(k) == r["images"]
                  for k in ("floodscan", "absorb", "tgather")))]

    # host ms per 512x1024 image: the two layouts and the other kinds,
    # written from bench_img.png, JPEG_REPS decodes each in turns
    rgb = io.read_png_rgb(os.path.join(FIX, "bench_img.png"))
    bilevel = (rgb.astype(np.int32).sum(-1) < 384).astype(np.uint8)
    with open(os.path.join(fixj, val[0]), "rb") as f:
        first = f.read()
    tiles444 = [_jpeg_444(rgb[y:y + 256, x:x + 256])
                for y in range(0, 512, 256) for x in range(0, 1024, 256)]
    grey = rgb.astype(np.int64).sum(-1) // 3
    le = 12000 + grey * 18  # log luminances about 1/64 to 1
    luv32 = le << 16 | (rgb[..., 0].astype(np.int64) // 4 + 60) << 8 | (
        rgb[..., 2].astype(np.int64) // 4 + 110)
    luv24 = (le >> 6) << 14 | (rgb[..., 0].astype(np.int64) << 6 | (
        rgb[..., 2].astype(np.int64) >> 2))
    kinds = {
        "jpeg_strip": tc.jpeg_tiff([first], tc.jpeg_size(first)),
        "jpeg_tables": tc.jpeg_tiff([first], tc.jpeg_size(first),
                                    tables=True),
        "ccitt_t4_2d": tc.fax_tiff(bilevel, 3, options=1, fill=True,
                                   rows_per_strip=64),
        "ccitt_t6": tc.fax_tiff(bilevel, 4),
        "ycbcr22_lzw": cc.tiff_bytes(rgb, photometric=6, subsampling=(2, 2),
                                     compression=5, rows_per_strip=64),
        "fill_order2_lzw_pred2": cc.tiff_bytes(
            rgb, compression=5, predictor=2, rows_per_strip=64,
            fill_order=2),
        "jpeg_rgb_444_tiles": tc.jpeg_tiff(tiles444, (512, 1024),
                                           photometric=2, tile=(256, 256)),
        "cielab8": cc.tiff_bytes(rgb, photometric=8, rows_per_strip=64),
        "sgilog_logluv": _as_compression(cc.tiff_bytes(
            np.zeros((512, 1024, 3), np.uint8), bits=16, photometric=32845,
            blocks=[tc.sgilog_strip(luv32, 4)]), 34676),
        "sgilog24": _as_compression(cc.tiff_bytes(
            np.zeros((512, 1024, 3), np.uint8), bits=16, photometric=32845,
            blocks=[luv24.astype(">u4").view(np.uint8).reshape(
                512, 1024, 4)[..., 1:].tobytes()]), 34677),
        "thunderscan_raw": _as_compression(cc.tiff_bytes(
            np.zeros((512, 1024, 1), np.uint8), bits=4, photometric=3,
            colormap=np.arange(48).reshape(16, 3) * 1365,
            blocks=[(0xC0 | (rgb[..., 1] >> 4)).tobytes()]), 32809)}
    kdir = os.path.join(tdir, "kinds")
    os.makedirs(kdir)
    for kind, data in kinds.items():
        with open(os.path.join(kdir, kind + ".tif"), "wb") as f:
            f.write(data)
    spent = dict.fromkeys(kinds, 0.0)
    with sw.span("tiff timing"):
        for _ in range(JPEG_REPS):
            for kind in kinds:
                t0 = time.perf_counter()
                imgproc.imread_rgb(os.path.join(kdir, kind + ".tif"))
                spent[kind] += time.perf_counter() - t0
    ms = {kind: spent[kind] / JPEG_REPS * 1e3 for kind in kinds}
    print("  ms per 512x1024 image, %d decodes each (host, %s): %s" % (
        JPEG_REPS, smi, ", ".join("%s %.3f" % kv for kv in ms.items())),
        flush=True)
    shutil.rmtree(tdir, ignore_errors=True)
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("tiff gates failed: %s" % failed)
    return {"files": len(val) * len(layouts), "differ": wrong,
            "read_ms_per_image": {k: read_s[k] / len(val) * 1e3
                                  for k in layouts},
            "ap": ap, "jpeg_phase_ap": jpeg_ap, "jax_ap": jref,
            "reads_equal_digests": reads_equal, "overflow": r["overflow"],
            "times_s": r["times_s"], "launches": launches,
            "ms_per_512x1024": ms, "reps": JPEG_REPS,
            "phase_s": sum(sw.totals[k] for k in (
                "tiff write", "tiff reads", "tiff (c) hier",
                "tiff timing"))}


def _as_compression(data, compression):
    """A little-endian TIFF of container_craft's (compression 1) marked
    with another compression: its strips are that codec's data."""
    return data.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                        b"\x03\x01\x03\x00\x01\x00\x00\x00"
                        + compression.to_bytes(2, "little"))


def _jpeg_444(rgb):
    """A 4:4:4 baseline JPEG of the RGB planes of `rgb` (no colour
    transform: a TIFF of photometric 2 reads them as they are) from the
    tests' writer (`tests/jpeg_craft.py`: a float DCT, flat tables 8 and
    12, T.81's Annex K Huffman tables); the port writes no JPEG."""
    import jpeg_craft as jc
    import numpy as np

    h, w = rgb.shape[:2]
    comps = [(1, 1, 0), (1, 1, 1), (1, 1, 1)]
    q = {0: np.full(64, 8), 1: np.full(64, 12)}
    coefs = [jc.dct_blocks(rgb[..., c], jc.blocks_shape(comps, c, w, h),
                           q[min(c, 1)]) for c in range(3)]
    return jc.write_jpeg(comps, w, h, coefs, q, jfif=False, adobe=0,
                         annex_k=True)


def cert_d_phase(drive, smi, sw, data_dir):
    """Procedure (d): seed 0 trained on the regenerated data through the
    port's loader (`certify.train_seed`: the compact pipeline, 24 epochs
    of batch 8 at 384^2, float32, TF32 off, a validation pass per epoch),
    then `model_best` scored with hier decodes on the 50 val images;
    gates: the loss falls, hier AP >= CERT_D_MIN_HIER_AP."""
    import shutil

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io

    offsets = io.load_offsets(FIX)
    exp = os.path.join(HERE, "mergenet_tpu_torch", "_build", "cert_seed0")
    shutil.rmtree(exp, ignore_errors=True)
    with sw.span("certification (d) loader alone"):
        rate, n_loaded = CT.loader_rate(data_dir)
    with sw.span("certification (d) train"):
        hist = drive("certification (d) train", lambda: CT.train_seed(
            exp, data_dir, seed=0, epochs=CERT_D_EPOCHS), ())
    net = CT.load_trained(exp)
    with sw.span("certification (d) score"):
        r = drive("certification (d) score", lambda: CT.score(
            net, data_dir, 9, offsets, ("hier",)),
            ("floodscan", "absorb", "tgather"))
    del net
    shutil.rmtree(exp, ignore_errors=True)
    steps = sum(hist["steps"])
    step_s = sum(hist["step_s"])
    out = {"loader_images_per_s": rate, "loader_images": n_loaded,
           "train_images_per_s": steps * hist["batch_size"] / step_s,
           "epoch_s_median": sorted(hist["epoch_s"])[len(hist["epoch_s"])
                                                     // 2],
           "epoch_s": hist["epoch_s"], "loss": hist["loss"],
           "val": hist["val"], "steps": steps,
           "loader_wait_s": sum(hist["loader_wait_s"]),
           "train_s": sw.totals["certification (d) train"],
           "hier": r["hier"], "overflow": r["overflow"],
           "times_s": r["times_s"]}
    print("  (d) loader alone %.1f images/s (%d images); training %.1f "
          "images/s over %d steps (batch %d, 384^2, float32), epoch %.2f s "
          "(median, with its validation pass), loader waits %.2f s of %.2f "
          "s; loss %.4f -> %.4f; best val %.4f (%s)" % (
              rate, n_loaded, out["train_images_per_s"], steps,
              hist["batch_size"], out["epoch_s_median"],
              out["loader_wait_s"], step_s, hist["loss"][0],
              hist["loss"][-1], hist["best_val"], smi), flush=True)
    print("  (d) hier AP %.4f AP50 %.4f on %d images (limit AP >= %.4f); "
          "overflow %s" % (r["hier"][0], r["hier"][1], r["images"],
                           CERT_D_MIN_HIER_AP, r["overflow"]), flush=True)
    if not hist["loss"][-1] < hist["loss"][0]:
        raise AssertionError("certification (d): the loss did not fall: %s"
                             % hist["loss"])
    if r["hier"][0] < CERT_D_MIN_HIER_AP:
        raise AssertionError("certification (d): hier AP %.4f < %.4f"
                             % (r["hier"][0], CERT_D_MIN_HIER_AP))
    return out


def _stage_ms(text):
    """{stage: ms} from the shell twin's "stage <n> done in <ms> ms"."""
    import re
    return {int(m.group(1)): int(m.group(2)) for m in re.finditer(
        r"stage (\d) done in (\d+) ms", text)}


def _first_loss(path):
    """The first step's loss of a train recipe's log: its
    "Train: [0][0/n] ... Loss <v> (<avg>)" line."""
    import re
    with open(path) as f:
        m = re.search(r"Train: \[0\]\[0/\d+\].*?Loss ([0-9.]+)",
                      f.read())
    if m is None:
        raise AssertionError("no first-step loss in %s" % path)
    return float(m.group(1))


def _launch_log(path):
    """Launch counts summed over the lines of a MERGENET_LAUNCH_LOG."""
    import collections
    total = collections.Counter()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                total.update(json.loads(line))
    return total


def recipes_start(data_dir):
    """Start the port's recipes as users run them, as subprocesses, on the
    50 regenerated 512x1024 val images of `data_dir` (`recipes_phase`
    joins them; the card phases between run beside their host-bound
    chain):

    - the committed PSPFPNet-r50 split into a class-only and an
      offset-only port checkpoint (the head's first 9 and last 10
      output channels; their maps within RECIPE_HEAD_TOL of the combined
      net's on image 0) and an 'all' one;
    - `infer_pspfpnet.sh` stages 0-4 (class_infer, offset_infer,
      segment --decoder device --visualize, evaluate, submit; the maps
      are at the default seg-size, so segment derives the training
      offsets): every exit code 0, hier AP within
      CERT_JAX_AP_TOL of JAX's (c), floodscan and absorb launched at
      least once per image, the overlay of image 0 equal to
      `visualize_mask`'s array;
    - segment at the recipe's 2x shrink (`--seg-size 512 256`, the
      offsets derived as generate_offsets(40, 10)) of the first
      RECIPE_HALF_IMAGES maps, on the card and on the CPU (started
      beside the chain once offset_infer is done): the same instances;
    - `infer_e2e` (batch 1, hier, float32, decoded at 512x1024): AP
      within the same tolerance;
    - the train recipe at `run_pspfpnet_crop.sh`'s arch and alpha
      (crop 384, batch 8, RECIPE_TRAIN_ARGS) plainly and under
      `torchrun --standalone --nproc_per_node 1` (NCCL, the mesh path),
      started together with infer_e2e while the chain runs (the jobs
      beside the chain at niceness RECIPE_BESIDE_NICE): both write
      checkpoint and model_best, their first-step losses agree within
      RECIPE_LOSS_RTOL, the torchrun checkpoint loads back;
    - data-parallel serving at world size 1 (a FileStore NCCL group in
      this process) equal to the plain serve on 2 frames.

    The subprocesses report their kernel launches through
    MERGENET_LAUNCH_LOG (`ops/_build.py`).  Returns the run's state."""
    import shutil
    import subprocess
    import threading

    import numpy as np
    import torch

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import imgproc
    from mergenet_tpu_torch.models import PSPFPNet
    from mergenet_tpu_torch.parallel import train as T
    from mergenet_tpu_torch.utils.checkpoint import save_checkpoint

    cuda = torch.device("cuda")
    work = os.path.join(HERE, "mergenet_tpu_torch", "_build", "recipes")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    offsets = io.load_offsets(FIX)
    C, O = 9, len(offsets)
    val_img = os.path.join(data_dir, "val")
    val_ann = os.path.join(data_dir, "annotations", "instancesonly_val.json")
    net = CT.load_bench_net(os.path.join(FIX, "bench_ckpt.npz"), C + O)
    tx = T.make_optimizer()

    def checkpoint(name, n, lo, offs):
        sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        for k in ("FPNModule_0.Conv_1.weight", "FPNModule_0.Conv_1.bias"):
            sd[k] = sd[k][lo:lo + n]
        m = PSPFPNet(n)
        m.load_state_dict(sd)
        save_checkpoint(os.path.join(work, name), T.TrainState(
            step=0, model=m, optimizer=tx.init(m.parameters()), tx=tx),
            True, offsets=offs, epoch=0)
        return m.to(cuda).eval()

    x = torch.as_tensor(imgproc.imread_rgb(os.path.join(
        val_img, "val_00000.png")).astype(np.float32)[None] / 256.0,
        device=cuda)
    with torch.no_grad():
        full = torch.sigmoid(net(x))
        head_err = max(
            float((torch.sigmoid(checkpoint("cls", C, 0, None)(x))
                   - full[..., :C]).abs().max()),
            float((torch.sigmoid(checkpoint("ofs", O, C, offsets)(x))
                   - full[..., C:]).abs().max()))
    checkpoint("all", C + O, 0, offsets)
    print("  split heads: class/offset maps vs the combined net's on "
          "image 0: max abs %.3e (limit %.0e)" % (head_err, RECIPE_HEAD_TOL),
          flush=True)
    if not head_err <= RECIPE_HEAD_TOL:
        raise AssertionError("split heads differ: %.3e" % head_err)

    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    py = [sys.executable, "-m"]
    train_args = ["--arch", "pspfpnet", "--alpha", "20", "--crop",
                  "--crop-size", str(RECIPE_CROP), "--batch-size",
                  str(RECIPE_BATCH), "--log-freq", "100", "--pretrain",
                  "--tensorboard", "--print-freq", "1",
                  "--train-img", os.path.join(data_dir, "train"),
                  "--train-ann", os.path.join(data_dir, "annotations",
                                              "instancesonly_train.json"),
                  "--val-img", val_img, "--val-ann", val_ann
                  ] + RECIPE_TRAIN_ARGS
    recipe = "mergenet_tpu_torch.egs.cityscape."
    background = {
        "train": py + [recipe + "train", os.path.join(work, "train")]
        + train_args,
        "train torchrun": py + ["torch.distributed.run", "--standalone",
                                "--nproc_per_node", "1", "-m",
                                recipe + "train",
                                os.path.join(work, "train_ddp")]
        + train_args,
        "infer_e2e": py + [recipe + "infer_e2e", "--dir",
                           os.path.join(work, "e2e"), "--model",
                           os.path.join(work, "all", "model_best"),
                           "--img", val_img, "--ann", val_ann,
                           "--decode-size", "512", "1024"]}
    procs, logs = {}, {}
    chain_cmd = ["bash", os.path.join(HERE, "mergenet_tpu_torch", "egs",
                                      "cityscape", "infer_pspfpnet.sh"),
                 "--dir", os.path.join(work, "seg"),
                 "--class-dir", os.path.join(work, "cls"),
                 "--offset-dir", os.path.join(work, "ofs"),
                 "--img", val_img, "--ann", val_ann, "--test-ann", val_ann]
    # the recipe's own geometry: maps shrunk 2x (cv2's area-fast route at
    # 9 and 10 channels) and the offsets derived for it, on the card and
    # on the CPU
    half = {dev: py + [recipe + "segment", "--dir", os.path.join(
        work, "half"), "--segment", dev, "--class-dir", os.path.join(
        work, "cls"), "--offset-dir", os.path.join(work, "ofs"), "--img",
        val_img, "--ann", val_ann, "--seg-size", "512", "256", "--limits",
        str(RECIPE_HALF_IMAGES), "--device", dev] for dev in ("cuda", "cpu")}

    def start(name, cmd, tag, nice=RECIPE_BESIDE_NICE):
        logs[name] = os.path.join(work, tag + ".log")
        procs[name] = subprocess.Popen(
            (["nice", "-n", str(nice)] if nice else []) + cmd, cwd=work,
            stdout=open(logs[name], "w"), stderr=subprocess.STDOUT,
            env=dict(env, MERGENET_LAUNCH_LOG=os.path.join(
                work, tag + ".launches")))
        return procs[name]

    def chain_text():
        with open(logs["infer_pspfpnet.sh"]) as f:
            return f.read()

    t0 = time.perf_counter()
    for name, cmd in background.items():
        start(name, cmd, name.replace(" ", "_"))
    chain = start("infer_pspfpnet.sh", chain_cmd, "chain", nice=0)

    def watch():  # the 2x-shrink segments start once offset_infer is done
        while chain.poll() is None and "stage 1 done" not in chain_text():
            time.sleep(0.5)
        if chain.poll() in (None, 0):
            for dev, cmd in half.items():
                start("segment 2x shrink " + dev, cmd, "half_" + dev)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    return {"work": work, "net": net, "tx": tx, "offsets": offsets,
            "val_img": val_img, "val_ann": val_ann, "head_err": head_err,
            "procs": procs, "logs": logs, "chain": chain,
            "watcher": watcher, "t0": t0, "chain_text": chain_text}


def recipes_stop(rec):
    """Kill the recipes' subprocesses that still run."""
    for p in list(rec["procs"].values()):
        if p.poll() is None:
            p.kill()
            p.wait()


def recipes_phase(drive, paths, smi, sw, rec):
    """Join the recipes `recipes_start` started (the gates its docstring
    lists), then serve on a world-size-1 mesh."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.data import COCO, imgproc, rle
    from mergenet_tpu_torch.models import get_model
    from mergenet_tpu_torch.ops import _build
    from mergenet_tpu_torch.parallel import make_mesh
    from mergenet_tpu_torch.parallel import train as T
    from mergenet_tpu_torch.serving import build_serving_pipeline
    from mergenet_tpu_torch.utils.checkpoint import load_checkpoint
    from mergenet_tpu_torch.utils.visualization import visualize_mask

    work, net, tx, offsets = rec["work"], rec["net"], rec["tx"], \
        rec["offsets"]
    val_img, val_ann, head_err = rec["val_img"], rec["val_ann"], \
        rec["head_err"]
    procs, logs, chain = rec["procs"], rec["logs"], rec["chain"]
    chain_text = rec["chain_text"]
    C, O = 9, len(offsets)

    def wait_all():
        chain.wait(timeout=RECIPE_TIMEOUT_S)
        chain_s = time.perf_counter() - rec["t0"]
        rec["watcher"].join()
        rcs = {n: p.wait(timeout=RECIPE_TIMEOUT_S) for n, p in procs.items()}
        _build.LAUNCHES.update(_launch_log(os.path.join(
            work, "chain.launches")))
        return chain_s, rcs

    try:
        with sw.span("recipes"):
            chain_s, rcs = drive("recipes", wait_all, ("floodscan", "absorb"))
    finally:
        recipes_stop(rec)
    chain_out = chain_text()
    print("  exit codes: %s; chain %.2f s; stages (ms, with training, "
          "infer_e2e and the 2x-shrink segments running beside them at "
          "niceness %d): %s"
          % (rcs, chain_s, RECIPE_BESIDE_NICE, _stage_ms(chain_out)),
          flush=True)
    if any(rcs.values()):
        for name, path in list(logs.items()):
            with open(path) as f:
                print("  --- %s (tail) ---\n%s" % (name, f.read()[-3000:]))
        raise AssertionError("a recipe failed: %s" % rcs)
    for name in ("infer_e2e", "train", "train torchrun"):
        paths["recipes " + name] = dict(_launch_log(os.path.join(
            work, name.replace(" ", "_") + ".launches")))
    paths["recipes segment 2x shrink"] = dict(_launch_log(os.path.join(
        work, "half_cuda.launches")))
    print("  launches: infer_e2e %s, train %s, train torchrun %s" % (
        paths["recipes infer_e2e"], paths["recipes train"],
        paths["recipes train torchrun"]), flush=True)

    # the chain's and infer_e2e's AP, from their pkls as evaluate reads
    # them (the printed table has 3 decimals)
    import pickle

    from mergenet_tpu_torch.core import generate_offsets
    coco = COCO(val_ann)

    def pkl_results(seg):
        out = []
        pkl = os.path.join(seg, "pkl")
        for fname in sorted(os.listdir(pkl)):
            with open(os.path.join(pkl, fname), "rb") as f:
                out += [r for r in pickle.load(f)
                        if rle.area(r["segmentation"]) > 0]
        return out

    seg_dir = os.path.join(work, "seg", "segment_512")
    half_res = {}
    for dev in ("cuda", "cpu"):
        pkl = os.path.join(work, "half", dev, "pkl")
        half_res[dev] = {}
        for fname in sorted(os.listdir(pkl)):
            with open(os.path.join(pkl, fname), "rb") as f:
                half_res[dev][fname] = {
                    (r["category_id"], r["segmentation"]["counts"])
                    for r in pickle.load(f)}
    with open(logs["segment 2x shrink cuda"]) as f:
        half_offsets = [ln for ln in f.read().splitlines()
                        if ln.startswith("offsets are: ")]
    half_equal = (len(half_res["cuda"]) == RECIPE_HALF_IMAGES
                  and half_res["cuda"] == half_res["cpu"])
    half_40 = half_offsets == ["offsets are: %s" % (
        generate_offsets(40, O),)]
    ap = CT.coco_ap(coco, pkl_results(seg_dir))
    ap_e2e = CT.coco_ap(coco, pkl_results(os.path.join(work, "e2e",
                                                       "segment")))
    printed = [ln for ln in chain_out.splitlines()
               if "Average Precision" in ln][0]
    n_png = len([f for f in os.listdir(os.path.join(seg_dir, "result"))
                 if f.endswith(".png")])
    # the overlay of image 0 against visualize_mask on its decoded mask
    with open(os.path.join(seg_dir, "pkl", "0.pkl"), "rb") as f:
        res0 = pickle.load(f)
    mask0 = np.zeros((512, 1024), np.int32)
    for k, r in enumerate(res0, start=1):
        mask0[rle.decode(r["segmentation"]) > 0] = k
    img0 = imgproc.imread_rgb(os.path.join(val_img, "val_00000.png"))
    overlay_equal = bool(np.array_equal(
        io.read_png_rgb(os.path.join(seg_dir, "img", "0.png")),
        visualize_mask(img0.astype(np.float32) / 256.0, mask0,
                       transparency=0.3)))
    loss = {n: _first_loss(logs[n]) for n in ("train", "train torchrun")}
    loss_rel = abs(loss["train"] - loss["train torchrun"]) / abs(
        loss["train"])
    files = {n: all(os.path.isfile(os.path.join(work, d, f)) for f in (
        "checkpoint", "checkpoint.meta.json", "model_best",
        "model_best.meta.json")) for n, d in (("train", "train"),
                                              ("train torchrun",
                                               "train_ddp"))}
    state = T.create_train_state(get_model(C, O, "pspfpnet"), tx)
    state, meta = load_checkpoint(os.path.join(work, "train_ddp",
                                               "model_best"), state)
    loads_back = state.step >= 1 and meta["offsets"] == list(offsets)
    del state

    # data-parallel serving at world size 1 against the plain serve
    frames = np.stack([imgproc.imread_rgb(os.path.join(
        val_img, "val_%05d.png" % k)).astype(np.float32) / 256.0
        for k in (0, 1)])
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(work, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        plain = build_serving_pipeline(net, C, offsets,
                                       overflow_fallback=True, **SERVE_KW)
        meshed = build_serving_pipeline(net, C, offsets,
                                        overflow_fallback=True, mesh=mesh,
                                        **SERVE_KW)
        a, b = drive("serving mesh", lambda: (plain(frames),
                                              meshed(frames)),
                     ("floodscan", "absorb"))
        serve_equal = all(torch.equal(u, v) for u, v in zip(a, b))
    finally:
        dist.destroy_process_group()
    del net
    launches = paths["recipes"]
    out = {"exit_codes": rcs, "stage_ms": _stage_ms(chain_out),
           "chain_s": chain_s, "phase_s": sw.totals["recipes"],
           "head_split_max_abs": head_err, "ap": ap, "ap_e2e": ap_e2e,
           "jax_ap": JAX_AP["c"]["hier"], "evaluate_line": printed,
           "submission_pngs": n_png, "overlay_equal": overlay_equal,
           "first_step_loss": loss, "first_step_loss_rel": loss_rel,
           "checkpoints": files, "torchrun_checkpoint_loads": loads_back,
           "serving_mesh_equal": serve_equal,
           "segment_2x_shrink": {"images": RECIPE_HALF_IMAGES,
                                 "card_equals_cpu": half_equal,
                                 "instances": sum(map(len, half_res[
                                     "cuda"].values())),
                                 "offsets": half_offsets},
           "serving_mesh_overflow": [int(v) for v in b[2]],
           "launches_by_path": {k: paths[k] for k in paths
                                if k.startswith("recipes")
                                or k == "serving mesh"}}
    print("  staged chain hier AP %.4f AP50 %.4f (evaluate printed: %s); "
          "infer_e2e AP %.4f AP50 %.4f; JAX (c) hier %.4f; %d submission "
          "PNGs; overlay of image 0 equal: %s" % (
              ap[0], ap[1], printed.split("=")[-1].strip(), ap_e2e[0],
              ap_e2e[1], JAX_AP["c"]["hier"][0], n_png, overlay_equal),
          flush=True)
    print("  segment at the 2x shrink (512x256, %d images): card == CPU: "
          "%s, %d instances; %s" % (
              RECIPE_HALF_IMAGES, half_equal, sum(map(len, half_res[
                  "cuda"].values())), half_offsets), flush=True)
    print("  train recipe first-step loss: plain %.4f, torchrun %.4f "
          "(relative %.2e, limit %.0e); checkpoints %s; torchrun "
          "checkpoint loads: %s; serving mesh == plain: %s (%s)" % (
              loss["train"], loss["train torchrun"], loss_rel,
              RECIPE_LOSS_RTOL, files, loads_back, serve_equal, smi),
          flush=True)
    gates = [
        ("chain AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
         abs(ap[0] - JAX_AP["c"]["hier"][0]) <= CERT_JAX_AP_TOL),
        ("infer_e2e AP within %.3f of JAX's" % CERT_JAX_AP_TOL,
         abs(ap_e2e[0] - JAX_AP["c"]["hier"][0]) <= CERT_JAX_AP_TOL),
        ("evaluate printed the AP", printed.endswith("%.3f" % ap[0])),
        ("floodscan and absorb once per image",
         launches.get("floodscan", 0) >= 50
         and launches.get("absorb", 0) >= 50),
        ("the training paths launched no decode kernel",
         not any(paths["recipes train"].values())
         and not any(paths["recipes train torchrun"].values())),
        ("infer_e2e launched floodscan and absorb",
         paths["recipes infer_e2e"].get("floodscan", 0) >= 50
         and paths["recipes infer_e2e"].get("absorb", 0) >= 50),
        ("overlay equal", overlay_equal),
        ("segment at the 2x shrink: card == CPU", half_equal),
        ("segment at the 2x shrink derived generate_offsets(40, 10)",
         half_40),
        ("segment at the 2x shrink launched floodscan on the card",
         paths["recipes segment 2x shrink"].get("floodscan", 0)
         >= RECIPE_HALF_IMAGES),
        ("submission PNGs", n_png > 0),
        ("first-step losses", loss_rel <= RECIPE_LOSS_RTOL),
        ("checkpoints written", all(files.values())),
        ("torchrun checkpoint loads", loads_back),
        ("serving mesh equal", serve_equal)]
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("recipes gates failed: %s" % failed)
    shutil.rmtree(work, ignore_errors=True)
    return out


def bench_frame(k, size=SPATIAL_FRAME):
    """Committed val image k (bench_img*.png) resized bilinearly to
    `size` as the frame phase resizes it: (1, h, w, 3) uint8 on the
    CPU."""
    import torch
    from mergenet_tpu_torch import io
    img = io.read_png_rgb(os.path.join(
        FIX, "bench_img.png" if k == 0 else "bench_img_%d.png" % k))
    up = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(2, 0, 1)[None].float(), size=size,
        mode="bilinear", align_corners=False)
    return up.round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous()


def _flagship_steps(p, net, dev, mesh, dtype, barrier=None):
    """SPATIAL_STEPS steps of a copy of `net` (PSPFPNet-r50 holding the
    payload's weights) on the payload's batch (`build_train_step_compact`
    in float32; the float64 twin through `build_train_step` on float64
    inputs and targets), over `mesh` or in one process: losses, ms per
    step, running statistics after each step."""
    import copy

    import torch

    from mergenet_tpu_torch.ops.targets import mask_to_target
    from mergenet_tpu_torch.parallel import train as T

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    C, offsets = p["C"], p["offsets"]
    tx = T.make_optimizer(lr=0.01, momentum=0.9, nesterov=True,
                          weight_decay=1e-4)
    model = copy.deepcopy(net).to(dev, dtype)
    state = T.TrainState(step=0, model=model,
                         optimizer=tx.init(model.parameters()), tx=tx)
    u8, mask, oc = (torch.from_numpy(p["batch"][k]).to(dev)
                    for k in ("image", "mask", "object_class"))
    if dtype == torch.float32:
        step = T.build_train_step_compact(C, offsets, alpha=TRAIN_ALPHA,
                                          mesh=mesh)
        args = (u8, mask, oc)
    else:
        step = T.build_train_step(C, len(offsets), alpha=TRAIN_ALPHA,
                                  mesh=mesh)
        args = (u8.to(dtype) / 256.0,
                mask_to_target(mask, oc, C, offsets).to(dtype))
    out = {"losses": [], "step_ms": [], "stats": []}
    for _ in range(p["steps"]):
        if barrier is not None:
            barrier()
        sync()
        t = time.perf_counter()
        state, m = step(state, *args)
        sync()
        out["step_ms"].append((time.perf_counter() - t) * 1e3)
        out["losses"].append({k: float(v) for k, v in m.items()})
        out["stats"].append({k: v.double().cpu().numpy()
                             for k, v in state.model.named_buffers()
                             if k.endswith(("running_mean",
                                            "running_var"))})
    return out


def _spatial_rank(rank, world, work, device, backend):
    """One rank of the spatial phase (a spawned process): a `backend`
    group over a FileStore in `work` (NCCL: card `rank`), the payload's
    meshes on `device`, its three paths with their launches counted;
    writes its results to work/rank<r>.pt."""
    t_start = time.time()
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backend == "nccl":
        device = "cuda:%d" % rank
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(work, "store"), world), rank=rank, world_size=world)
    try:
        out = _spatial_rank_run(rank, world, work, device)
        out["clock"]["start"] = t_start
        torch.save(out, os.path.join(work, "rank%d.pt" % rank))
    finally:
        dist.destroy_process_group()


def _spatial_rank_run(rank, world, work, device):
    import statistics

    import torch
    import torch.distributed as dist

    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.decoder import device as D
    from mergenet_tpu_torch.models import PSPFPNet
    from mergenet_tpu_torch.ops import _build
    from mergenet_tpu_torch.parallel import halo, make_mesh
    from mergenet_tpu_torch.parallel import mesh as M
    from mergenet_tpu_torch.parallel.spatial import build_sharded_forward
    from mergenet_tpu_torch.serving import build_serving_pipeline

    p = torch.load(os.path.join(work, "payload.pt"), weights_only=False)
    mesh = make_mesh(*p["mesh"], device=device)  # (i) and (iii)
    frame_mesh = make_mesh(*p["frame_mesh"], device=device)  # (ii)
    dev = mesh.device
    cuda = dev.type == "cuda"
    if cuda:
        _build.library()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    C, offsets = p["C"], p["offsets"]
    nout = C + len(offsets)
    # one build per process (a ResNet-50's init takes seconds on a busy
    # host): the steps, the forward and serving copy it
    net = load_flax_weights(PSPFPNet(nout), p["params"], p["stats"])
    fwd = build_sharded_forward(net, frame_mesh, apply_sigmoid=False,
                                output_size=p["decode_size"])
    serve = build_serving_pipeline(net, C, offsets,
                                   decode_size=p["decode_size"],
                                   device=dev, mesh=mesh)
    frame = p["frame"].to(dev).float() / 256.0
    frames = p["frames"].to(dev).float() / 256.0
    clock = {"ready": time.time()}
    while not os.path.exists(os.path.join(work, "go")):
        time.sleep(0.01)  # the one-process references run first
    clock["go"] = time.time()
    out = {"coords": mesh.coords, "backend": dist.get_backend(),
           "device": str(dev),
           "host_staged": M.host_route(mesh.axis("spatial"), dev),
           "clock": clock}
    peak = {}

    # (i) the flagship step, data=1 x spatial=2, and its float64 twin
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = dict(M.TRANSPORT)
    out["train"] = _flagship_steps(p, net, dev, mesh, torch.float32,
                                   dist.barrier)
    out["train_launches"] = dict(_build.LAUNCHES)
    out["transport"] = {k: M.TRANSPORT[k] - t0[k] for k in t0}
    if cuda:
        peak["train"] = torch.cuda.max_memory_allocated(dev)
    clock["train"] = time.time()
    out["train64"] = _flagship_steps(p, net, dev, mesh, torch.float64,
                                     dist.barrier)
    clock["train64"] = time.time()

    # (ii) the served frame: the height-sharded forward, the decode of
    # the gathered logits
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    fwd(frame)  # warm-up
    ms = []
    for _ in range(3):
        dist.barrier()
        sync()
        b0 = dict(halo.STATS)
        t = time.perf_counter()
        lg = fwd(frame)
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
    out["forward_ms"] = statistics.median(ms)
    out["halo_bytes_per_forward"] = halo.STATS["halo_bytes"] - b0[
        "halo_bytes"]
    out["halo_exchanges_per_forward"] = halo.STATS["halo_exchanges"] - b0[
        "halo_exchanges"]
    out["gather_bytes_per_forward"] = halo.STATS["gather_bytes"] - b0[
        "gather_bytes"]
    _build.reset_launches()
    lg = fwd(frame)[0]
    if rank == 0:
        mask, classes = D.decode_hierarchical(
            lg[..., :C], lg[..., C:], C, offsets, object_merge_factor=1.0,
            merge_logprob_bias=0.03, relabel=True, from_logits=True,
            device=dev)
        out["frame_mask"] = mask.cpu().numpy()
        out["frame_logits"] = lg.cpu().numpy()
    sync()
    out["frame_launches"] = dict(_build.LAUNCHES)
    if cuda:
        peak["frame"] = torch.cuda.max_memory_allocated(dev)
    clock["frame"] = time.time()

    # (iii) serving on the (1, 2, 1) mesh: both ranks serve both frames
    _build.reset_launches()
    masks, classes = serve(frames)
    sync()
    out["serve_launches"] = dict(_build.LAUNCHES)
    out["serve"] = (masks.cpu().numpy(), classes.cpu().numpy())
    out["peak_bytes"] = peak
    clock["serve"] = time.time()
    return out


def spatial_start(device="cuda", backend="gloo",
                  mesh=(1, SPATIAL_RANKS, 1), frame_mesh=None):
    """Write the spatial phase's payload and spawn its ranks (one per
    position of `mesh` (data, spatial, model): on the one card over gloo,
    or one card each over NCCL); they build their nets and wait for
    `spatial_phase`.  (i) and (iii) run on `mesh`, (ii) on `frame_mesh`
    (default: `mesh`).  Returns the run's state; `spatial_stop` ends
    it."""
    import multiprocessing
    import shutil

    import numpy as np
    import torch

    from mergenet_tpu_torch import io

    work = os.path.join(HERE, "mergenet_tpu_torch", "_build", "spatial")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    params, stats = io.load_bench_checkpoint(os.path.join(FIX,
                                                          "bench_ckpt.npz"))
    batch, _ = train_data(np.random.default_rng(1), SPATIAL_BATCH,
                          SPATIAL_CROP)
    frame = bench_frame(0, SPATIAL_FRAME)
    payload = {"C": 9, "offsets": io.load_offsets(FIX), "params": params,
               "stats": stats, "batch": batch, "frame": frame,
               "frames": torch.cat([frame, bench_frame(1, SPATIAL_FRAME)]),
               "steps": SPATIAL_STEPS, "decode_size": SPATIAL_DECODE,
               "mesh": tuple(mesh), "frame_mesh": tuple(frame_mesh or mesh)}
    torch.save(payload, os.path.join(work, "payload.pt"))
    world = int(np.prod(mesh))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spatial_rank,
                         args=(r, world, work, device, backend))
             for r in range(world)]
    run = {"work": work, "payload": payload, "procs": procs,
           "world": world, "device": device, "t_spawn": time.time()}
    for proc in procs:
        proc.start()
    return run


def spatial_stop(run):
    """Kill and join every rank of `run` still alive."""
    for proc in run["procs"]:
        if proc.is_alive():
            proc.kill()
            proc.join()


def spatial_phase(run, paths, smi, sw, max_s=SPATIAL_MAX_S):
    """The spatial phase (SPATIAL_* above) on the ranks `spatial_start`
    spawned: the one-process references in this process, then the ranks'
    paths; gates: (i) the flagship step's losses and running statistics
    against the one-process step's, (ii) the sharded frame's decode
    against the unsharded frame's, (iii) mesh serving equal to plain
    serving, and the phase (from here) within `max_s` (None: no
    budget).  Every rank is joined or killed."""
    import shutil
    import statistics

    import numpy as np
    import torch

    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.decoder import device as D
    from mergenet_tpu_torch.models import PSPFPNet, logits_at
    from mergenet_tpu_torch.serving import build_serving_pipeline

    t_phase, t_phase_wall = time.perf_counter(), time.time()
    payload, work, procs = run["payload"], run["work"], run["procs"]
    world, t_spawn = run["world"], run["t_spawn"]
    mesh = payload["mesh"]
    C, offsets = payload["C"], payload["offsets"]
    params, stats = payload["params"], payload["stats"]
    nout = C + len(offsets)
    frame, frames = payload["frame"], payload["frames"]
    dev = torch.device(run["device"])
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    try:
        with sw.span("spatial references", sync=dev if cuda else None):
            # (i) the one-process steps on the same batch and weights
            base = load_flax_weights(PSPFPNet(nout), params, stats)
            ref = {dt: _flagship_steps(payload, base, dev, None, dt)
                   for dt in (torch.float32, torch.float64)}
            # (ii) the unsharded frame
            net = base.to(dev).eval()
            x = frame.to(dev).float() / 256.0
            ref_lg = logits_at(net, x, SPATIAL_DECODE)
            fwd_ms = []
            for _ in range(3):
                sync()
                t = time.perf_counter()
                logits_at(net, x, SPATIAL_DECODE)
                sync()
                fwd_ms.append((time.perf_counter() - t) * 1e3)
            lg = ref_lg[0]
            ref_mask, _ = D.decode_hierarchical(
                lg[..., :C], lg[..., C:], C, offsets,
                object_merge_factor=1.0, merge_logprob_bias=0.03,
                relabel=True, from_logits=True, device=dev)
            ref_mask, ref_lg = ref_mask.cpu().numpy(), ref_lg.cpu().numpy()
            # (iii) plain serving
            plain = build_serving_pipeline(net, C, offsets,
                                           decode_size=SPATIAL_DECODE,
                                           device=dev)
            ref_serve = [t.cpu().numpy() for t in plain(
                frames.to(dev).float() / 256.0)]
            del net, plain, x, lg
        t_go = time.time()
        open(os.path.join(work, "go"), "w").close()
        with sw.span("spatial ranks"):
            for proc in procs:
                proc.join(SPATIAL_TIMEOUT_S)
        codes = [proc.exitcode for proc in procs]
        if codes != [0] * world:
            raise AssertionError("spatial ranks exited with %s" % codes)
    finally:
        spatial_stop(run)
    ranks = [torch.load(os.path.join(work, "rank%d.pt" % r),
                        weights_only=False) for r in range(world)]

    def total(key):
        out = {}
        for r in ranks:
            for k, v in r[key].items():
                out[k] = out.get(k, 0) + int(v)
        return {k: out.get(k, 0) for k in ("floodscan", "absorb",
                                           "tgather", "pgather")}
    paths["spatial train"] = total("train_launches")
    paths["spatial frame"] = total("frame_launches")
    paths["spatial serving"] = total("serve_launches")

    def loss_rel(a, b):
        return max(abs(x[k] - y[k]) / abs(y[k])
                   for x, y in zip(a["losses"], b["losses"]) for k in y)

    def stats_excess(a, b, step, tol):
        """max |a - b| - tol * |b| over the running statistics after
        `step`: within the gate when <= tol."""
        return max(float((np.abs(a["stats"][step][k] - v)
                          - tol * np.abs(v)).max())
                   for k, v in b["stats"][step].items())
    r32, r64 = ref[torch.float32], ref[torch.float64]
    last = SPATIAL_STEPS - 1
    trains = [r["train"] for r in ranks]
    trains64 = [r["train64"] for r in ranks]
    steps = {
        "loss_rel": max(loss_rel(t, r32) for t in trains),
        "stats_excess_step1": max(stats_excess(t, r32, 0, SPATIAL_STATS_TOL)
                                  for t in trains),
        "stats_excess_last": max(stats_excess(t, r32, last,
                                              SPATIAL_STATS_TOL)
                                 for t in trains),
        "f64_loss_rel": max(loss_rel(t, r64) for t in trains64),
        "f64_stats_excess": max(stats_excess(t, r64, last, SPATIAL_F64_TOL)
                                for t in trains64),
        # float32 against float64, one process and sharded: how far the
        # second step's statistics move with float32 sums alone
        "f32_vs_f64_one_process": {
            "loss_rel": loss_rel(r32, r64),
            "stats_excess_last": stats_excess(r32, r64, last,
                                              SPATIAL_STATS_TOL)},
        "f32_vs_f64_sharded": {
            "loss_rel": max(loss_rel(t, r64) for t in trains),
            "stats_excess_last": max(stats_excess(t, r64, last,
                                                  SPATIAL_STATS_TOL)
                                     for t in trains)}}
    lg_err = float(np.abs(ranks[0]["frame_logits"] - ref_lg).max())
    frame_check = check_decode("spatial frame (sharded vs unsharded)",
                               ranks[0]["frame_mask"], ref_mask,
                               names=("sharded", "unsharded"))
    serve_equal = all(np.array_equal(a, b) for r in ranks
                      for a, b in zip(r["serve"], ref_serve))
    out = {
        "mesh": dict(zip(("data", "spatial", "model"), mesh)),
        "spawn_to_phase_s": t_phase_wall - t_spawn,
        "frame_mesh": dict(zip(("data", "spatial", "model"),
                               payload["frame_mesh"])),
        "backend": ranks[0]["backend"],
        "devices": [r["device"] for r in ranks],
        "host_staged": ranks[0]["host_staged"],
        "config": {"model": "PSPFPNet-r50", "classes": C,
                   "offsets": len(offsets), "batch": SPATIAL_BATCH,
                   "crop": list(SPATIAL_CROP), "steps": SPATIAL_STEPS,
                   "dtype": "float32", "tf32": False,
                   "frame": list(SPATIAL_FRAME),
                   "decode": list(SPATIAL_DECODE)},
        "losses": [[l["loss"] for l in t["losses"]] for t in trains],
        "ref_losses": [l["loss"] for l in r32["losses"]],
        "f64_losses": [[l["loss"] for l in t["losses"]] for t in trains64],
        "f64_ref_losses": [l["loss"] for l in r64["losses"]],
        "steps": steps,
        "step_ms": [t["step_ms"] for t in trains],
        "ref_step_ms": r32["step_ms"],
        "f64_step_ms": [t["step_ms"] for t in trains64],
        "f64_ref_step_ms": r64["step_ms"],
        "transport_per_train": [r["transport"] for r in ranks],
        "forward_ms": [r["forward_ms"] for r in ranks],
        "ref_forward_ms": statistics.median(fwd_ms),
        "halo_bytes_per_forward": [r["halo_bytes_per_forward"]
                                   for r in ranks],
        "halo_exchanges_per_forward": [r["halo_exchanges_per_forward"]
                                       for r in ranks],
        "gather_bytes_per_forward": [r["gather_bytes_per_forward"]
                                     for r in ranks],
        "frame_logits_max_abs": lg_err, "frame_check": frame_check,
        "serve_equal": serve_equal,
        "peak_bytes": [r["peak_bytes"] for r in ranks],
        "launches": {k: paths[k] for k in ("spatial train", "spatial frame",
                                           "spatial serving")},
        # seconds from the spawn: each rank's start, ready (model built,
        # waiting), the go (references done), then the end of each part
        "clock": {"go": t_go - t_spawn, "ranks": [
            {k: v - t_spawn for k, v in r["clock"].items()}
            for r in ranks]},
        "phase_s": time.perf_counter() - t_phase}
    print("  backend %s (the halo exchange's device tensors staged through "
          "host memory: %s; the collectives take them as they are); "
          "mesh %s, the frame's %s; ranks on %s" % (
              out["backend"], out["host_staged"], out["mesh"],
              out["frame_mesh"], out["devices"]), flush=True)
    print("  (i) %d steps, batch %d of %dx%d, float32: losses %s vs one "
          "process %s (max rel %.2e, limit %.0e); running stats past "
          "%.0e relative after step 1 %.2e (limit %.0e), after step %d "
          "%.2e; float64 twin: losses %s vs %s (max rel %.2e), stats past "
          "%.0e relative %.2e (limit %.0e); float32 vs float64 after step "
          "%d: one process %s, sharded %s; ms per step sharded %s, one "
          "process %s; float64 sharded %s, one process %s; transport per "
          "%d steps %s (%s)" % (
              SPATIAL_STEPS, SPATIAL_BATCH, SPATIAL_CROP[0],
              SPATIAL_CROP[1], out["losses"], out["ref_losses"],
              steps["loss_rel"], SPATIAL_LOSS_RTOL, SPATIAL_STATS_TOL,
              steps["stats_excess_step1"], SPATIAL_STATS_TOL,
              SPATIAL_STEPS, steps["stats_excess_last"], out["f64_losses"],
              out["f64_ref_losses"], steps["f64_loss_rel"], SPATIAL_F64_TOL,
              steps["f64_stats_excess"], SPATIAL_F64_TOL, SPATIAL_STEPS,
              steps["f32_vs_f64_one_process"],
              steps["f32_vs_f64_sharded"], out["step_ms"],
              out["ref_step_ms"], out["f64_step_ms"],
              out["f64_ref_step_ms"], SPATIAL_STEPS,
              out["transport_per_train"], smi), flush=True)
    print("  (ii) frame %dx%d -> logits %dx%d: sharded forward ms %s, "
          "unsharded %.2f; halo bytes per forward %s (%s exchanges), "
          "gathered bytes %s; logits max abs %.2e (%s)" % (
              SPATIAL_FRAME + SPATIAL_DECODE + (
                  out["forward_ms"], out["ref_forward_ms"],
                  out["halo_bytes_per_forward"],
                  out["halo_exchanges_per_forward"],
                  out["gather_bytes_per_forward"], lg_err, smi)), flush=True)
    print("  (iii) serving 2 frames on %s: equal to plain serving: %s; "
          "peak bytes per rank %s; launches %s" % (
              tuple(mesh), serve_equal, out["peak_bytes"], out["launches"]),
          flush=True)
    gates = [
        ("(i) float32 losses within %.0e" % SPATIAL_LOSS_RTOL,
         steps["loss_rel"] <= SPATIAL_LOSS_RTOL),
        ("(i) float32 running statistics of step 1 within %.0e"
         % SPATIAL_STATS_TOL,
         steps["stats_excess_step1"] <= SPATIAL_STATS_TOL),
        ("(i) float64 losses within %.0e" % SPATIAL_F64_TOL,
         steps["f64_loss_rel"] <= SPATIAL_F64_TOL),
        ("(i) float64 running statistics within %.0e" % SPATIAL_F64_TOL,
         steps["f64_stats_excess"] <= SPATIAL_F64_TOL),
        ("(i) the step launched no decode kernel",
         not any(paths["spatial train"].values())),
        ("(ii) floodscan and absorb on the sharded frame",
         paths["spatial frame"]["floodscan"] >= 1
         and paths["spatial frame"]["absorb"] >= 1),
        ("(iii) serving equal to plain serving", serve_equal),
        ("(iii) floodscan and absorb on every rank",
         paths["spatial serving"]["floodscan"] >= 2 * world // mesh[0]
         and paths["spatial serving"]["absorb"] >= 2 * world // mesh[0]),
        ("the phase within %s s" % max_s,
         max_s is None or out["phase_s"] <= max_s)]
    failed = [g for g, ok in gates if not ok]
    if failed:
        raise AssertionError("spatial gates failed: %s" % failed)
    shutil.rmtree(work, ignore_errors=True)
    return out


def spatial_cards(smi, kind):
    """`chip_smoke.py --cards`: the spatial phase alone over NCCL, one
    rank per card of the machine (two or more): the dry run's data x
    spatial layout (cards/2, 2, 1) for the steps and serving, the frame
    height-sharded over every card (1, cards, 1); device tensors cross
    the ranks as they are.  Prints its `spatial {...}` line and the
    device line last; exits non-zero on a failed gate."""
    import torch

    from mergenet_tpu_torch.utils import profiling

    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        print("chip_smoke --cards: needs an even number of cards, found %d"
              % n, file=sys.stderr)
        return 1
    phase("spatial over NCCL: PSPFPNet-r50 on %d cards, steps and serving "
          "on (%d, 2, 1), the frame on (1, %d, 1)" % (n, n // 2, n))
    paths, sw = {}, profiling.Stopwatch()
    # outside the smoke run's 600 s guard: no 60 s budget (the NCCL
    # groups' first use and the ranks' start take ~75 s on 4 cards)
    run = spatial_start(backend="nccl", mesh=(n // 2, 2, 1),
                        frame_mesh=(1, n, 1))
    try:
        out = spatial_phase(run, paths, smi, sw, max_s=None)
    finally:
        spatial_stop(run)
    print("spatial " + json.dumps({"card": smi, **out}), flush=True)
    sw.summary()
    phase("done")
    print(smi, flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": n}}), flush=True)
    return 0


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

    if "--cards" in sys.argv[1:]:
        return spatial_cards(smi, kind)
    jpeg_build = start_jpeg_build()  # beside the card phases below

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
                              params, batch_stats).to(cuda)
    # the user entry point; it runs a copy of net16 on the card in bf16
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
    # the data phase's host work (the regeneration, then the containers
    # split) runs in a child process beside the card phases from here;
    # the data phase joins it before the jpeg phase
    data_run = data_start()
    _STOPS.append(lambda: data_stop(data_run))
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
    phase("data: join the regeneration of the certification dataset "
          "(data/synthetic.py, seed 100, 60 + 50 images of 512x1024) and "
          "the containers split")
    data, data_dir = data_phase(smi, sw, data_run)
    print("data " + json.dumps({"card": smi, **data}), flush=True)
    phase("jpeg: the committed JPEGs against cv2's digests, (c) hier from "
          "the q90 JPEGs of the 50 val images, the coco loader on JPEG/PNG")
    jpeg_r = jpeg_phase(drive, paths, smi, sw, data_dir, jpeg_build)
    print("jpeg " + json.dumps({"card": smi, **jpeg_r}), flush=True)
    phase("webp: the committed WebPs against cv2's digests, the lossless "
          "files against their PNGs, (c) hier from the q90 WebPs of the 50 "
          "val images")
    webp_r = webp_phase(drive, paths, smi, sw, data_dir, jpeg_build[1])
    print("webp " + json.dumps({"card": smi, **webp_r}), flush=True)
    phase("jp2: the committed JPEG 2000 files against cv2's digests, the "
          "lossless files against their PNGs, (c) hier from the JP2s of "
          "the 50 val images")
    jp2_r = jp2_phase(drive, paths, smi, sw, data_dir, jpeg_build[1])
    print("jp2 " + json.dumps({"card": smi, **jp2_r}), flush=True)
    phase("avif: the committed AVIFs against cv2's digests (the files "
          "with a later tool refused as not yet read), the lossless val "
          "files against their PNGs, the host's read times")
    avif_r = avif_phase(smi, sw, data_dir, jpeg_build[1])
    print("avif " + json.dumps({"card": smi, **avif_r}), flush=True)
    phase("tiff: the 50 q90 val JPEGs rewrapped as JPEG-in-TIFF (one strip; "
          "JPEGTables and an abbreviated strip) against the JPEGs' cv2 "
          "digests, (c) hier from them, the new TIFF kinds timed")
    tiff_r = tiff_phase(drive, paths, smi, sw, data_dir, jpeg_r)
    print("tiff " + json.dumps({"card": smi, **tiff_r}), flush=True)
    # the recipes' subprocesses (a host-bound chain of process starts,
    # reads and writes) run beside the converter, certification (c),
    # containers and certification (d) phases; the recipes phase joins
    # them after (d)
    phase("recipes: the committed net split into class/offset/all "
          "checkpoints; infer_pspfpnet.sh stages 0-4, infer_e2e and the "
          "train recipe (plain and torchrun) started on the 50 regenerated "
          "val images, beside the phases up to certification (d)")
    with sw.span("recipes start"):
        recipes_run = recipes_start(data_dir)
    _STOPS.append(lambda: recipes_stop(recipes_run))
    phase("converter: a gtFine tree of the 50 val images -> the "
          "prepare_data.sh twin -> masks and hier AP on the converted json")
    converter = converter_phase(drive, smi, sw, data_dir)
    print("converter " + json.dumps({"card": smi, **converter}), flush=True)
    phase("certification (c): bench_ckpt on the 50 regenerated val images "
          "(hier; exact on images 0-%d)" % (CERT_C_EXACT_IMAGES - 1))
    cert_c = cert_c_phase(drive, smi, sw, data_dir)
    print("certification_c " + json.dumps({"card": smi, **cert_c}),
          flush=True)
    phase("containers: the committed TIFF/BMP/PxM/Sun/HDR/GIF files "
          "against cv2's digests, (c) hier from the 50 val images in %d "
          "lossless layouts" % len(set(
              f["layout"] for f in data_run["files"].values())))
    containers = containers_phase(drive, paths, smi, sw, data_run, cert_c)
    print("containers " + json.dumps({"card": smi, **containers}),
          flush=True)
    phase("certification (d): train seed 0 through the loader, %d epochs, "
          "then score hier" % CERT_D_EPOCHS)
    cert_d = cert_d_phase(drive, smi, sw, data_dir)
    print("certification_d " + json.dumps({"card": smi, **cert_d}),
          flush=True)
    # the spatial phase's ranks start while the recipes finish: they build
    # their nets and wait, idle, until the spatial phase (their start takes
    # ~10-20 s of host).  Started with the recipes, so that they waited
    # through (d), their steps ran 2-3x slower
    spatial_run = spatial_start()
    try:
        phase("recipes: join infer_pspfpnet.sh stages 0-4, infer_e2e and "
              "the train recipe (plain and torchrun)")
        recipes = recipes_phase(drive, paths, smi, sw, recipes_run)
        print("recipes " + json.dumps({"card": smi, **recipes}), flush=True)
        phase("spatial: PSPFPNet-r50 height-sharded over %d ranks on the "
              "card (gloo): the dry run's step, the served frame, serving"
              % SPATIAL_RANKS)
        spatial = spatial_phase(spatial_run, paths, smi, sw)
    finally:
        spatial_stop(spatial_run)
    print("spatial " + json.dumps({"card": smi, **spatial}), flush=True)
    phase("train: PSPNet-r101 with the aux head, batch %d, %d^2 crops, "
          "aux_weight %g, bf16" % (TRAIN_BATCH, TRAIN_CROP,
                                   TRAIN_AUX_WEIGHT))
    train_aux = train_aux_phase(drive, smi, sw)
    print("train_aux " + json.dumps({"card": smi, **train_aux}), flush=True)
    for name in ("zoo", "class inference", "train aux",
                 "certification (d) train"):
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
               "staged": staged, "train_aux": train_aux, "data": data,
               "certification_c": cert_c, "certification_d": cert_d,
               "recipes": recipes, "converter": converter, "jpeg": jpeg_r,
               "containers": containers,
               "spatial": spatial,
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
    try:
        code = main()
    finally:
        for stop in _STOPS:
            stop()
    sys.exit(code)
