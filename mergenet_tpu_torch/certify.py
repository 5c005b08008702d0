"""The decoder-certification workload on the port, its counterpart of
`scripts/make_certification_fixtures.py`:

  1. regenerate the synthetic street dataset (`data/synthetic.py`; the
     committed `summary.json`'s config: seed 100, 60 train and 50 val
     images of 512x1024, 9 classes);
  2. train a PSPFPNet-r50 per seed (`train_seed`) as
     `egs/cityscape/local/train.py --mode all --input-pipeline grain`
     does: the compact pipeline (`data/pipeline.py`) into
     `build_train_step_compact` through `train_compact`, SGD lr 0.02
     with milestones at 60% and 85% of the epochs, batch 8, 384^2 crops,
     a validation pass over the first 6 val images after each epoch and
     `model_best` by its score; or take a stored net (`--bench-ckpt`,
     the committed `bench_ckpt.npz`: procedure (c));
  3. run the net on every val image at 512x1024 (float32 sigmoid maps, as
     the reference's `probs_fn`) and decode: hier
     (`decode_hierarchical` + `relabel_mask`), exact
     (`run_segmentation_device`), cpp (`decoder/csegment.py`'s greedy),
     all at object_merge_factor 1.0, merge_logprob_bias 0.03;
  4. score each decoder with the port's COCOeval (segm AP, AP50);
  5. write `--out`/summary.json in the reference's shape (config,
     offsets, per seed: times_s, overflow, AP and AP50 per decoder).

    python -m mergenet_tpu_torch.certify --out DIR [--seeds 0 1 2]
        [--epochs 24] [--skip-cpp] [--skip-exact] [--bench-ckpt NPZ]

Procedure (c) is `--bench-ckpt tests/fixtures/certification512/
bench_ckpt.npz` (seed 0's net, parameters stored as float16); procedure
(d) trains seed 0 with the port and scores it.  The net and the decodes
run on `--device` (default CUDA), TF32 off."""

import argparse
import contextlib
import io as _io
import json
import os
import time

import numpy as np
import torch

from . import io
from .core import generate_offsets
from .data import AllDataset, COCO, DataLoader, imgproc, synthetic
from .data.cocoeval import COCOeval
from .data.pipeline import CocoInstanceSource, make_train_pipeline
from .decoder import csegment
from .decoder.device import (decode_hierarchical, relabel_mask,
                             run_segmentation_device)
from .e2e import masks_to_results
from .models import PSPFPNet, get_model
from .parallel import train as T
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.train_utils import train_compact, validate

#: decode settings of the certification (and of the served frame)
DECODE_KW = dict(object_merge_factor=1.0, merge_logprob_bias=0.03)
OVERFLOW_KEYS = ("edges_dropped", "pairs_dropped", "n_frozen")


def regenerate(data_dir, train_images=60, val_images=50, height=512,
               width=1024, num_classes=9, seed=100):
    """The certification dataset under `data_dir` (kept if its val json
    exists); returns (seconds, images written)."""
    if os.path.exists(os.path.join(data_dir, "annotations",
                                   "instancesonly_val.json")):
        return 0.0, 0
    with contextlib.redirect_stdout(_io.StringIO()):
        s = synthetic.generate(data_dir, train_images, val_images, height,
                               width, num_classes, seed=seed)
    return s, train_images + val_images


def coco_ap(coco, results, img_ids=None):
    """(AP, AP50) of `results` with the port's COCOeval ('segm'), over
    `img_ids` (default: every image of `coco`)."""
    if not results:
        return 0.0, 0.0
    with contextlib.redirect_stdout(_io.StringIO()):
        E = COCOeval(coco, coco.loadRes(results), "segm")
        if img_ids is not None:
            E.params.imgIds = list(img_ids)
        E.evaluate()
        E.accumulate()
        E.summarize()
    return float(E.stats[0]), float(E.stats[1])


def load_bench_net(path, num_outputs, device=None):
    """A float32 PSPFPNet-r50 from a bench_ckpt.npz Flax tree (float16
    parameters widened), in eval mode on `device`."""
    from .convert import load_flax_weights
    params, stats = io.load_bench_checkpoint(path)
    net = load_flax_weights(PSPFPNet(num_outputs), params, stats)
    return net.to(T.resolve_device(device)).eval()


def _results(mask, classes, img_id, cats):
    """`masks_to_results` of one mask whose instance k has class
    `classes[k-1]` (a list, as the exact and cpp decoders return)."""
    return masks_to_results(mask[None], np.asarray(
        list(classes) + [-1], np.int32)[None], [img_id], cats)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def score(model, data_dir, num_classes, offsets, decoders=("hier", "exact"),
          device=None, on_probs=None, log=None):
    """Run `model` (moved to `device`, in eval mode; float32 sigmoid maps
    at the image size) on every val image of `data_dir` and decode with
    each of `decoders` ('hier', 'exact', 'cpp').  `on_probs(n, img_id,
    cp, sp)` sees each image's numpy maps.  Returns {"hier": (AP, AP50),
    ..., "times_s": {...}, "overflow": {...}, "images": N, "results":
    {decoder: COCO results}}."""
    dev = T.resolve_device(device)
    C = num_classes
    with contextlib.redirect_stdout(_io.StringIO()):
        coco = COCO(os.path.join(data_dir, "annotations",
                                 "instancesonly_val.json"))
    val_ids = sorted(coco.imgs.keys())
    cats = list(range(C))  # category id = class id, as the generator's
    res = {k: [] for k in decoders}
    times = {k: 0.0 for k in ("net",) + tuple(decoders)}
    overflow = {k: 0 for k in OVERFLOW_KEYS}
    model = model.to(dev).eval()
    for n, img_id in enumerate(val_ids):
        fname = coco.loadImgs(img_id)[0]["file_name"]
        img = imgproc.imread_rgb(os.path.join(data_dir, "val", fname))
        t0 = time.perf_counter()
        with torch.no_grad():
            x = torch.from_numpy(img.astype(np.float32)[None] / 256.0)
            probs = torch.sigmoid(model(x.to(dev)))[0]
        cp_d, sp_d = probs[..., :C], probs[..., C:]
        _sync(dev)
        times["net"] += time.perf_counter() - t0
        cp, sp = cp_d.cpu().numpy(), sp_d.cpu().numpy()
        if on_probs is not None:
            on_probs(n, img_id, cp, sp)
        if "hier" in decoders:
            t0 = time.perf_counter()
            comp, rc, ii, st = decode_hierarchical(
                cp_d.contiguous(), sp_d.contiguous(), C, offsets,
                return_stats=True, device=dev, **DECODE_KW)
            mask, ic = relabel_mask(comp, rc, ii)
            mask, ic = mask.cpu().numpy(), ic.cpu().numpy()
            times["hier"] += time.perf_counter() - t0
            for k in OVERFLOW_KEYS:
                overflow[k] += int(st[k])
            res["hier"] += masks_to_results(mask[None], ic[None], [img_id],
                                            cats)
        cf, sf = np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0)
        if "exact" in decoders:
            t0 = time.perf_counter()
            emask, ecls = run_segmentation_device(cf, sf, C, offsets,
                                                  device=dev, **DECODE_KW)
            times["exact"] += time.perf_counter() - t0
            res["exact"] += _results(emask, ecls, img_id, cats)
        if "cpp" in decoders:
            t0 = time.perf_counter()
            cmask, ccls = csegment.run_segmentation(
                np.ascontiguousarray(cf), np.ascontiguousarray(sf), C,
                list(offsets), same_different_bias=0.0, **DECODE_KW)
            times["cpp"] += time.perf_counter() - t0
            res["cpp"] += _results(cmask, ccls, img_id, cats)
        if log is not None:
            log("  img %d/%d decoded" % (n + 1, len(val_ids)))
    out = {"times_s": times, "overflow": overflow, "images": len(val_ids),
           "results": res}
    for k in decoders:
        out[k] = coco_ap(coco, res[k])
    return out


def _timed(batches, waits):
    """Yield from `batches`, adding each wait for the next batch to
    `waits`."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            b = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t0)
        yield b


def loader_rate(data_dir, batch_size=8, crop_size=384):
    """(images per second, images) of one pass of the training pipeline
    alone (no step): read, mask, crop and batch the train split."""
    with contextlib.redirect_stdout(_io.StringIO()):
        batches, _ = make_train_pipeline(
            os.path.join(data_dir, "train"),
            os.path.join(data_dir, "annotations",
                         "instancesonly_train.json"),
            batch_size=batch_size, crop_size=crop_size)
    t0 = time.perf_counter()
    n = sum(len(b["image"]) for b in batches)
    return n / (time.perf_counter() - t0), n


def train_seed(exp, data_dir, seed=0, num_classes=9, num_offsets=10,
               epochs=24, batch_size=8, crop_size=384, device=None,
               arch="pspfpnet", log=None):
    """Train one seed as the certification's training recipe does (lr
    0.02, milestones at 60% and 85% of the epochs, the first 6 val
    images scored after each epoch) and write `exp`/checkpoint and
    `exp`/model_best; returns a dict of the per-epoch losses, validation
    scores and times (epoch, steps, time spent waiting for the
    loader)."""
    dev = T.resolve_device(device)
    C, O = num_classes, num_offsets
    offsets = generate_offsets(80, O)
    milestones = [int(epochs * 0.6), int(epochs * 0.85)]
    train_img = os.path.join(data_dir, "train")
    train_ann = os.path.join(data_dir, "annotations",
                             "instancesonly_train.json")
    with contextlib.redirect_stdout(_io.StringIO()):
        source = CocoInstanceSource(train_img, train_ann)
        # the val pass's images are fixed (no crop): cached once
        valset = AllDataset(os.path.join(data_dir, "val"),
                            os.path.join(data_dir, "annotations",
                                         "instancesonly_val.json"),
                            C, offsets, mode="train", limits=6,
                            cache=True)
    if valset.catIds != source.catIds:
        raise ValueError("train and val jsons disagree on category ids: "
                         "%s vs %s" % (source.catIds, valset.catIds))
    valloader = DataLoader(valset, batch_size=min(4, batch_size))
    steps_per_epoch = max(1, len(source) // batch_size)
    tx = T.make_optimizer(lr=0.02, momentum=0.9, nesterov=True,
                          weight_decay=1e-4, milestones=milestones,
                          gamma=0.2, steps_per_epoch=steps_per_epoch)
    state = T.create_train_state(get_model(C, O, arch), tx, seed=seed,
                                 device=dev)
    step = T.build_train_step_compact(C, offsets, alpha=1.0)
    eval_step = T.build_eval_step(C, O, alpha=1.0)
    best, iterations = float("-inf"), 0
    hist = {"loss": [], "val": [], "epoch_s": [], "step_s": [],
            "loader_wait_s": [], "steps": []}
    for epoch in range(epochs):
        batches, _ = make_train_pipeline(
            train_img, train_ann, batch_size=batch_size,
            crop_size=crop_size, seed=seed * 10007 + epoch, source=source)
        waits, losses = [], []

        def record(state, *args):
            state, m = step(state, *args)
            losses.append(m["loss"])
            return state, m

        _sync(dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(_io.StringIO()):
            state, iterations = train_compact(
                _timed(batches, waits), state, record, batch_size, epoch,
                iterations,
                rng=torch.Generator(dev).manual_seed(seed * 131 + epoch))
        _sync(dev)
        t_train = time.perf_counter() - t0
        with contextlib.redirect_stdout(_io.StringIO()):
            val = validate(valloader, state, eval_step, batch_size, epoch,
                           iterations, num_classes=C,
                           class_nms=valset.catNms, offset_list=offsets)
        hist["epoch_s"].append(time.perf_counter() - t0)
        hist["step_s"].append(t_train)
        hist["loader_wait_s"].append(sum(waits))
        hist["steps"].append(len(losses))
        hist["loss"].append(float(torch.stack(losses).mean()))
        hist["val"].append(float(val))
        is_best = val > best
        best = max(val, best)
        save_checkpoint(exp, state, is_best, offsets=offsets,
                        epoch=epoch + 1, best_iou=float(best))
        if log is not None:
            log("  seed %d epoch %d: loss %.4f val %.4f (%d steps, %.2f s, "
                "loader wait %.2f s)" % (seed, epoch, hist["loss"][-1], val,
                                         len(losses), hist["epoch_s"][-1],
                                         hist["loader_wait_s"][-1]))
    hist["best_val"] = best
    hist["batch_size"] = batch_size
    return hist


def load_trained(exp, num_classes=9, num_offsets=10, device=None,
                 arch="pspfpnet"):
    """The `exp`/model_best net, in eval mode on `device`."""
    tx = T.make_optimizer(lr=0.02)
    state = T.create_train_state(get_model(num_classes, num_offsets, arch),
                                 tx, device=device)
    state, _ = load_checkpoint(os.path.join(exp, "model_best"), state)
    return state.model.eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--num-classes", type=int, default=9)
    ap.add_argument("--num-offsets", type=int, default=10)
    ap.add_argument("--train-images", type=int, default=60)
    ap.add_argument("--val-images", type=int, default=50)
    ap.add_argument("--crop-size", type=int, default=384)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--skip-cpp", action="store_true")
    ap.add_argument("--skip-exact", action="store_true")
    ap.add_argument("--data-seed", type=int, default=100)
    ap.add_argument("--bench-ckpt", default=None,
                    help="score this bench_ckpt.npz (procedure (c)) "
                         "instead of training the seeds")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    os.makedirs(args.out, exist_ok=True)
    data_dir = os.path.join(args.out, "data")
    gen_s, n_gen = regenerate(data_dir, args.train_images, args.val_images,
                              args.height, args.width, args.num_classes,
                              args.data_seed)
    if n_gen:
        print("dataset: %d images in %.1f s" % (n_gen, gen_s), flush=True)
    C, O = args.num_classes, args.num_offsets
    offsets = tuple(generate_offsets(80, O))
    decoders = ("hier",) + (() if args.skip_exact else ("exact",)) + (
        () if args.skip_cpp else ("cpp",))
    summary = {"config": vars(args), "offsets": [list(o) for o in offsets],
               "seeds": {}}
    runs = ([("bench_ckpt", None)] if args.bench_ckpt
            else [(str(s), s) for s in args.seeds])
    for name, seed in runs:
        entry = {}
        if seed is None:
            net = load_bench_net(args.bench_ckpt, C + O, args.device)
        else:
            exp = os.path.join(args.out, "seed{}".format(seed))
            if not os.path.isdir(exp) or not os.path.exists(
                    os.path.join(exp, "model_best")):
                hist = train_seed(
                    exp, data_dir, seed=seed, num_classes=C, num_offsets=O,
                    epochs=args.epochs, batch_size=args.batch_size,
                    crop_size=args.crop_size, device=args.device,
                    log=lambda s: print(s, flush=True))
                entry["train"] = hist
            net = load_trained(exp, C, O, args.device)
        r = score(net, data_dir, C, offsets, decoders, device=args.device,
                  log=lambda s: print(s, flush=True))
        entry.update({"times_s": {k: round(v, 1) for k, v in
                                  r["times_s"].items()},
                      "overflow": r["overflow"]})
        for k in decoders:
            entry[k] = {"AP": round(r[k][0], 4), "AP50": round(r[k][1], 4)}
        summary["seeds"][name] = entry
        print("{}: {}".format(name, json.dumps(
            {k: v for k, v in entry.items() if k != "train"})), flush=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
