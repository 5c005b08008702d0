"""The JAX package's mask-AP on the certification workload, the figures
that `torch_port_helpers.JAX_AP` records and `chip_smoke.py` holds the
card's decodes to:

    JAX_PLATFORMS=cpu python tests/jax_certification_ap.py     # (a), (b): ~5 min
    JAX_PLATFORMS=cpu python tests/jax_certification_ap.py c   # (c): ~17 min
    JAX_PLATFORMS=cpu python tests/jax_certification_ap.py c_jpeg  # ~3 min
    JAX_PLATFORMS=cpu python tests/jax_certification_ap.py c_exact_0_7  # 3 min
    JAX_PLATFORMS=cpu python tests/jax_certification_ap.py c_exact_0_7 \
        --save-exact tests/fixtures/certification512

Decodes each fixture with `decode_hierarchical` + `relabel_mask` (hier)
and `run_segmentation_device`'s default exact mode at the served
settings, takes the committed `cpp_mask_*.npz` as the C++ greedy's, and
scores each decoder with the JAX package's COCOeval under procedure (a),
every image of val_ann.json (the reference's certification), and (b),
the 8 fixture images only; "a01" is hier over fixtures 0 and 1 under
(a).

Procedure (c) regenerates the 50 val images with the reference
generator (`egs/cityscape/local/make_synthetic_data.py`, the committed
`summary.json`'s config: seed 100, 512x1024, C=9; the val split draws
from seed 101), runs the JAX package's PSPFPNet-r50 with the committed
`bench_ckpt.npz` (float16 parameters widened to float32) on each image
as `scripts/make_certification_fixtures.py`'s `probs_fn` does, decodes
hier (`decode_hierarchical` + `relabel_mask`) and exact
(`run_segmentation_device`) at the served settings, and scores them with
that script's `mask_to_results` and `coco_ap` (the JAX package's
COCOeval) over every val image; the maps of val images 0-7 are also
held against the committed `probs_<i>.npz` (largest and mean absolute
difference, share of pixels whose class argmax differs).  `--data DIR`
keeps the regenerated images (default: a temporary directory).

Procedure "c_jpeg" is (c) with the hier decode only, on the committed
JPEG encodings of the same 50 images (`tests/fixtures/jpeg/val/`,
quality 90, 4:2:0, written by `tests/make_jpeg_fixtures.py`), read with
`cv2.imread` as the JAX package reads images.  Procedure
"c_exact_0_7" is (c)'s exact column on val images 0-7 alone, scored
over those 8 images (the images `chip_smoke.py` decodes exact in its
(c) phase); `--save-exact DIR` writes each of their exact decodes to
DIR/c_exact_<i>.npz (`mask`, `classes`), the masks `chip_smoke.py`
holds the card's to.  Prints the dict that `JAX_AP` holds."""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "certification512")
JPEG_VAL = os.path.join(REPO, "tests", "fixtures", "jpeg", "val")
SERVE_KW = dict(object_merge_factor=1.0, merge_logprob_bias=0.03)


def jax_ap(coco, results, img_ids=None):
    """(AP, AP50) with the JAX package's COCOeval('segm')."""
    from mergenet_tpu.data.cocoeval import COCOeval
    from torch_port_helpers import coco_stats
    return tuple(coco_stats(coco, results, img_ids, COCOeval)[:2])


def results(decoder, i):
    """COCO results of fixture i through the JAX package's decoder
    ('hier', 'exact') or the committed C++ mask ('cpp')."""
    import jax.numpy as jnp
    from mergenet_tpu.decoder.device import (decode_hierarchical,
                                             relabel_mask,
                                             run_segmentation_device)
    from mergenet_tpu.utils.e2e import masks_to_results
    offsets = tuple(tuple(int(x) for x in o)
                    for o in np.load(os.path.join(FIX, "offsets.npy")))
    cats = list(range(9))
    if decoder == "cpp":
        with np.load(os.path.join(FIX, "cpp_mask_%d.npz" % i)) as cm:
            return masks_to_results(cm["mask"][None], cm["classes"][None],
                                    [i], cats)
    with np.load(os.path.join(FIX, "probs_%d.npz" % i)) as d:
        cp, sp = d["cp"].astype(np.float32), d["sp"].astype(np.float32)
    if decoder == "hier":
        comp, rc, ii = decode_hierarchical(jnp.asarray(cp), jnp.asarray(sp),
                                           9, offsets, **SERVE_KW)
        mask, ic = relabel_mask(comp, rc, ii)
        return masks_to_results(np.asarray(mask)[None],
                                np.asarray(ic)[None], [i], cats)
    mask, classes = run_segmentation_device(
        np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0), 9, offsets,
        **SERVE_KW)
    return masks_to_results(mask[None],
                            np.asarray(classes + [-1], np.int32)[None], [i],
                            cats)


def _script(name, path):
    """Import a repository script by path (it is not a package module)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def procedure_c(data_dir, decoders=("hier", "exact"), image_dir=None,
                limit=None, save_exact=None):
    """{"hier": (AP, AP50), "exact": (AP, AP50), "overflow": {...},
    "times_s": {...}}: the JAX package on the 50 val images regenerated
    by the reference generator, scored as the certification script
    scores them.  `image_dir` reads each image from there instead, under
    its name with `.jpg` (procedure "c_jpeg"); `limit` takes the first
    `limit` val images and scores over them alone; `save_exact` is a
    directory for the exact masks of val images 0-7."""
    import jax
    import jax.numpy as jnp
    import cv2
    from mergenet_tpu.models import get_model
    from mergenet_tpu.data.coco import COCO
    from mergenet_tpu.decoder.device import (decode_hierarchical,
                                             relabel_mask,
                                             run_segmentation_device)
    from mergenet_tpu_torch.io import load_bench_checkpoint
    cert = _script("make_certification_fixtures", os.path.join(
        REPO, "scripts", "make_certification_fixtures.py"))
    val_ann = os.path.join(data_dir, "annotations", "instancesonly_val.json")
    if not os.path.exists(val_ann):
        env = dict(os.environ, PYTHONPATH=REPO)
        subprocess.run([sys.executable, os.path.join(
            REPO, "egs", "cityscape", "local", "make_synthetic_data.py"),
            "--out-dir", data_dir, "--train-images", "0", "--val-images",
            "50", "--height", "512", "--width", "1024", "--num-classes", "9",
            "--seed", "100"], env=env, check=True)
    offsets = tuple(tuple(int(x) for x in o)
                    for o in np.load(os.path.join(FIX, "offsets.npy")))
    C, O = 9, len(offsets)
    params, batch_stats = load_bench_checkpoint(
        os.path.join(FIX, "bench_ckpt.npz"))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    batch_stats = jax.tree.map(jnp.asarray, batch_stats)
    model = get_model(C, O, "pspfpnet", verbose=False)

    @jax.jit
    def probs_fn(params, batch_stats, x):
        logits = model.apply({"params": params, "batch_stats": batch_stats},
                             x, train=False)
        return jax.nn.sigmoid(logits)

    with contextlib.redirect_stdout(io.StringIO()):
        coco = COCO(val_ann)
    res = {k: [] for k in decoders}
    times = {k: 0.0 for k in ("net",) + tuple(decoders)}
    overflow = {"edges_dropped": 0, "pairs_dropped": 0, "n_frozen": 0}
    fixture_probs = []
    ids = sorted(coco.imgs)[:limit]
    for n, img_id in enumerate(ids):
        fname = coco.loadImgs(img_id)[0]["file_name"]
        path = os.path.join(data_dir, "val", fname)
        if image_dir is not None:
            path = os.path.join(image_dir, os.path.splitext(fname)[0]
                                + ".jpg")
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        t0 = time.time()
        probs = np.asarray(probs_fn(params, batch_stats, jnp.asarray(
            img.astype(np.float32)[None] / 256.0)))[0]
        times["net"] += time.time() - t0
        cp, sp = probs[..., :C], probs[..., C:]
        if n < 8 and image_dir is None:  # the committed fixture maps
            fcp, fsp = (np.load(os.path.join(FIX, "probs_%d.npz" % n))[k]
                        .astype(np.float32) for k in ("cp", "sp"))
            d = np.abs(probs - np.concatenate([fcp, fsp], -1))
            fixture_probs.append({
                "max_abs": float(d.max()), "mean_abs": float(d.mean()),
                "argmax_differ": float((cp.argmax(-1)
                                        != fcp.argmax(-1)).mean())})
        if "hier" in decoders:
            t0 = time.time()
            comp, rc, ii, st = decode_hierarchical(
                jnp.asarray(cp), jnp.asarray(sp), C, offsets,
                return_stats=True, **SERVE_KW)
            mask, ic = relabel_mask(comp, rc, ii)
            mask = np.asarray(mask)
            times["hier"] += time.time() - t0
            for k in overflow:
                overflow[k] += int(st[k])
            res["hier"] += cert.mask_to_results(
                mask, [int(c) for c in np.asarray(ic) if c >= 0], img_id)
        if "exact" in decoders:
            t0 = time.time()
            emask, ecls = run_segmentation_device(
                np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0), C, offsets,
                **SERVE_KW)
            times["exact"] += time.time() - t0
            if save_exact is not None and n < 8:
                np.savez_compressed(
                    os.path.join(save_exact, "c_exact_%d.npz" % n),
                    mask=np.asarray(emask, np.int32),
                    classes=np.asarray(ecls, np.int32))
            res["exact"] += cert.mask_to_results(emask, ecls, img_id)
        print("  (c) image %d/%d: %s so far" % (
            n + 1, len(ids), ", ".join("%s %.1f s" % kv
                                       for kv in times.items())),
            file=sys.stderr, flush=True)
    if limit is None:
        out = {k: cert.coco_ap(coco, r) for k, r in res.items()}
    else:
        out = {k: jax_ap(coco, r, ids) for k, r in res.items()}
    out["overflow"] = overflow
    out["times_s"] = times
    out["fixture_probs"] = fixture_probs
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("procedures", nargs="*", default=["a", "b"],
                    choices=["a", "b", "c", "c_jpeg", "c_exact_0_7"])
    ap.add_argument("--data", default=None,
                    help="directory for procedure (c)'s regenerated images")
    ap.add_argument("--save-exact", default=None,
                    help="directory for the exact masks of (c)'s val "
                    "images 0-7 (c_exact_<i>.npz)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from mergenet_tpu.data.coco import COCO
    out = {}
    if {"a", "b"} & set(args.procedures):
        with contextlib.redirect_stdout(io.StringIO()):
            coco = COCO(os.path.join(FIX, "val_ann.json"))
        ids = list(range(8))
        res = {name: {i: results(name, i) for i in ids}
               for name in ("hier", "exact", "cpp")}
        for proc in ("a", "b"):
            if proc in args.procedures:
                out[proc] = {name: jax_ap(coco,
                                          [x for i in ids for x in r[i]],
                                          None if proc == "a" else ids)
                             for name, r in res.items()}
        if "a" in args.procedures:
            out["a01"] = {"hier": jax_ap(coco,
                                         res["hier"][0] + res["hier"][1])}
    for proc in ("c", "c_jpeg", "c_exact_0_7"):
        if proc not in args.procedures:
            continue
        kw = {"c": {}, "c_jpeg": dict(decoders=("hier",), image_dir=JPEG_VAL),
              "c_exact_0_7": dict(decoders=("exact",), limit=8)}[proc]
        if "exact" in kw.get("decoders", ("exact",)):
            kw["save_exact"] = args.save_exact
        if args.data:
            out[proc] = procedure_c(args.data, **kw)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                out[proc] = procedure_c(tmp, **kw)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
