"""The JAX package's mask-AP on the 8 certification512 fixtures, the
figures that `torch_port_helpers.JAX_AP` records and `chip_smoke.py`
holds the card's decodes to:

    JAX_PLATFORMS=cpu python tests/jax_certification_ap.py   # ~5 min

Decodes each fixture with `decode_hierarchical` + `relabel_mask` (hier)
and `run_segmentation_device`'s default exact mode at the served
settings, takes the committed `cpp_mask_*.npz` as the C++ greedy's, and
scores each decoder with the JAX package's COCOeval under procedure (a),
every image of val_ann.json (the reference's certification), and (b),
the 8 fixture images only; "a01" is hier over fixtures 0 and 1 under
(a).  Prints the dict that `JAX_AP` holds."""

import contextlib
import io
import json
import os
import sys

import numpy as np

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                   "certification512")
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


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from mergenet_tpu.data.coco import COCO
    with contextlib.redirect_stdout(io.StringIO()):
        coco = COCO(os.path.join(FIX, "val_ann.json"))
    ids = list(range(8))
    res = {name: {i: results(name, i) for i in ids}
           for name in ("hier", "exact", "cpp")}
    out = {}
    for proc in ("a", "b"):
        out[proc] = {name: jax_ap(coco, [x for i in ids for x in r[i]],
                                  None if proc == "a" else ids)
                     for name, r in res.items()}
    out["a01"] = {"hier": jax_ap(coco, res["hier"][0] + res["hier"][1])}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
