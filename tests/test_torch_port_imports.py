"""The port runs where the GPU machine has no jax, flax, cv2, PIL or
grain, and never imports the JAX package: every module of
`mergenet_tpu_torch` and `chip_smoke.py` import, and a small decode, a
forward and the data slice (generate, read, resize, fill a polygon,
load a batch) run, in a subprocess where those modules are blocked."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "cv2", "PIL", "grain", "mergenet_tpu")

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in %r:
        sys.modules[name] = None  # any import of it, or below it, fails
    import numpy as np
    import torch
    import mergenet_tpu_torch
    mods = [m.name for m in pkgutil.walk_packages(
        mergenet_tpu_torch.__path__, "mergenet_tpu_torch.")]
    for m in mods:
        importlib.import_module(m)
    for m in ("serving", "bench_pallas_gather", "ops.pgather", "e2e",
              "decoder.device", "core.offsets", "core.config", "core.types",
              "data.rle", "data.coco", "data.cocoeval", "decoder.segmenter",
              "decoder.csegment", "models.unet", "ops.targets",
              "ops.losses", "ops.metrics", "parallel.train",
              "utils.checkpoint", "utils.logging", "utils.train_utils",
              "models.fcn", "models.vgg", "models.tiling",
              "utils.weight_import", "utils.caffe_import",
              "utils.inference_utils", "utils.profiling", "data.imgproc",
              "data.synthetic", "data.dataset", "data.data_io",
              "data.pipeline", "certify"):
        assert "mergenet_tpu_torch." + m in mods, m
    from mergenet_tpu_torch.decoder import csegment
    from mergenet_tpu_torch.e2e import masks_to_results
    assert csegment._lib is None  # nothing is built at import
    masks_to_results(np.ones((1, 4, 4), np.int32), np.ones((1, 1), np.int32),
                     [0], [0, 1])
    import chip_smoke
    from mergenet_tpu_torch.decoder.device import decode_hierarchical
    from mergenet_tpu_torch.models import PSPFPNet, logits_at
    rng = np.random.default_rng(0)
    cp = rng.random((32, 64, 3)).astype(np.float32)
    sp = rng.random((32, 64, 2)).astype(np.float32)
    mask, cls = decode_hierarchical(cp, sp, 3, ((1, 0), (0, 2)),
                                    relabel=True, device="cpu")
    from mergenet_tpu_torch.decoder.device import run_segmentation_device
    run_segmentation_device(cp.transpose(2, 0, 1), sp.transpose(2, 0, 1),
                            3, ((1, 0), (0, 2)), device="cpu")
    from mergenet_tpu_torch.ops.pgather import pgather
    pgather(torch.arange(5, dtype=torch.int32),
            torch.arange(3, dtype=torch.int32))
    logits_at(PSPFPNet(5).eval(), torch.rand(1, 64, 64, 3), (16, 16))
    from mergenet_tpu_torch.models import PSPNet, tile_predict
    with torch.no_grad():
        tile_predict(PSPNet(3, layer=18).eval(), torch.rand(1, 40, 40, 3),
                     3, (32, 32))
    import os, tempfile
    from mergenet_tpu_torch.data import (AllDataset, DataLoader, imgproc,
                                         rle, synthetic)
    from mergenet_tpu_torch.data.pipeline import make_train_pipeline
    with tempfile.TemporaryDirectory() as d:
        synthetic.generate(d, 2, 1, 32, 48, 3, seed=1)
        ann = os.path.join(d, "annotations", "instancesonly_train.json")
        ds = AllDataset(os.path.join(d, "train"), ann, 3, ((1, 0),),
                        scale=2, crop=True, crop_size=12, seed=0)
        next(iter(DataLoader(ds, batch_size=2, prefetch=1)))
        next(iter(make_train_pipeline(os.path.join(d, "train"), ann, 2,
                                      16)[0]))
    imgproc.resize(np.zeros((9, 9), np.float32), (4, 5))
    rle.frPyObjects([[1.0, 1.0, 9.0, 1.0, 9.0, 9.0]], 12, 12)
    leaked = sorted(n for n in sys.modules if n.split(".")[0] in %r
                    and sys.modules[n] is not None)
    assert not leaked, leaked
    print("IMPORTED", len(mods))
""")


def test_port_imports_without_jax_flax_cv2_pil():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT % (BLOCKED, BLOCKED)], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("IMPORTED")[1]) >= 25


def test_no_reference_imports_in_port_sources():
    """Static check, which also covers imports inside functions that the
    subprocess run does not reach."""
    pat = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(
        re.escape(b) for b in BLOCKED), re.M)
    files = list((ROOT / "mergenet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 27
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)
