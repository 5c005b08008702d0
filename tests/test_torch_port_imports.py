"""The port runs where the GPU machine has no jax, flax, cv2, PIL or
grain, and never imports the JAX package: every module of
`mergenet_tpu_torch` and `chip_smoke.py` import, and a small decode, a
forward, the data slice (generate, read a PNG and a JPEG, resize, fill a
polygon, load a batch) and the Cityscapes converter run, in a subprocess
where those modules are blocked.  The JPEG decoder is the port's own
source: it includes no libjpeg header and links no libjpeg."""

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
              "data.pipeline", "certify", "parallel.mesh",
              "parallel.spatial", "utils.visualization", "egs.common",
              "egs.cityscape.train", "egs.cityscape.class_infer",
              "egs.cityscape.offset_infer", "egs.cityscape.segment",
              "egs.cityscape.infer_e2e", "egs.cityscape.evaluate",
              "egs.cityscape.submit", "egs.cityscape.make_synthetic_data",
              "egs.cityscape.convert_caffe_to_pytorch", "egs.coco.train",
              "egs.coco.segment", "egs.coco.evaluate", "data.contours",
              "egs.cityscape.convert_cityscapes_to_coco",
              "egs.cityscape.cityscapes_labels", "data.jpeg",
              "_host_build"):
        assert "mergenet_tpu_torch." + m in mods, m
    from mergenet_tpu_torch.decoder import csegment
    from mergenet_tpu_torch.e2e import masks_to_results
    assert csegment._lib is None  # nothing is built at import
    from mergenet_tpu_torch.data import jpeg
    assert jpeg._lib is None
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
    assert imgproc.imread_rgb("tests/fixtures/jpeg/matrix/s420.jpg").shape \
        == (512, 1024, 3)
    imgproc.resize(np.zeros((8, 8, 9), np.float32), (4, 4))
    from mergenet_tpu_torch.utils.visualization import visualize_mask
    visualize_mask(np.zeros((20, 30, 3), np.uint8),
                   np.arange(600, dtype=np.int32).reshape(20, 30) %% 13)
    from mergenet_tpu_torch.parallel import make_mesh, shard_batch
    shard_batch(np.zeros((2, 3)), make_mesh(device="cpu"))
    rle.frPyObjects([[1.0, 1.0, 9.0, 1.0, 9.0, 9.0]], 12, 12)
    import json
    from mergenet_tpu_torch import io
    from mergenet_tpu_torch.egs.cityscape import convert_cityscapes_to_coco
    with tempfile.TemporaryDirectory() as d:
        gt = os.path.join(d, "gtFine_trainvaltest", "gtFine", "val", "c")
        os.makedirs(gt)
        ids = np.zeros((16, 24), np.uint16)
        ids[2:9, 3:12] = 26001
        io.write_png(os.path.join(gt, "c_0_0_gtFine_instanceIds.png"), ids)
        with open(os.path.join(gt, "c_0_0_gtFine_polygons.json"), "w") as f:
            json.dump({"imgWidth": 24, "imgHeight": 16, "objects": []}, f)
        convert_cityscapes_to_coco.main(["--dataset-dir", d, "--out-dir", d])
        with open(os.path.join(
                d, "instancesonly_filtered_gtFine_val.json")) as f:
            assert json.load(f)["annotations"][0]["area"] == 63.0
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
    assert int(proc.stdout.split("IMPORTED")[1]) >= 45


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


def test_port_shell_drivers_call_only_the_port():
    """The recipes' shell twins run `python3 -m mergenet_tpu_torch.egs...`
    and name neither the JAX recipes' folder nor the JAX package."""
    scripts = sorted((ROOT / "mergenet_tpu_torch" / "egs").rglob("*.sh"))
    assert len(scripts) == 7
    # the COCO twin of prepare_data.sh only links directories, as the
    # reference's does: it runs no interpreter
    links_only = ROOT / "mergenet_tpu_torch" / "egs" / "coco" / \
        "prepare_data.sh"
    for f in scripts:
        text = f.read_text()
        assert "egs/" not in text and "mergenet_tpu." not in text, f
        code = [ln for ln in text.splitlines()
                if not ln.lstrip().startswith("#")]
        for line in code:  # every interpreter runs a module (-m)
            assert not re.search(r"\bpython3?\b(?!\s+-m\b)", line), (f, line)
        if f.name != "parse_options.sh" and f != links_only:
            assert "mergenet_tpu_torch.egs." in "\n".join(code), f


def test_jpeg_decoder_uses_no_libjpeg():
    from mergenet_tpu_torch.data import jpeg
    src = pathlib.Path(jpeg.SRC).read_text()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)", src, re.M)
    assert includes and all("/" not in h and "jpeg" not in h.lower()
                            for h in includes), includes
    assert not any(f.startswith("-l") or "jpeg" in f
                   for f in jpeg.CXX_FLAGS), jpeg.CXX_FLAGS
    lib = jpeg.build()
    needed = subprocess.run(["ldd", lib], capture_output=True, text=True)
    assert needed.returncode == 0 and "libstdc++" in needed.stdout
    assert "jpeg" not in needed.stdout, needed.stdout
