"""`mergenet_tpu_torch/certify.py`, the port's certification workload,
against the JAX package at a small size (2 val images of 64x128 from the
port's generator, 9 classes): `certify.score` runs a net and decodes its
maps with the port's hier and exact decoders, and the JAX package's
`decode_hierarchical` + `relabel_mask` and `run_segmentation_device` on
the same maps, through `scripts/make_certification_fixtures.py`'s own
`mask_to_results` and `coco_ap` (imported by path), must give the same
COCO results, AP and AP50, and overflow counts.  Two nets: a seeded
`unet_small` (untrained maps), and an oracle whose logits come from the
ground truth with seeded noise (maps a trained net would give: AP well
above 0).  Then one `train_seed` epoch and the CLI on the CPU."""

import contextlib
import importlib.util
import io as _io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.data.coco import COCO as JCOCO
from mergenet_tpu.decoder.device import (decode_hierarchical, relabel_mask,
                                         run_segmentation_device)
from mergenet_tpu_torch import certify as CT
from mergenet_tpu_torch.core import generate_offsets
from mergenet_tpu_torch.data import COCO
from mergenet_tpu_torch.models import get_model, init_model
from mergenet_tpu_torch.ops.targets import mask_to_target_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, O = 9, 10
OFFSETS = tuple(generate_offsets(80, O))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cert") / "data")
    s, n = CT.regenerate(d, train_images=4, val_images=2, height=64,
                         width=128, num_classes=C, seed=100)
    assert n == 6 and s > 0
    assert CT.regenerate(d) == (0.0, 0)  # kept
    return d


@pytest.fixture(scope="module")
def cert():
    spec = importlib.util.spec_from_file_location(
        "make_certification_fixtures",
        os.path.join(ROOT, "scripts", "make_certification_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class OracleNet(torch.nn.Module):
    """Logits of the val images' ground truth (class one-hot at 0.9,
    sameness planes at 0.95) with seeded noise, in the order `score`
    visits the images (sorted ids)."""

    def __init__(self, data):
        super().__init__()
        with contextlib.redirect_stdout(_io.StringIO()):
            coco = COCO(os.path.join(data, "annotations",
                                     "instancesonly_val.json"))
        rng = np.random.default_rng(0)
        self.logits = []
        cats = [0] + coco.getCatIds()
        for img_id in sorted(coco.imgs):
            info = coco.imgs[img_id]
            mask = np.zeros((info["height"], info["width"]), np.int64)
            table = [0]
            for i, ann in enumerate(coco.loadAnns(coco.getAnnIds(
                    imgIds=img_id)), 1):
                mask[(coco.annToMask(ann) > 0) & (mask == 0)] = i
                table.append(cats.index(ann["category_id"]))
            t = mask_to_target_np(mask, np.array(table), C, OFFSETS)
            p = np.where(t > 0, 0.9, 0.1 / C)
            p[..., C:] = np.where(t[..., C:] > 0, 0.95, 0.05)
            p = np.clip(p + rng.normal(0, 0.04, p.shape), 0.01, 0.99)
            self.logits.append(torch.from_numpy(
                np.log(p / (1 - p)).astype(np.float32))[None])
        self.calls = 0

    def forward(self, x):
        out = self.logits[self.calls % len(self.logits)]
        self.calls += 1
        assert out.shape[1:3] == x.shape[1:3]
        return out


def _unet_small(data):
    return init_model(get_model(C, O, "unet_small"), 3)


@pytest.mark.parametrize("make", [_unet_small, OracleNet],
                         ids=["unet_small", "oracle"])
def test_score_equals_jax_package(data, cert, make):
    maps = {}
    got = CT.score(make(data), data, C, OFFSETS, ("hier", "exact"),
                   device="cpu",
                   on_probs=lambda n, i, cp, sp: maps.__setitem__(i, (cp,
                                                                      sp)))
    assert got["images"] == len(maps) == 2
    res = {"hier": [], "exact": []}
    overflow = {k: 0 for k in CT.OVERFLOW_KEYS}
    for img_id, (cp, sp) in sorted(maps.items()):
        comp, rc, ii, st = decode_hierarchical(
            jnp.asarray(cp), jnp.asarray(sp), C, OFFSETS, return_stats=True,
            **CT.DECODE_KW)
        mask, ic = relabel_mask(comp, rc, ii)
        for k in overflow:
            overflow[k] += int(st[k])
        res["hier"] += cert.mask_to_results(
            np.asarray(mask), [int(c) for c in np.asarray(ic) if c >= 0],
            img_id)
        emask, ecls = run_segmentation_device(
            np.moveaxis(cp, -1, 0), np.moveaxis(sp, -1, 0), C, OFFSETS,
            **CT.DECODE_KW)
        res["exact"] += cert.mask_to_results(emask, ecls, img_id)
    with contextlib.redirect_stdout(_io.StringIO()):
        jcoco = JCOCO(os.path.join(data, "annotations",
                                   "instancesonly_val.json"))
    assert got["overflow"] == overflow
    for k in ("hier", "exact"):
        # (COCO.loadRes adds `id` and `iscrowd` to the results it scores,
        # in both packages: compare them after both were scored)
        assert got[k] == cert.coco_ap(jcoco, res[k]), k
        assert got["results"][k] == res[k], k
    if make is OracleNet:
        assert got["hier"][0] > 0.5 and got["exact"][0] > 0.5


def test_train_seed_one_epoch_writes_model_best(data, tmp_path):
    exp = str(tmp_path / "seed0")
    hist = CT.train_seed(exp, data, seed=0, num_classes=C, num_offsets=O,
                         epochs=1, batch_size=2, crop_size=32,
                         arch="unet_small", device="cpu")
    assert hist["steps"] == [2] and len(hist["loss"]) == 1
    assert np.isfinite(hist["loss"][0]) and np.isfinite(hist["val"][0])
    assert os.path.exists(os.path.join(exp, "model_best"))
    with open(os.path.join(exp, "model_best.meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and [tuple(o) for o in meta["offsets"]] == \
        list(OFFSETS)
    net = CT.load_trained(exp, C, O, device="cpu", arch="unet_small")
    r = CT.score(net, data, C, OFFSETS, ("hier",), device="cpu")
    assert r["images"] == 2 and 0.0 <= r["hier"][0] <= 1.0
    rate, n = CT.loader_rate(data, batch_size=2, crop_size=32)
    assert n == 4 and rate > 0


def test_cli_writes_the_reference_summary(data, tmp_path):
    """`python -m mergenet_tpu_torch.certify` end to end on the CPU at a
    toy size: regenerate, train one PSPFPNet-r50 epoch, score hier and
    exact, write summary.json in the reference's shape."""
    out = str(tmp_path / "cli")
    argv = ["--out", out, "--seeds", "0", "--epochs", "1", "--height", "64",
            "--width", "128", "--train-images", "2", "--val-images", "1",
            "--crop-size", "64", "--batch-size", "2", "--skip-cpp",
            "--device", "cpu"]
    with contextlib.redirect_stdout(_io.StringIO()):
        assert CT.main(argv) == 0
    with open(os.path.join(out, "summary.json")) as f:
        summary = json.load(f)
    assert summary["offsets"] == [list(o) for o in OFFSETS]
    entry = summary["seeds"]["0"]
    assert set(entry) >= {"times_s", "overflow", "hier", "exact", "train"}
    assert set(entry["hier"]) == {"AP", "AP50"}
    assert summary["config"]["data_seed"] == 100
