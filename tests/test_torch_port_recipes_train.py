"""The port's net-side recipes (`mergenet_tpu_torch/egs/cityscape/
{train,class_infer,offset_infer,infer_e2e}.py`, run in this process
through their `main`, on the CPU) against the JAX package's library
calls that the JAX recipes make, from the same Flax variables.

Two 32x48 images with two rectangles each (categories 11 and 12);
unet_small with C=3 and O=3, its Flax init carried into a port
checkpoint (`convert.load_flax_weights`, `utils.checkpoint.
save_checkpoint`, the offsets in `.meta.json`):
- `class_infer` / `offset_infer`: the `<id>.{class,offset}.npy` maps
  within 1e-5 of JAX's `class_inference` / `offset_inference`, and the
  checkpoint's offsets recorded beside the offset maps;
- `infer_e2e`: the pkls hold the results of JAX's `build_e2e_infer`
  (hier) up to instance renaming (sets of (category_id, RLE counts));
  the head's biases are set so that the images hold instances;
- `train`: one epoch in each mode, through the loader and the compact
  pipeline, writes `checkpoint` and `model_best` with their
  `.meta.json` (the offsets in modes all and offset), the layout
  `tests/test_recipes.py` asks of the JAX recipe."""

import contextlib
import copy
import io as _io
import json
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.data import ClassDataset as JClassDataset
from mergenet_tpu.data import DataLoader as JDataLoader
from mergenet_tpu.data import OffsetDataset as JOffsetDataset
from mergenet_tpu.models import get_model as jget_model
from mergenet_tpu.parallel import train as JT
from mergenet_tpu.utils.e2e import build_e2e_infer as jbuild_e2e
from mergenet_tpu.utils.e2e import masks_to_results as jmasks_to_results
from mergenet_tpu.utils.inference_utils import (class_inference,
                                                offset_inference)
from mergenet_tpu_torch.convert import load_flax_weights
from mergenet_tpu_torch.data import rle
from mergenet_tpu_torch.egs.cityscape import class_infer as P_class
from mergenet_tpu_torch.egs.cityscape import infer_e2e as P_e2e
from mergenet_tpu_torch.egs.cityscape import offset_infer as P_offset
from mergenet_tpu_torch.egs.cityscape import train as P_train
from mergenet_tpu_torch.egs.common import read_offsets
from mergenet_tpu_torch.models import get_model
from mergenet_tpu_torch.parallel import train as TT
from mergenet_tpu_torch.utils.checkpoint import save_checkpoint

H, W, C, O = 32, 48, 3, 3
OFFSETS = [(1, 0), (0, 1), (-2, 3)]
CATS = [{"id": 11, "name": "car"}, {"id": 12, "name": "person"}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("recipes_train")
    rng = np.random.default_rng(7)
    images, anns = [], []
    for i in range(2):
        img = np.full((H, W, 3), 40, np.uint8)
        for x, y, w, h, cat in ((3, 4, 14, 10, 0), (24, 15, 16, 12, 1)):
            img[y:y + h, x:x + w] = (220, 60, 60) if cat == 0 \
                else (60, 60, 220)
            m = np.zeros((H, W), np.uint8)
            m[y:y + h, x:x + w] = 1
            r = rle.encode(np.asfortranarray(m))
            anns.append({"id": len(anns) + 1, "image_id": 100 + i,
                         "category_id": CATS[cat]["id"],
                         "segmentation": {"size": r["size"], "counts":
                                          r["counts"].decode("ascii")},
                         "area": int(m.sum()), "iscrowd": 0,
                         "bbox": [x, y, w, h]})
        noisy = np.clip(img.astype(int) + rng.integers(-10, 10, img.shape),
                        0, 255).astype(np.uint8)
        cv2.imwrite(str(root / ("img%d.png" % i)),
                    cv2.cvtColor(noisy, cv2.COLOR_RGB2BGR))
        images.append({"id": 100 + i, "file_name": "img%d.png" % i,
                       "height": H, "width": W})
    (root / "ann.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": CATS}))
    return root


def _flax(nc, no, seed, head_bias=None):
    jm = jget_model(nc, no, "unet_small")
    v = jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                  jnp.zeros((1, H, W, 3)), train=False))(
        jax.random.PRNGKey(seed))
    p, b = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                  (v["params"], v["batch_stats"]))
    if head_bias is not None:
        p = copy.deepcopy(p)
        p["Conv_0"]["bias"] = np.asarray(head_bias, np.float32)
    return jm, p, b


def _port_checkpoint(exp, nc, no, p, b, offsets):
    model = load_flax_weights(get_model(nc, no, "unet_small"), p, b)
    tx = TT.make_optimizer()
    state = TT.TrainState(step=0, model=model,
                          optimizer=tx.init(model.parameters()), tx=tx)
    save_checkpoint(str(exp), state, True, offsets=offsets, epoch=1)
    return str(exp / "model_best")


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(_io.StringIO()):
        return fn(*a, **k)


def _jax_state(jm, p, b):
    tx = JT.make_optimizer()
    return JT.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                         batch_stats=b, opt_state=tx.init(p), tx=tx,
                         apply_fn=jm.apply)


def test_class_and_offset_infer_match_jax_inference(data, tmp_path):
    common = ["--img", str(data), "--ann", str(data / "ann.json"),
              "--arch", "unet_small", "--device", "cpu"]
    # class head
    jm, p, b = _flax(C, 0, 1)
    ckpt = _port_checkpoint(tmp_path / "cls", C, 0, p, b, None)
    _quiet(P_class.main, ["--dir", str(tmp_path / "pc"), "--model", ckpt,
                          "--num-classes", str(C), "--score"] + common)
    ds = JClassDataset(str(data), str(data / "ann.json"), mode="val")
    _quiet(class_inference, JDataLoader(ds, batch_size=1),
           str(tmp_path / "jc"), _jax_state(jm, p, b), C, 1)
    # offset head: the offsets come from the checkpoint
    jm, p, b = _flax(0, O, 2)
    ckpt = _port_checkpoint(tmp_path / "ofs", 0, O, p, b, OFFSETS)
    _quiet(P_offset.main, ["--dir", str(tmp_path / "po"), "--model", ckpt,
                           "--num-offsets", str(O), "--score"] + common)
    ds = JOffsetDataset(str(data), str(data / "ann.json"), OFFSETS,
                        mode="val")
    _quiet(offset_inference, JDataLoader(ds, batch_size=1),
           str(tmp_path / "jo"), _jax_state(jm, p, b), OFFSETS, 1)
    for port, ref, kind, n in (("pc", "jc", "class", C),
                               ("po", "jo", "offset", O)):
        for i in (100, 101):
            name = "npy/%d.%s.npy" % (i, kind)
            got = np.load(tmp_path / port / name)
            assert got.shape == (n, H, W) and got.dtype == np.float32
            np.testing.assert_allclose(got, np.load(tmp_path / ref / name),
                                       atol=1e-5, rtol=0)
    # the offsets recorded beside the maps, for segment
    assert read_offsets(str(tmp_path / "po")) == OFFSETS


def test_infer_e2e_matches_jax_e2e(data, tmp_path):
    jm, p, b = _flax(C, O, 3, head_bias=[0.0, 0.5, -0.5, 3.0, 3.0, 3.0])
    ckpt = _port_checkpoint(tmp_path / "all", C, O, p, b, OFFSETS)
    _quiet(P_e2e.main, ["--dir", str(tmp_path / "e2e"), "--model", ckpt,
                        "--img", str(data), "--ann", str(data / "ann.json"),
                        "--arch", "unet_small", "--num-classes", str(C),
                        "--num-offsets", str(O), "--batch-size", "2",
                        "--device", "cpu"])
    imgs = np.stack([cv2.cvtColor(cv2.imread(str(data / (
        "img%d.png" % i))), cv2.COLOR_BGR2RGB) for i in (0, 1)]
                    ).astype(np.float32) / 256.0
    masks, classes = jbuild_e2e(jm, C, OFFSETS)(
        {"params": p, "batch_stats": b}, imgs)
    ref = jmasks_to_results(np.asarray(masks), np.asarray(classes),
                            [100, 101], [0, 11, 12])
    assert ref  # the images hold instances
    for i in (100, 101):
        with open(tmp_path / "e2e" / "segment" / "pkl" / ("%d.pkl" % i),
                  "rb") as f:
            got = pickle.load(f)
        key = {(r["category_id"], r["segmentation"]["counts"]) for r in got}
        assert key == {(r["category_id"], r["segmentation"]["counts"])
                       for r in ref if r["image_id"] == i}


@pytest.mark.parametrize("mode", ["all", "class", "offset"])
@pytest.mark.parametrize("pipeline", ["loader", "grain"])
def test_train_recipe_writes_the_checkpoint_layout(data, tmp_path, mode,
                                                   pipeline):
    exp = tmp_path / ("%s_%s" % (mode, pipeline))
    argv = [str(exp), "--mode", mode, "--input-pipeline", pipeline,
            "--train-img", str(data), "--val-img", str(data),
            "--train-ann", str(data / "ann.json"),
            "--val-ann", str(data / "ann.json"), "--num-classes", str(C),
            "--num-offsets", str(O), "--arch", "unet_small",
            "--batch-size", "2", "--epochs", "1", "--lr", "0.02",
            "--device", "cpu"]
    if pipeline == "grain":
        argv += ["--crop-size", "32"]
    out = _quiet(lambda: (P_train.main(argv), None))
    assert out[0] == 0
    for name in ("checkpoint", "model_best"):
        assert os.path.isfile(exp / name)
        meta = json.loads((exp / (name + ".meta.json")).read_text())
        assert meta["epoch"] == 1
        if mode == "class":
            assert meta["offsets"] is None
        else:
            assert len(meta["offsets"]) == O
    state = TT.create_train_state(
        get_model(0 if mode == "offset" else C, 0 if mode == "class" else O,
                  "unet_small"), TT.make_optimizer(), device="cpu")
    from mergenet_tpu_torch.utils.checkpoint import load_checkpoint
    state, _ = load_checkpoint(str(exp / "model_best"), state)
    assert state.step == 1  # 2 images, batch 2: one update
