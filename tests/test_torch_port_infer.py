"""The port's inference loops (`utils/inference_utils.py`) against the
JAX package's on the CPU, and its profiling helpers
(`utils/profiling.py`).

A small PSPFPNet(layer=18, fpn_dim=16) with 5 outputs (seeded weights,
carried to Flax by `convert.state_dict_to_flax`) runs over a loader of
two batches of (ids, images, targets) on both sides: `class_inference`
plain (sigmoid, the first 3 planes) and with a `tile_predict_fn`
(32x48 windows, flips, 5 model classes remapped to 3), and
`offset_inference` (the last 2 planes).  Each `<id>.{class,offset}.npy`
is (C, H, W) float32 and equal to JAX's within 1e-5 (probabilities of
logits equal to ~1e-6: `test_torch_port_zoo.py`); with `score=True`
the printed statistics carry the same labels, and the same numbers to
rtol 1e-5."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models.pspnet import PSPFPNet as JPSPFPNet
from mergenet_tpu.models.tiling import tile_predict as jtile_predict
from mergenet_tpu.parallel import train as JT
from mergenet_tpu.utils import inference_utils as JI
from mergenet_tpu_torch.convert import state_dict_to_flax
from mergenet_tpu_torch.models import PSPFPNet, init_model, tile_predict
from mergenet_tpu_torch.parallel import train as TT
from mergenet_tpu_torch.utils import inference_utils as TI
from mergenet_tpu_torch.utils import profiling
from torch_port_helpers import randomize_batch_norm

NOUT, C, OFFSETS = 5, 3, ((1, 0), (0, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    model = randomize_batch_norm(init_model(PSPFPNet(NOUT, layer=18,
                                                     fpn_dim=16), 61), 62)
    p, b = state_dict_to_flax(model)
    jm = JPSPFPNet(NOUT, layer=18, fpn_dim=16)
    tx = JT.make_optimizer()
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                           batch_stats=b, opt_state=tx.init(p), tx=tx,
                           apply_fn=jm.apply)
    tstate = TT.TrainState(step=0, model=model,
                           optimizer=TT.make_optimizer().init(
                               model.parameters()), tx=TT.make_optimizer())
    rng = np.random.default_rng(63)
    loader = [(np.array([3 + 2 * i, 4 + 2 * i]),
               rng.random((2, 64, 64, 3)).astype(np.float32),
               (rng.random((2, 64, 64, NOUT)) < 0.4).astype(np.float32))
              for i in range(2)]
    japply = jax.jit(lambda x: jm.apply({"params": p, "batch_stats": b}, x,
                                        train=False))
    # JAX's `_forward_sigmoid(state)`, jitted once for both loops
    jsigmoid = jax.jit(lambda x: jax.nn.sigmoid(japply(x)))

    def tapply(x):
        with torch.no_grad():
            return model.eval()(x)
    return jstate, tstate, loader, japply, tapply, jsigmoid


def _stats(text):
    """(labels, numbers) of the printed statistics: every line but the
    per-batch timing lines."""
    lines = [ln for ln in text.splitlines() if not ln.startswith("Val:")]
    labels = [re.sub(r"[-+0-9.e]+$", "", ln.strip()) for ln in lines]
    nums = [float(m) for ln in lines
            for m in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?|nan", ln)]
    return labels, np.array(nums)


def _compare(tmp_path, suffix, n_planes, jout, tout):
    files = sorted(os.listdir(tmp_path / "jax" / "npy"))
    assert files == sorted(os.listdir(tmp_path / "torch" / "npy")) == [
        "%d.%s.npy" % (i, suffix) for i in (3, 4, 5, 6)]
    for f in files:
        ref = np.load(tmp_path / "jax" / "npy" / f)
        got = np.load(tmp_path / "torch" / "npy" / f)
        assert got.dtype == np.float32 and got.shape == ref.shape == (
            n_planes, 64, 64)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    (jl, jn), (tl, tn) = _stats(jout), _stats(tout)
    assert tl == jl and len(jn) > 4
    np.testing.assert_allclose(tn, jn, rtol=1e-5)


@pytest.fixture
def jax_forward_once(setup, monkeypatch):
    """JAX's loops build a new jitted forward per call; one compiled
    forward of the same function serves both here."""
    monkeypatch.setattr(JI, "_forward_sigmoid", lambda state: setup[5])


@pytest.mark.parametrize("tiled", [False, True])
def test_class_inference_matches_reference(setup, tiled, tmp_path, capsys,
                                           jax_forward_once):
    jstate, tstate, loader, japply, tapply, _ = setup
    jfn = tfn = None
    if tiled:
        def jfn(img):
            return jtile_predict(japply, jnp.asarray(img), C, (32, 48),
                                 n_model_classes=NOUT)

        def tfn(img):
            assert img.device == tstate.device
            return tile_predict(tapply, img, C, (32, 48),
                                n_model_classes=NOUT)
    JI.class_inference(loader, str(tmp_path / "jax"), jstate, C, 2,
                       score=True, tile_predict_fn=jfn)
    jout = capsys.readouterr().out
    TI.class_inference(loader, str(tmp_path / "torch"), tstate, C, 2,
                       score=True, tile_predict_fn=tfn)
    tout = capsys.readouterr().out
    _compare(tmp_path, "class", C, jout, tout)
    if tiled:  # a tiled map is a distribution over the C classes
        got = np.load(tmp_path / "torch" / "npy" / "3.class.npy")
        np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-5)


def test_offset_inference_matches_reference(setup, tmp_path, capsys,
                                            jax_forward_once):
    jstate, tstate, loader = setup[:3]
    JI.offset_inference(loader, str(tmp_path / "jax"), jstate, OFFSETS, 2,
                        score=True)
    jout = capsys.readouterr().out
    TI.offset_inference(loader, str(tmp_path / "torch"), tstate, OFFSETS, 2,
                        score=True)
    tout = capsys.readouterr().out
    _compare(tmp_path, "offset", len(OFFSETS), jout, tout)
    # without targets: a loader of (ids, images)
    TI.offset_inference([(ids, imgs) for ids, imgs, _ in loader],
                        str(tmp_path / "bare"), tstate, OFFSETS, 2)
    np.testing.assert_array_equal(
        np.load(tmp_path / "bare" / "npy" / "6.offset.npy"),
        np.load(tmp_path / "torch" / "npy" / "6.offset.npy"))


def test_stopwatch_and_trace(tmp_path, capsys):
    sw = profiling.Stopwatch()
    x = torch.ones(64, 64)
    for _ in range(3):
        with sw.span("matmul", sync=x):
            x = x @ x / 64
    with sw.span("host"):
        pass
    assert sw.counts == {"matmul": 3, "host": 1}
    assert sw.totals["matmul"] > 0
    text = sw.summary()
    assert text == capsys.readouterr().out.strip()
    assert text.splitlines()[1].startswith("matmul") and "n     3" in text
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("the_region"):
            torch.ones(8, 8).sum()
    trace = (tmp_path / "tr" / "trace.json").read_text()
    assert "the_region" in trace
