"""The training path of the PyTorch port against the JAX package on the
CPU: UNet (`models/unet.py`), the model factory and initialiser
(`models/__init__.py`), `convert.py` both ways, the train and eval
steps (`parallel/train.py`), the epoch loops (`utils/train_utils.py`),
checkpoints (`utils/checkpoint.py`) and the scalar log.

Both sides start from the same Flax variables (carried across by
`convert.py`) and take the same numpy batches.  Tolerances:
- UNet forward: atol 1e-5 on logits of magnitude ~1 (train mode rtol
  1e-4 besides: normalising by the batch's own statistics).
- unet_small, 3 steps of `build_train_step` at 32x32, batch 2: losses
  rtol 1e-4 in float32 and 2e-2 in bf16; parameters and batch-norm
  statistics atol 1e-5 in float32 and 5e-3 in bf16 (measured: 1.2e-7
  and 7.8e-4); `remat=True` bit-equal to `remat=False`.
- PSPFPNet(layer=50, fpn_dim=32), one `build_train_step_compact` step at
  64x64, batch 2, from flax's random init: loss rtol 1e-4; running
  statistics atol 1e-3; each parameter's update (new - old) within 0.25
  of the port's in relative L2 norm (measured: 0.092 at most).  The
  gradient of a ResNet-50 in train-mode batch norm is ill-conditioned in
  float32 at this size (2-8 values per channel at c5 and in the pyramid
  pooling): against the port's own float64 step, the JAX step's
  updates differ by ~4% per leaf (median) and the port's float32 ones
  by as much (held at 0.15; measured 0.080 at most), its running
  statistics by up to 1.2e-4 (held at 1e-3, as against JAX).
- Eval step, loops: atol 1e-5 on probabilities and losses; metrics equal
  to the same tolerance.
- Checkpoints: bit-equal (one process, the same CPU kernels)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models import get_model as jget_model
from mergenet_tpu.models import param_count as jparam_count
from mergenet_tpu.models import probs_at as jprobs_at
from mergenet_tpu.models.pspnet import PSPFPNet as JPSPFPNet
from mergenet_tpu.models.unet import UNet as JUNet
from mergenet_tpu.parallel import train as JT
from mergenet_tpu.utils import train_utils as JU
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.convert import (flax_to_state_dict, load_flax_weights,
                                        state_dict_to_flax)
from mergenet_tpu_torch.models import (VALID_ARCHS, PSPFPNet, UNet, get_model,
                                       init_model, logits_at, param_count,
                                       probs_at)
from mergenet_tpu_torch.models.resnet import STAGE_BLOCKS
from mergenet_tpu_torch.parallel import Mesh
from mergenet_tpu_torch.parallel import train as TT
from mergenet_tpu_torch.utils import logging as tlog
from mergenet_tpu_torch.utils import train_utils as TU
from mergenet_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_helpers import FIX512, SPIRAL_OFFSETS

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small CPU steps: the suite runs
    several workers on the same cores, where torch's thread pool thrashes
    (a unet_small step took 22 s under six workers, 0.1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C, O = 3, 2  # unet_small's heads in these tests
ALPHA = 2.0


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _leaves(t):
    return dict(jax.tree_util.tree_flatten_with_path(t)[0])


def _assert_trees_close(got, ref, atol):
    g, r = _leaves(got), _leaves(ref)
    assert g.keys() == r.keys()
    for k in r:
        np.testing.assert_allclose(g[k], np.asarray(r[k]), atol=atol,
                                   rtol=0, err_msg=jax.tree_util.keystr(k))


def _batches(seed, n, hw=32, b=2):
    rng = np.random.default_rng(seed)
    imgs = rng.random((n, b, hw, hw, 3)).astype(np.float32)
    tgs = (rng.random((n, b, hw, hw, C + O)) < 0.5).astype(np.float32)
    return list(zip(imgs, tgs))


def _jinit(jm, hw, seed):
    """Flax variables of `jm` for (1, hw, hw, 3) inputs, as float32 numpy
    (params, batch_stats); one jitted init."""
    v = jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                  jnp.zeros((1, hw, hw, 3)), train=False))(
        jax.random.PRNGKey(seed))
    return _np_tree(v["params"]), _np_tree(v["batch_stats"])


def _jax_state(jm, params, batch_stats, tx=None):
    tx = tx or JT.make_optimizer(lr=0.01)
    return JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=batch_stats, opt_state=tx.init(params),
                         tx=tx, apply_fn=jm.apply)


def _port_state(model, params, batch_stats, tx=None):
    """The port's train state holding the Flax variables (what
    `create_train_state` builds, without drawing an init first)."""
    tx = tx or TT.make_optimizer(lr=0.01)
    model = load_flax_weights(model, params, batch_stats)
    return TT.TrainState(step=0, model=model,
                         optimizer=tx.init(model.parameters()), tx=tx)


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("up_mode,merge_mode", [
    ("transpose", "concat"), ("transpose", "add"), ("upsample", "concat"),
    ("upsample", "add")])
def test_unet_modes_match_flax(up_mode, merge_mode):
    """Train-mode forward (batch statistics, running update), then the
    eval-mode forward with the updated statistics; the invalid pair
    raises in both."""
    kw = dict(depth=3, start_filts=4, up_mode=up_mode, merge_mode=merge_mode)
    x = np.random.default_rng(0).random((2, 16, 16, 3)).astype(np.float32)
    if up_mode == "upsample" and merge_mode == "add":
        with pytest.raises(ValueError):
            JUNet(C, O, **kw).init(jax.random.PRNGKey(0), x)
        with pytest.raises(ValueError):
            UNet(C, O, **kw)
        return
    jm = JUNet(C, O, **kw)
    p, b = _jinit(jm, 16, 1)
    out, upd = jm.apply({"params": p, "batch_stats": b}, x, train=True,
                        mutable=["batch_stats"])
    tm = load_flax_weights(UNet(C, O, **kw), p, b).train()
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(out), atol=1e-5, rtol=1e-4)
    _assert_trees_close(state_dict_to_flax(tm)[1], upd["batch_stats"], 1e-6)
    ref = jm.apply({"params": p, "batch_stats": upd["batch_stats"]}, x,
                   train=False)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_get_model_unet_matches_flax_structure():
    """`unet` (depth 5, 64 filters): every Flax variable maps onto the
    port's state dict with its shape, and the parameter counts agree
    (shapes only: `jax.eval_shape`)."""
    jm = jget_model(9, 10, "unet")
    v = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3)),
                                         train=False), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                   v)
    tm = get_model(9, 10, "unet")
    sd = flax_to_state_dict(zeros["params"], zeros["batch_stats"])
    assert sd.keys() == tm.state_dict().keys()
    for k, t in tm.state_dict().items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
    assert param_count(tm) == jparam_count(zeros["params"])


def test_get_model_unet_small_matches_flax():
    x = np.random.default_rng(2).random((1, 32, 32, 3)).astype(np.float32)
    jm = jget_model(9, 10, "unet_small")
    p, b = _jinit(jm, 32, 3)
    tm = load_flax_weights(get_model(9, 10, "unet_small"), p, b)
    assert param_count(tm) == jparam_count(p)
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": p, "batch_stats": b}, x)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_get_model_names():
    """Every arch name builds the class, the depth and the outputs of
    JAX's `get_model` (built on the meta device: no memory, no init)."""
    assert isinstance(get_model(9, 10, "pspfpnet"), PSPFPNet)
    assert get_model(9, 10, "pspfpnet").num_outputs == 19
    for arch in VALID_ARCHS:
        ref = jget_model(9, 10, arch, verbose=False)
        with torch.device("meta"):
            got = get_model(9, 10, arch)
        assert type(got).__name__ == type(ref).__name__, arch
        outs = (got.Conv_0.out_channels if isinstance(got, UNet)
                else got.num_outputs)
        assert outs == getattr(ref, "num_outputs", 19) == 19, arch
        for field in ("scale", "depth"):
            if hasattr(ref, field):
                assert getattr(got, field) == getattr(ref, field), (
                    arch, field)
        if hasattr(ref, "layer"):
            blocks = [n for n, _ in got.ResNetBackbone_0.named_children()
                      if n.startswith(("BasicBlock_", "Bottleneck_"))]
            assert len(blocks) == sum(STAGE_BLOCKS[ref.layer]), arch
    with pytest.raises(ValueError):
        get_model(9, 10, "resnet50")


def test_unet_logits_at_is_none_and_probs_at_resizes():
    """A model without `output_size`: no logits path; probabilities at
    half size through the antialiased resize, as the reference's."""
    jm = jget_model(C, O, "unet_small")
    p, b = _jinit(jm, 32, 4)
    x = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    tm = load_flax_weights(get_model(C, O, "unet_small"), p, b)
    assert logits_at(tm, torch.from_numpy(x), (16, 16)) is None
    ref = jprobs_at(jm, {"params": p, "batch_stats": b}, x, (16, 16))
    got = probs_at(tm.train(), torch.from_numpy(x), (16, 16))
    assert not tm.training  # probs_at runs the model in eval mode
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_convert_round_trip():
    """flax -> port -> flax gives the trees back: UNet's transposed
    convs, and the committed PSPFPNet-r50 checkpoint."""
    jm = JUNet(C, O, depth=3, start_filts=4)
    p, b = _jinit(jm, 16, 6)
    for (params, stats), model in (
            ((p, b), UNet(C, O, depth=3, start_filts=4)),
            (_np_tree(TIO.load_bench_checkpoint(
                os.path.join(FIX512, "bench_ckpt.npz"))), PSPFPNet(19))):
        back = state_dict_to_flax(load_flax_weights(model, params, stats))
        for got, ref in zip(back, (params, stats)):
            g, r = _leaves(got), _leaves(ref)
            assert g.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])
    sd = flax_to_state_dict(p, b)
    k = p["UpConv_0"]["ConvTranspose_0"]["kernel"]  # (kh, kw, in, out)
    np.testing.assert_array_equal(sd["UpConv_0.ConvTranspose_0.weight"],
                                  k[::-1, ::-1].transpose(2, 3, 0, 1))


# ----------------------------------------------------------- unet steps

@pytest.fixture(scope="module")
def unet_ref():
    """The JAX reference: unet_small's Flax variables, 3 steps of
    `build_train_step` in float32 and bf16, and the eval step (one
    compile each); the step functions are shared by the loop tests."""
    out = {"batches": _batches(7, 3), "steps": {}}
    for bf16 in (False, True):
        jm = jget_model(C, O, "unet_small",
                        dtype=jnp.bfloat16 if bf16 else None)
        if not bf16:
            out["init"] = _jinit(jm, 32, 8)
            out["jm"] = jm
        state = _jax_state(jm, *out["init"])
        step = JT.build_train_step(C, O, alpha=ALPHA, donate=False)
        out["steps"][bf16] = step
        losses = []
        for k, (img, tg) in enumerate(out["batches"]):
            state, m = step(state, img, tg, jax.random.PRNGKey(k))
            losses.append(float(m["loss"]))
        out[bf16] = (losses, _np_tree(state.params),
                     _np_tree(state.batch_stats))
    out["eval"] = JT.build_eval_step(C, O, alpha=ALPHA)
    return out


def _port_unet_run(ref, bf16, remat):
    model = get_model(C, O, "unet_small",
                      dtype=torch.bfloat16 if bf16 else None)
    state = _port_state(model, *ref["init"])
    step = TT.build_train_step(C, O, alpha=ALPHA, remat=remat)
    losses = []
    for img, tg in ref["batches"]:
        state, m = step(state, img, tg)
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("bf16", [False, True])
def test_unet_small_trajectory_matches_jax(unet_ref, bf16):
    losses, state = _port_unet_run(unet_ref, bf16, remat=False)
    ref_losses, ref_p, ref_b = unet_ref[bf16]
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-2 if bf16
                               else 1e-4)
    assert state.step == 3
    params, stats = state_dict_to_flax(state.model)
    _assert_trees_close(params, ref_p, 5e-3 if bf16 else 1e-5)
    _assert_trees_close(stats, ref_b, 5e-3 if bf16 else 1e-5)


@pytest.mark.parametrize("bf16", [False, True])
def test_remat_changes_nothing(unet_ref, bf16):
    """`remat=True` (each block through torch.utils.checkpoint, the
    batch-norm statistics counted once) gives the same losses,
    parameters and statistics, bit for bit."""
    la, sa = _port_unet_run(unet_ref, bf16, remat=False)
    lb, sb = _port_unet_run(unet_ref, bf16, remat=True)
    assert la == lb
    a, b = sa.model.state_dict(), sb.model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert all(m.update_stats for m in sb.model.modules()
               if hasattr(m, "update_stats"))


def test_eval_step_per_sample_vectors_match_jax(unet_ref):
    p, b = unet_ref["init"]
    rng = np.random.default_rng(9)
    img = rng.random((3, 32, 32, 3)).astype(np.float32)
    tg = (rng.random((3, 32, 32, C + O)) < 0.5).astype(np.float32)
    jstate = _jax_state(unet_ref["jm"], p, b)
    probs_j, m_j = unet_ref["eval"](jstate, img, tg)
    state = _port_state(get_model(C, O, "unet_small"), p, b)
    probs_t, m_t = TT.build_eval_step(C, O, alpha=ALPHA)(state, img, tg)
    assert not state.model.training
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               atol=1e-5)
    for key in ("loss", "cls_loss", "ofs_loss", "per_sample_loss",
                "per_sample_cls", "per_sample_ofs"):
        assert m_t[key].shape == m_j[key].shape, key
        np.testing.assert_allclose(m_t[key].numpy(), np.asarray(m_j[key]),
                                   rtol=1e-5, err_msg=key)


# ------------------------------------------------------------ the loops

def test_train_and_validate_loops_match_jax(unet_ref, capsys):
    """`train` with score=True (the eval step on each batch), then
    `validate` over batches of 2 and 3 rows with pad_to=2 (the 3-row
    batch padded to 4, its duplicate row not counted), scored and
    unscored: the same parameters, iterations and selection signal."""
    p, b = unet_ref["init"]
    batches = unet_ref["batches"][:2]
    jstate = _jax_state(unet_ref["jm"], p, b)
    kw = dict(num_classes=C, offset_list=list(SPIRAL_OFFSETS[:O]),
              score=True)
    jstate, jit = JU.train(batches, jstate, unet_ref["steps"][False], 2, 0,
                           5, eval_step=unet_ref["eval"], **kw)
    state = _port_state(get_model(C, O, "unet_small"), p, b)
    state, it = TU.train(batches, state, TT.build_train_step(
        C, O, alpha=ALPHA), 2, 0, 5,
        eval_step=TT.build_eval_step(C, O, alpha=ALPHA), **kw)
    assert it == jit == 7
    params, stats = state_dict_to_flax(state.model)
    _assert_trees_close(params, jstate.params, 1e-5)
    _assert_trees_close(stats, jstate.batch_stats, 1e-5)

    rng = np.random.default_rng(10)
    val = [(rng.random((n, 32, 32, 3)).astype(np.float32),
            (rng.random((n, 32, 32, C + O)) < 0.5).astype(np.float32))
           for n in (2, 3)]
    for score in (True, False):
        ref = JU.validate(val, jstate, unet_ref["eval"], 2, 0, 7,
                          pad_to=2, **dict(kw, score=score))
        got = TU.validate(val, state, TT.build_eval_step(C, O, alpha=ALPHA),
                          2, 0, 7, pad_to=2, **dict(kw, score=score))
        np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert "mean IoU" in capsys.readouterr().out


def test_train_compact_loop_matches_jax(unet_ref):
    """`train_compact` over compact batches (uint8 images, instance masks,
    class tables) with `build_train_step_compact` on both sides."""
    p, b = unet_ref["init"]
    rng = np.random.default_rng(11)
    offsets = SPIRAL_OFFSETS[:O]
    batches = []
    for _ in range(2):
        m = rng.integers(0, 5, (2, 8, 8))
        batches.append({
            "image": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
            "mask": np.repeat(np.repeat(m, 4, 1), 4, 2).astype(np.int32),
            "object_class": np.concatenate(
                [np.zeros((2, 1)), rng.integers(0, C, (2, 15))], 1
            ).astype(np.int32)})
    jstate = _jax_state(unet_ref["jm"], p, b)
    jstate, jit = JU.train_compact(
        batches, jstate, JT.build_train_step_compact(C, offsets, alpha=ALPHA,
                                                     donate=False), 2, 0, 0)
    state = _port_state(get_model(C, O, "unet_small"), p, b)
    state, it = TU.train_compact(
        batches, state, TT.build_train_step_compact(C, offsets, alpha=ALPHA),
        2, 0, 0)
    assert it == jit == 2
    params, stats = state_dict_to_flax(state.model)
    _assert_trees_close(params, jstate.params, 1e-5)
    _assert_trees_close(stats, jstate.batch_stats, 1e-5)


def test_checkpoint_resume_equals_an_uninterrupted_run(unet_ref, tmp_path):
    """save_checkpoint -> load_checkpoint (from the experiment dir and
    from model_best) -> one more step: bit-equal to the run that never
    stopped, with the offsets and epoch in the metadata; a checkpoint
    whose optimizer state does not fit keeps the fresh optimizer."""
    p, b = unet_ref["init"]
    tx = TT.make_optimizer(lr=0.01, milestones=[1], steps_per_epoch=2)
    step = TT.build_train_step(C, O, alpha=ALPHA)
    (i0, t0), (i1, t1), (i2, t2) = unet_ref["batches"]
    state = _port_state(get_model(C, O, "unet_small"), p, b, tx)
    for img, tg in ((i0, t0), (i1, t1)):
        state, _ = step(state, img, tg)
    TU.save_checkpoint(str(tmp_path), state, True, epoch=1, best_iou=0.5,
                       offsets=SPIRAL_OFFSETS[:O])
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    evaluate = TT.build_eval_step(C, O, alpha=ALPHA)
    probs_saved, _ = evaluate(state, i2, t2)
    state, m_run = step(state, i2, t2)  # the uninterrupted run

    for where in (str(tmp_path), str(tmp_path / "model_best")):
        fresh = TT.create_train_state(get_model(C, O, "unet_small"), tx,
                                      seed=1, device="cpu")
        fresh, meta = load_checkpoint(where, fresh)
        assert meta == {"epoch": 1, "best_iou": 0.5,
                        "offsets": list(SPIRAL_OFFSETS[:O])}
        assert fresh.step == 2
        probs, _ = evaluate(fresh, i2, t2)
        assert torch.equal(probs, probs_saved)
        fresh, m = step(fresh, i2, t2)
        assert float(m["loss"]) == float(m_run["loss"])
        for k, v in state.model.state_dict().items():
            assert torch.equal(fresh.model.state_dict()[k], v), k

    other = TT.create_train_state(get_model(C, O, "unet_small"), tx,
                                  device="cpu")
    params = list(other.model.parameters())
    other.optimizer = torch.optim.SGD([{"params": params[:3]},
                                       {"params": params[3:]}], lr=0.01,
                                      momentum=0.9, nesterov=True)
    other, _ = load_checkpoint(str(tmp_path), other)
    assert not other.optimizer.state  # fresh: no momentum buffers
    for k, v in saved.items():
        assert torch.equal(other.model.state_dict()[k], v), k


def test_sample_pngs_and_scalar_log(unet_ref, tmp_path, monkeypatch):
    import cv2
    p, b = unet_ref["init"]
    state = _port_state(get_model(C, O, "unet_small"), p, b)
    evaluate = TT.build_eval_step(C, O, alpha=ALPHA)
    img, tg = unet_ref["batches"][0]
    TU.sample(state, evaluate, [(img, tg)], str(tmp_path), C, O)
    probs, _ = evaluate(state, img, tg)
    for name, plane in (("class_1.png", tg[0, :, :, 1]),
                        ("bound_0pred.png", probs[0, :, :, C].numpy())):
        got = cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            got, (np.clip(plane, 0, 1) * 255).astype(np.uint8))
    raw = TIO.read_png_rgb(str(tmp_path / "raw.png"))
    np.testing.assert_array_equal(raw, (img[0] * 255).astype(np.uint8))

    # the JSONL fallback, as on a machine without the tensorboard package
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tlog.configure(str(tmp_path / "log"))
    try:
        tlog.log_value("val_iou", 0.25, 3)
    finally:
        tlog._logdir = None
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        rec = json.loads(f.readline())
    assert (rec["name"], rec["value"], rec["step"]) == ("val_iou", 0.25, 3)


def test_entry_points_need_the_card_and_refuse_unported_options():
    """No fallback: the default device is CUDA, which this machine lacks.
    The steps take the port's `Mesh` only (a JAX mesh or any other
    object is a TypeError), of any shape whose axes multiply to its world
    (`test_torch_port_parallel.py` runs the data axis,
    `test_torch_port_spatial.py` the spatial and model axes); other
    shapes are a ValueError."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.create_train_state(get_model(C, O, "unet_small"),
                              TT.make_optimizer())
    with pytest.raises(TypeError, match="Mesh"):
        TT.build_train_step(C, O, mesh=object())
    spatial = Mesh({"data": 1, "spatial": 2, "model": 1}, 0, 2,
                   torch.device("cpu"))
    assert callable(TT.build_train_step_compact(C, SPIRAL_OFFSETS,
                                                mesh=spatial))
    with pytest.raises(ValueError, match="world"):
        TT.build_train_step_compact(C, SPIRAL_OFFSETS, mesh=Mesh(
            {"data": 1, "spatial": 2, "model": 1}, 0, 4,
            torch.device("cpu")))


# ------------------------------------------------ PSPFPNet compact step

PSP_C = 5


@pytest.fixture(scope="module")
def psp_step():
    """One compact step of PSPFPNet(layer=50, fpn_dim=32) at 64x64, batch
    2, alpha 20, in JAX (one compile) and in the port (float32 with and
    without remat, and float64), from the same Flax random init."""
    rng = np.random.default_rng(12)
    mask = np.repeat(np.repeat(rng.integers(0, 6, (2, 8, 8)), 8, 1), 8, 2)
    mask = mask.astype(np.int32)
    # images that follow their masks, as real ones do: two images of
    # noise alone pool to near-equal c5 averages, where the reference's
    # E[x^2] - E[x]^2 variance of the pyramid pooling's 1x1 branch (two
    # values per channel) loses every digit and its step moves ~100% away
    # from the float64 one (the port's stays within 4%)
    img = (mask[..., None] * np.array([40, 25, 10])
           + rng.integers(0, 40, (2, 64, 64, 3))).astype(np.uint8)
    oc = rng.integers(0, PSP_C, (2, 16)).astype(np.int32)
    oc[:, 0] = 0
    nout = PSP_C + len(SPIRAL_OFFSETS)
    jm = JPSPFPNet(nout, layer=50, fpn_dim=32)
    p0, b0 = _jinit(jm, 64, 13)
    jstate, m = JT.build_train_step_compact(
        PSP_C, SPIRAL_OFFSETS, alpha=20.0, donate=False)(
            _jax_state(jm, p0, b0, JT.make_optimizer()), img, mask, oc,
            jax.random.PRNGKey(0))
    out = {"init": (p0, b0), "jax": (float(m["loss"]),
                                     _np_tree(jstate.params),
                                     _np_tree(jstate.batch_stats))}
    for dt, remat in ((torch.float32, False), (torch.float32, True),
                      (torch.float64, False)):
        model = PSPFPNet(nout, fpn_dim=32,
                         dtype=None if dt == torch.float32 else dt)
        state = _port_state(model.to(dt), p0, b0, TT.make_optimizer())
        state, tm = TT.build_train_step_compact(
            PSP_C, SPIRAL_OFFSETS, alpha=20.0, remat=remat)(
                state, img, mask, oc)
        out[dt, remat] = (float(tm["loss"]), state.model.state_dict())
        if not remat:
            out[dt] = (float(tm["loss"]),) + state_dict_to_flax(state.model)
    return out


def _update_errors(got, ref, init):
    """Per leaf: |(got - init) - (ref - init)| / |ref - init| in L2."""
    g, r, i = _leaves(got), _leaves(ref), _leaves(init)
    errs = {}
    for k in r:
        du = np.asarray(r[k], np.float64) - i[k]
        if np.abs(du).max() < 1e-6:  # exact-zero gradient (bias before BN)
            continue
        errs[jax.tree_util.keystr(k)] = (
            np.linalg.norm(np.asarray(g[k], np.float64) - i[k] - du)
            / np.linalg.norm(du))
    return errs


def test_pspfpnet_compact_step_matches_jax(psp_step):
    loss_j, p_j, b_j = psp_step["jax"]
    loss_t, p_t, b_t = psp_step[torch.float32]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-4)
    _assert_trees_close(b_t, b_j, 1e-3)
    errs = _update_errors(p_t, p_j, psp_step["init"][0])
    assert len(errs) > 150
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.25, (worst, errs[worst])


def test_pspfpnet_compact_step_float32_against_float64(psp_step):
    """The port's float32 step against its own float64 step: the spread
    the JAX comparison allows is float32 conditioning."""
    _, p32, b32 = psp_step[torch.float32]
    loss64, p64, b64 = psp_step[torch.float64]
    np.testing.assert_allclose(psp_step[torch.float32][0], loss64,
                               rtol=1e-5)
    _assert_trees_close(b32, b64, 1e-3)  # 1.2e-4 seen, one thread
    errs = _update_errors(p32, p64, psp_step["init"][0])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.15, (worst, errs[worst])


def test_remat_changes_nothing_on_pspfpnet(psp_step):
    """`remat=True` on PSPFPNet (each Bottleneck, the pyramid pooling and
    the FPN head checkpointed): the same compact step, bit for bit."""
    (la, a), (lb, b) = (psp_step[torch.float32, r] for r in (False, True))
    assert la == lb
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_init_model_matches_flax_initialisers(psp_step):
    """flax's lecun-normal kernels (truncated normal, variance 1/fan_in),
    zero biases, batch norm at scale 1, bias 0, mean 0, var 1: kernel
    standard deviations within 10% of flax's for every kernel of 1000
    entries or more (sampling noise ~2%)."""
    model = init_model(PSPFPNet(PSP_C + len(SPIRAL_OFFSETS), fpn_dim=32),
                       seed=5)
    params, stats = state_dict_to_flax(model)
    ref_p, ref_b = psp_step["init"]
    g, r = _leaves(params), _leaves(ref_p)
    assert g.keys() == r.keys()
    checked = 0
    for k in r:
        name = jax.tree_util.keystr(k)
        if name.endswith("['kernel']") and r[k].size >= 1000:
            ratio = g[k].std() / r[k].std()
            assert abs(ratio - 1) < 0.1, (name, ratio)
            assert np.abs(g[k]).max() <= 2 * np.sqrt(
                1 / np.prod(g[k].shape[:-1])) / 0.8796256610342398 + 1e-6
            checked += 1
        elif not name.endswith("['kernel']"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=name)
    assert checked > 50
    for k, v in _leaves(ref_b).items():
        np.testing.assert_array_equal(_leaves(stats)[k], v)
    # and UNet's transposed convs: fan_in = in * kh * kw
    up = init_model(UNet(C, O), seed=6).UpConv_0.ConvTranspose_0.weight
    assert abs(float(up.detach().std()) / np.sqrt(1 / (1024 * 4)) - 1) < 0.1
