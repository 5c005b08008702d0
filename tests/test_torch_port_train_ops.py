"""The training ops of the PyTorch port against the JAX package on the
CPU: targets (`ops/targets.py`), losses (`ops/losses.py`), metrics
(`ops/metrics.py`), the optimizer's lr schedule and update
(`parallel/train.py`), and batch norm in train mode
(`models/layers.py`, `models/pspnet.py::PyramidPoolingModule`).

Tolerances: targets and metrics equal (the same integer and float64
arithmetic); losses and their gradients float32 rtol 1e-5; the SGD
trajectory rtol 1e-6 (one-ulp differences of fused multiply-adds); batch
norm outputs atol 1e-5 in float32 (after normalisation to unit
variance) and one bf16 ulp of the output's magnitude in bf16 (rtol
2**-7; the pyramid pooling's branches atol 2**-4 besides: one bf16 ulp
of a branch conv's output, amplified by normalising over the 4 values
of the pool-2 branch), running statistics atol 1e-6 (of bf16 branch
convs' outputs atol 1e-3, rtol 2**-7: a tenth of a bf16 ulp of them)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mergenet_tpu.models import layers as JL
from mergenet_tpu.models import pspnet as JP
from mergenet_tpu.ops import losses as JLo
from mergenet_tpu.ops import metrics as JM
from mergenet_tpu.ops import targets as JT
from mergenet_tpu.parallel import train as JTr
from mergenet_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from mergenet_tpu_torch.models import layers as TL
from mergenet_tpu_torch.models import pspnet as TP
from mergenet_tpu_torch.ops import losses as TLo
from mergenet_tpu_torch.ops import metrics as TM
from mergenet_tpu_torch.ops import targets as TT
from mergenet_tpu_torch.parallel import train as TTr
from torch_port_helpers import FIXTURE_OFFSETS, SPIRAL_OFFSETS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's small CPU steps: the suite runs
    several workers on the same cores, where torch's thread pool thrashes
    (a unet_small step took 22 s under six workers, 0.1 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(seed, n=3, h=40, w=52, k=7):
    """Blocky random instance masks (ids < k) and class tables."""
    rng = np.random.default_rng(seed)
    m = rng.integers(0, k, (n, h // 4 + 1, w // 4 + 1))
    m = np.repeat(np.repeat(m, 4, 1), 4, 2)[:, :h, :w].astype(np.int32)
    oc = rng.integers(0, 5, (n, k)).astype(np.int32)
    oc[:, 0] = 0
    return m, oc


@pytest.mark.parametrize("num_classes,offsets", [
    (5, SPIRAL_OFFSETS),      # reaches -21 rows
    (0, SPIRAL_OFFSETS),      # offsets-only
    (5, ()),                  # class-only
    (3, FIXTURE_OFFSETS),     # offsets past the 40x52 grid (-80, 48)
])
def test_mask_to_target_bit_equal(num_classes, offsets):
    mask, oc = _masks(num_classes + len(offsets))
    ref = np.asarray(JT.mask_to_target_batch(jnp.asarray(mask),
                                             jnp.asarray(oc), num_classes,
                                             tuple(offsets)))
    got = TT.mask_to_target(torch.from_numpy(mask), torch.from_numpy(oc),
                            num_classes, offsets).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    for i in range(len(mask)):
        np.testing.assert_array_equal(
            TT.mask_to_target_np(mask[i], oc[i], num_classes, offsets),
            got[i])


def _logits_targets(seed, shape=(2, 12, 16, 7)):
    """Logits with exact zeros (where a 1x1 head over all-zero ReLU
    features lands) and binary targets."""
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal(shape) * 3).astype(np.float32)
    lg[rng.random(shape) < 0.05] = 0.0
    tg = (rng.random(shape) < 0.4).astype(np.float32)
    return lg, tg


LOSSES = ["bce", "wbce", "mbce", "dice", "ce"]


@pytest.mark.parametrize("name", LOSSES + ["fused"])
def test_loss_matches_reference(name):
    lg, tg = _logits_targets(1)
    if name == "fused":
        ref, (rc, ro) = JLo.fused_class_offset_loss(lg, tg, 3, alpha=20.0)
        got, (gc, go) = TLo.fused_class_offset_loss(
            torch.from_numpy(lg), torch.from_numpy(tg), 3, alpha=20.0)
        np.testing.assert_allclose([float(gc), float(go)],
                                   [float(rc), float(ro)], rtol=1e-5)
    elif name == "wbce":
        ref = JLo.weighted_bce_with_logits_loss(lg, tg, alpha=0.3)
        got = TLo.weighted_bce_with_logits_loss(
            torch.from_numpy(lg), torch.from_numpy(tg), alpha=0.3)
    else:
        ref = JLo.get_loss_fn(name)(lg, tg)
        got = TLo.get_loss_fn(name)(torch.from_numpy(lg),
                                    torch.from_numpy(tg))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("name", ["bce", "mbce"])
def test_loss_gradient_matches_jax_grad(name):
    """d loss / d logits, exact zeros included: there JAX's gradient is
    -t (its max splits, its abs has slope 1), which the port keeps."""
    lg, tg = _logits_targets(2)
    ref = np.asarray(jax.grad(JLo.get_loss_fn(name))(jnp.asarray(lg),
                                                     jnp.asarray(tg)))
    x = torch.from_numpy(lg).requires_grad_()
    TLo.get_loss_fn(name)(x, torch.from_numpy(tg)).backward()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * scale)
    zeros = lg == 0
    assert zeros.any()
    if name == "bce":  # -t / n at the zeros
        np.testing.assert_allclose(x.grad.numpy()[zeros],
                                   -tg[zeros] / lg.size, rtol=1e-6)


def test_get_loss_fn_rejects_unknown_names():
    with pytest.raises(ValueError):
        TLo.get_loss_fn("focal")


def test_running_score_and_offset_iou_equal_reference():
    rng = np.random.default_rng(3)
    offsets = list(SPIRAL_OFFSETS[:4])
    rs_j, rs_t = JM.runningScore(5), TM.runningScore(5)
    oi_j, oi_t = JM.offsetIoU(offsets), TM.offsetIoU(offsets)
    for _ in range(3):
        probs = rng.random((2, 9, 11, 9)).astype(np.float32)
        tg = (rng.random((2, 9, 11, 9)) < 0.5).astype(np.float32)
        rs_j.update(probs, tg)
        rs_t.update(torch.from_numpy(probs), tg)
        oi_j.update(probs, tg)
        oi_t.update(torch.from_numpy(probs), tg)
    np.testing.assert_array_equal(rs_t.confusion_matrix,
                                  rs_j.confusion_matrix)
    (sj, cj), (st, ct) = rs_j.get_scores(), rs_t.get_scores()
    assert sj == st and cj.keys() == ct.keys()
    np.testing.assert_array_equal(list(ct.values()), list(cj.values()))
    ij, mj = oi_j.get_scores()
    it, mt = oi_t.get_scores()
    np.testing.assert_array_equal(it, ij)
    assert mt == mj


def test_lr_schedule_and_sgd_trajectory_equal_optax():
    """make_optimizer(milestones=[1, 3], steps_per_epoch=2) over 8
    updates: the lr of each update as optax reads its schedule (the
    update count, 0-based), and the parameters under a fixed gradient
    (decay, nesterov momentum, lr) as optax moves them."""
    kw = dict(lr=0.01, momentum=0.9, nesterov=True, weight_decay=1e-4,
              milestones=[1, 3], gamma=0.2, steps_per_epoch=2)
    jsched = JTr.multistep_lr(0.01, [1, 3], 0.2, 2)
    tx_t = TTr.make_optimizer(**kw)
    want = [float(jnp.float32(jsched(jnp.int32(k)))) for k in range(8)]
    assert [tx_t.schedule(k) for k in range(8)] == want
    assert want[0] == want[1] > want[2] == want[5] > want[6] == want[7]

    rng = np.random.default_rng(4)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = rng.standard_normal((8, 6)).astype(np.float32)
    tx_j = JTr.make_optimizer(**kw)
    pj, sj = jnp.asarray(p0), tx_j.init(jnp.asarray(p0))
    traj_j = []
    for g in grads:
        u, sj = tx_j.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, u)
        traj_j.append(np.asarray(pj))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    state = TTr.TrainState(step=0, model=torch.nn.Linear(1, 1),
                           optimizer=tx_t.init([w]), tx=tx_t)
    traj_t = []
    for g in grads:
        w.grad = torch.from_numpy(g.copy())
        state.apply_gradients()
        traj_t.append(w.detach().numpy().copy())
    assert state.step == 8
    np.testing.assert_allclose(traj_t, traj_j, rtol=1e-6, atol=1e-7)


def _bn_flax(x, dtype):
    """flax BatchNorm (through the reference's SyncBatchNorm) in train
    mode from random affine and running statistics: output and updated
    running statistics, plus the variables."""
    c = x.shape[-1]
    rng = np.random.default_rng(c)
    params = {"BatchNorm_0": {"scale": rng.uniform(0.5, 1.5, c).astype(
        np.float32), "bias": rng.standard_normal(c).astype(np.float32)}}
    stats = {"BatchNorm_0": {"mean": rng.standard_normal(c).astype(
        np.float32), "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    jm = JL.SyncBatchNorm(dtype=dtype)
    out, upd = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x, dtype or jnp.float32), train=True,
                        mutable=["batch_stats"])
    return np.asarray(out.astype(jnp.float32)), upd["batch_stats"], \
        params, stats


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 1, 6), (4, 5, 7, 6)])
def test_batch_norm_train_mode_matches_flax(shape, bf16):
    """(1, 1, 1, C): one value per channel (the pyramid pooling's 1x1
    branch at batch 1): output = bias, running var = 0.9 * var.
    (4, 5, 7, C): the biased batch variance in the running update, as
    flax (ddof=0; torch.nn.BatchNorm2d would use ddof=1).  Gradients
    against jax.grad in float32."""
    x = (np.random.default_rng(5).standard_normal(shape) * 2 + 1) \
        .astype(np.float32)
    ref, ref_stats, params, stats = _bn_flax(
        x, jnp.bfloat16 if bf16 else None)
    tm = TL.SyncBatchNorm(shape[-1]).train()
    tm.load_state_dict({k.split(".", 1)[1]: v for k, v in flax_to_state_dict(
        {"B": params}, {"B": stats}).items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if bf16:
        xt = xt.to(torch.bfloat16)
    got = tm(xt)
    assert got.dtype == xt.dtype
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    if bf16:
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-6)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(ref_stats["BatchNorm_0"][key]),
                                   atol=1e-6, rtol=1e-6)
    if shape[0] == 1:
        bias = torch.from_numpy(params["BatchNorm_0"]["bias"])
        np.testing.assert_array_equal(got[0, 0, 0],
                                      bias.to(xt.dtype).float().numpy())
        np.testing.assert_allclose(tm.running_var.numpy(),
                                   0.9 * stats["BatchNorm_0"]["var"],
                                   rtol=1e-6)
    if bf16:
        return
    w = np.random.default_rng(6).standard_normal(shape).astype(np.float32)

    def jloss(x, p):
        y, _ = JL.SyncBatchNorm().apply(
            {"params": p, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"])
        return jnp.sum(y * w)
    gx, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), params)
    xg = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    tm.weight.grad = tm.bias.grad = None
    (tm(xg) * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(xg.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(gp["BatchNorm_0"]["scale"]),
                               atol=1e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(),
                               np.asarray(gp["BatchNorm_0"]["bias"]),
                               atol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_pyramid_pooling_train_mode_at_batch_1(bf16):
    """The pyramid pooling module in train mode at batch 1: its pool-1
    branch has one value per channel; outputs and every branch's running
    statistics as flax's."""
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal((1, 6, 6, 16))).astype(np.float32)
    dt = jnp.bfloat16 if bf16 else None
    jm = JP.PyramidPoolingModule(dtype=dt)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    out, upd = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x, dt or jnp.float32), train=True,
                        mutable=["batch_stats"])
    tm = TP.PyramidPoolingModule(16)
    tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tm.train()(xt.to(torch.bfloat16) if bf16 else xt)
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    ref = np.asarray(out.astype(jnp.float32))
    if bf16:  # a bf16 ulp of a branch conv, normalised over 4 values
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -4)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5)
    _, got_stats = state_dict_to_flax(tm)
    for a, b in zip(jax.tree_util.tree_leaves(got_stats),
                    jax.tree_util.tree_leaves(upd["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3 if bf16
                                   else 1e-6, rtol=2 ** -7 if bf16 else 1e-5)
    # the pool-1 branch: one value per channel, relu(bias) out
    bias0 = params["SyncBatchNorm_0"]["BatchNorm_0"]["bias"]
    np.testing.assert_allclose(got[0, 0, 0, 16:20], np.maximum(bias0, 0),
                               rtol=2 ** -7 if bf16 else 0)
