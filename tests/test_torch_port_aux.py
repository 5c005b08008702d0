"""PSPNet's aux head in the port's train steps against the JAX package
on the CPU: one compact step of PSPNet(layer=18) at 64x64, batch 2,
alpha 20, `aux_weight=0.4`, from the same Flax variables.

Both sides drop the same units: the JAX step's masks are read back from
its own forward (`capture_intermediates`: a dropout output is non-zero
where the unit was kept, and where it is zero the unit's input was
zero, so its gradient is zero either way) and the port's two dropouts
are given them.  Tolerances, as the PSPFPNet step's
(`test_torch_port_train.py`) where measured spreads allow: loss and
aux loss rtol 1e-4 (measured 1.7e-6 and 2.3e-7; the port's own masks
instead of JAX's move the loss by 2e-3); running statistics atol 1e-3
(measured 2.0e-5); each parameter's update within 0.05 of JAX's in
relative L2 norm (measured 0.0091 at most; the ResNet-50 step's 0.25
allows for its worse conditioned train-mode batch norm).

The port's own steps: `remat=True` gives the same step bit for bit,
also where a checkpointed block holds a dropout (torch's checkpoint
restores its global generators, not the step's: the step replays its
own; without that the recomputation draws other masks, which the test
shows); a model with dropout refuses a train step without a
generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models.pspnet import PSPNet as JPSPNet
from mergenet_tpu.parallel import train as JT
from mergenet_tpu_torch.convert import load_flax_weights, state_dict_to_flax
from mergenet_tpu_torch.models import PSPNet, init_model
from mergenet_tpu_torch.models.layers import Dropout
from mergenet_tpu_torch.parallel import train as TT
from torch_port_helpers import SPIRAL_OFFSETS

C = 5
NOUT = C + len(SPIRAL_OFFSETS)
ALPHA, AUX = 20.0, 0.4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(21)
    mask = np.repeat(np.repeat(rng.integers(0, 6, (2, 8, 8)), 8, 1), 8, 2)
    mask = mask.astype(np.int32)
    # images that follow their masks, as real ones do
    img = (mask[..., None] * np.array([40, 25, 10])
           + rng.integers(0, 40, (2, 64, 64, 3))).astype(np.uint8)
    oc = rng.integers(0, C, (2, 16)).astype(np.int32)
    oc[:, 0] = 0
    init = state_dict_to_flax(init_model(PSPNet(NOUT, layer=18), 22))
    return img, mask, oc, init


def _leaves(t):
    return dict(jax.tree_util.tree_flatten_with_path(t)[0])


def _port_state(init, **kw):
    tx = TT.make_optimizer()
    model = load_flax_weights(PSPNet(NOUT, layer=18, **kw), *init)
    return TT.TrainState(step=0, model=model,
                         optimizer=tx.init(model.parameters()), tx=tx)


@pytest.fixture(scope="module")
def jax_step(batch):
    """JAX's compact step, its dropouts' outputs and their inputs' batch
    norms read back from inside the step (`capture_intermediates` and a
    host callback in the step's own forward: one compile)."""
    img, mask, oc, (p, b) = batch
    jm = JPSPNet(NOUT, layer=18)
    captured = {}

    def keep(*planes):
        captured["planes"] = [np.asarray(a) for a in planes]

    def apply_capturing(variables, x, mutable, **kw):
        out, upd = jm.apply(variables, x, capture_intermediates=True,
                            mutable=list(mutable) + ["intermediates"], **kw)
        got = upd["intermediates"]
        jax.debug.callback(keep, *(got[n]["__call__"][0] for n in (
            "Dropout_0", "Dropout_1", "SyncBatchNorm_0", "SyncBatchNorm_1")))
        return out, {"batch_stats": upd["batch_stats"]}

    tx = JT.make_optimizer()
    jstate = JT.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                           batch_stats=b, opt_state=tx.init(p), tx=tx,
                           apply_fn=apply_capturing)
    new, m = JT.build_train_step_compact(
        C, SPIRAL_OFFSETS, alpha=ALPHA, aux_weight=AUX, donate=False)(
            jstate, img, mask, oc, jax.random.PRNGKey(3))
    jax.effects_barrier()  # the callback has run
    drop0, drop1, bn0, bn1 = captured["planes"]
    return {"loss": float(m["loss"]), "aux_loss": float(m["aux_loss"]),
            "params": jax.tree_util.tree_map(np.asarray, new.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  new.batch_stats),
            "masks": [drop0 != 0, drop1 != 0],
            # the dropouts' inputs are relu of these batch norms
            "live": [bn0 > 0, bn1 > 0]}


def test_pspnet_aux_step_matches_jax(batch, jax_step):
    img, mask, oc, init = batch
    state = _port_state(init)
    kept = [jax_step["masks"][i] for i in (0, 1)]
    for k, live in zip(kept, jax_step["live"]):  # rate 0.1
        assert not (k & ~live).any() and 0.85 < k[live].mean() < 0.95
    for i, k in enumerate(kept):  # NHWC masks onto the NCHW dropouts
        drop = getattr(state.model, "Dropout_%d" % i)
        drop.mask = lambda x, k=k: torch.from_numpy(k).permute(0, 3, 1, 2)
    state, m = TT.build_train_step_compact(
        C, SPIRAL_OFFSETS, alpha=ALPHA, aux_weight=AUX)(
            state, img, mask, oc, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m["loss"]), jax_step["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["aux_loss"]), jax_step["aux_loss"],
                               rtol=1e-4)
    assert float(m["aux_loss"]) > 0
    params, stats = state_dict_to_flax(state.model)
    got_b, ref_b = _leaves(stats), _leaves(jax_step["batch_stats"])
    assert got_b.keys() == ref_b.keys()
    for k in ref_b:
        np.testing.assert_allclose(got_b[k], ref_b[k], atol=1e-3, rtol=0)
    g, r, i0 = (_leaves(t) for t in (params, jax_step["params"], init[0]))
    assert g.keys() == r.keys()
    errs = {}
    for k in r:
        du = np.asarray(r[k], np.float64) - i0[k]
        if np.abs(du).max() < 1e-6:  # exact-zero gradient
            continue
        errs[jax.tree_util.keystr(k)] = (
            np.linalg.norm(np.asarray(g[k], np.float64) - i0[k] - du)
            / np.linalg.norm(du))
    assert "['Conv_3']['kernel']" in errs  # the aux classifier moved
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.05, (worst, errs[worst])


def _port_step(batch, remat, seed=5, replay=True, monkeypatch=None):
    img, mask, oc, init = batch
    state = _port_state(init)
    if not replay:
        monkeypatch.setattr(TT, "_replay", lambda rng: (
            torch.enable_grad(), torch.enable_grad()))
    state, m = TT.build_train_step_compact(
        C, SPIRAL_OFFSETS, alpha=ALPHA, aux_weight=AUX, remat=remat)(
            state, img, mask, oc, torch.Generator().manual_seed(seed))
    return float(m["loss"]), state.model.state_dict()


def _same(a, b):
    return a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])


def test_remat_changes_nothing_on_the_aux_step(batch):
    assert _same(_port_step(batch, False), _port_step(batch, True))


def test_remat_replays_the_dropout_generator(batch, monkeypatch):
    """With the dropouts themselves checkpointed, the recomputation must
    draw the forward's masks: the same step bit for bit; with the
    replay switched off it draws others and the step differs."""
    monkeypatch.setattr(TT, "REMAT_BLOCKS", TT.REMAT_BLOCKS + (Dropout,))
    plain = _port_step(batch, False)
    assert _same(plain, _port_step(batch, True))
    assert not _same(plain, _port_step(batch, True, replay=False,
                                       monkeypatch=monkeypatch))


def test_dropout_needs_a_generator_in_train_mode_only(batch):
    img, mask, oc, init = batch
    step = TT.build_train_step_compact(C, SPIRAL_OFFSETS, alpha=ALPHA,
                                       aux_weight=AUX)
    with pytest.raises(RuntimeError, match="torch.Generator"):
        step(_port_state(init), img, mask, oc)
    state = _port_state(init)
    x = torch.from_numpy(img[:1].astype(np.float32) / 256)
    with torch.no_grad():
        assert torch.equal(state.model.eval()(x), state.model.eval()(x))
    assert all(m.generator is None for m in state.model.modules()
               if isinstance(m, Dropout))
