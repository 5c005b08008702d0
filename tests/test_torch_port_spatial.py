"""The port's spatial mesh axis (`parallel/halo.py`, `parallel/mesh.py`,
the height-sharded layers) on 4 gloo ranks of the CPU against the JAX
package on a mesh of the same shape (`make_mesh(...,
devices=jax.devices()[:4])`) and against the port's one-process steps.

One module-scoped spawn (`torch_port_helpers.start_ranks`: a FileStore
rendezvous, no ports, one torch thread per rank) runs every port-side
case (`torch_port_spatial_ranks.py`), while JAX computes its side here.
Weights are the port's seeded init, through `convert.state_dict_to_flax`
for JAX and `convert.load_flax_weights` for the ranks.
- (a) UNet(3, 2, depth 2, 8 filters) on 2x32x32 at data=2 x spatial=2
  against JAX's `build_sharded_forward` on that mesh: rtol 2e-5, atol
  2e-6 (`tests/test_spatial.py`'s gate);
- (b) PSPFPNet(5, layer=50, fpn_dim=32) on 2x96x192 at data=1 x
  spatial=4: c4 (6 rows) and c5 (3 rows) do not divide over 4 ranks and
  run whole; rtol 2e-5, atol 2e-5 (that test's gate);
- (c) unet_small at batch 4 of 32x32 on data=2 x spatial=2: 3 steps of
  `build_train_step` and 1 of `build_train_step_compact` against JAX's
  steps on that mesh, at `tests/test_torch_port_parallel.py`'s
  tolerances (losses rtol 2e-5, parameters atol 1e-5, each update
  within 0.25 relative L2, batch-norm statistics 1e-5);
- (d) PSPNet(layer=18)'s compact aux step (aux_weight 0.4, remat, the
  dropout generator) on data=1 x spatial=2 x model=2 against the
  port's one-process step with the same generator, at
  `tests/test_torch_port_aux.py`'s tolerances (losses rtol 1e-4,
  statistics atol 1e-3, updates within 0.05 relative L2);
- (e) `validate(pad_to=2)` over a partial batch on data=2 x spatial=2
  against the one-process `validate`, and the eval step's
  probabilities and per-sample vectors, all after the 3 steps of (c)
  (atol 1e-5: the states agree within it);
- (f) serving on data=1 x spatial=2 x model=2 (the ranks that share a
  data index serve the same frames): masks, classes and overflow
  counts equal to one-process serving bit for bit; the sharded forward
  on that mesh against JAX's (the gate of (a));
- (g) the halo exchange: forward and gradients of convs (strided,
  dilated up to 8 rows, the 7x7 stride-2 stem, the 1x1 stride-2
  projection, an output that does not divide), max pooling (-inf fill)
  and the x2 upsample on a 4-way axis against the whole ops in float64
  (1e-12), `torch.autograd.gradcheck` (fast mode) of each sharded op as
  a function of the whole input, and the exchanged rows at zero and
  -inf fill;
- the rank layout against JAX's `reshape(data, spatial, model)`, and the
  meshes refused (a JAX mesh, axes that do not multiply to the world)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models.pspnet import PSPFPNet as JPSPFPNet
from mergenet_tpu.models.unet import UNet as JUNet
from mergenet_tpu.models import get_model as jget_model
from mergenet_tpu.parallel import make_mesh as jmake_mesh
from mergenet_tpu.parallel import train as JT
from mergenet_tpu.parallel.mesh import batch_sharding
from mergenet_tpu.parallel.spatial import build_sharded_forward as jfwd
from mergenet_tpu_torch.convert import (flax_to_state_dict,
                                        load_flax_weights,
                                        state_dict_to_flax)
from mergenet_tpu_torch.models import PSPFPNet, PSPNet, get_model, init_model
from mergenet_tpu_torch.models.unet import UNet
from mergenet_tpu_torch.parallel import Mesh, make_mesh
from mergenet_tpu_torch.parallel import train as TT
from mergenet_tpu_torch.parallel.mesh import check_mesh
from mergenet_tpu_torch.parallel.spatial import build_sharded_forward
from mergenet_tpu_torch.serving import build_serving_pipeline
from mergenet_tpu_torch.utils.train_utils import validate
from torch_port_helpers import (SPIRAL_OFFSETS, randomize_batch_norm,
                                start_ranks)
from torch_port_spatial_ranks import halo_cases, spatial_ranks_worker

C, O, ALPHA, B, HW = 3, 2, 2.0, 4, 32
OFFSETS = ((0, 1), (1, 0))
STEPS = 3
HIER = dict(max_components=1024, pair_components=256, pair_slots=4096)
AUX_C = 5
AUX_NOUT = AUX_C + len(SPIRAL_OFFSETS)


def _flax(model, seed, stats_seed=None):
    model = init_model(model, seed)
    if stats_seed is not None:
        randomize_batch_norm(model, stats_seed)
    return state_dict_to_flax(model)


def _aux_batch(rng):
    """PSPNet's compact batch of `tests/test_torch_port_aux.py`: 64x64
    masks of 8x8 blocks, images that follow them."""
    mask = np.repeat(np.repeat(rng.integers(0, 6, (2, 8, 8)), 8, 1), 8, 2)
    mask = mask.astype(np.int32)
    img = (mask[..., None] * np.array([40, 25, 10])
           + rng.integers(0, 40, (2, 64, 64, 3))).astype(np.uint8)
    oc = rng.integers(0, AUX_C, (2, 16)).astype(np.int32)
    oc[:, 0] = 0
    return img, mask, oc


def _state(model, weights):
    model = load_flax_weights(model, *weights)
    tx = TT.make_optimizer(lr=0.01)
    return TT.TrainState(step=0, model=model,
                         optimizer=tx.init(model.parameters()), tx=tx)


def _arrays(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(41)
    unet = _flax(UNet(C, O, depth=2, start_filts=8), 3, 4)
    # the serving case's head: class 1 favoured, neighbours alike, so
    # every frame holds instances (`test_torch_port_parallel_serving.py`)
    unet[0]["Conv_0"]["bias"] = np.array([0, 0.5, -0.5, 2, 2], np.float32)
    psp = _flax(PSPFPNet(5, layer=50, fpn_dim=32), 5, 6)
    small = _flax(get_model(C, O, "unet_small"), 7)
    aux = _flax(PSPNet(AUX_NOUT, layer=18), 8)
    batches = [(rng.random((B, HW, HW, 3)).astype(np.float32),
                (rng.random((B, HW, HW, C + O)) < 0.5).astype(np.float32))
               for _ in range(STEPS)]
    compact = (rng.integers(0, 256, (B, HW, HW, 3)).astype(np.uint8),
               rng.integers(0, 4, (B, HW, HW)).astype(np.int32),
               rng.integers(0, C, (B, 6)).astype(np.int32))
    vi = rng.random((3, HW, HW, 3)).astype(np.float32)
    vt = (rng.random((3, HW, HW, C + O)) < 0.5).astype(np.float32)
    payload = dict(
        unet=unet, psp=psp, small=small, aux=aux, offsets=OFFSETS,
        imgs_a=rng.random((2, 32, 32, 3)).astype(np.float32),
        imgs_b=rng.random((2, 96, 192, 3)).astype(np.float32),
        imgs_serve=rng.random((4, 32, 32, 3)).astype(np.float32),
        batches=batches, compact=compact,
        val=[(vi[:2], vt[:2]), (vi[2:], vt[2:])],
        aux_C=AUX_C, aux_nout=AUX_NOUT, aux_offsets=SPIRAL_OFFSETS,
        aux_seed=11, aux_batch=_aux_batch(rng), hier=HIER,
        halo_x=rng.standard_normal((1, 2, 16, 5)),
        halo_w=rng.standard_normal((2, 2, 7, 7)),
        halo_gy=rng.standard_normal((1, 2, 32, 10)))
    join = start_ranks(spatial_ranks_worker, 4,
                       tmp_path_factory.mktemp("spatial"), payload)

    # JAX on meshes of the same shapes, meanwhile
    devs = jax.devices()[:4]
    m221 = jmake_mesh(data=2, spatial=2, devices=devs)
    m122 = jmake_mesh(data=1, spatial=2, model=2, devices=devs)
    m141 = jmake_mesh(data=1, spatial=4, devices=devs)
    ref = {"layout": [[tuple(int(i) for i in np.argwhere(
        m.devices == d)[0]) for d in devs] for m in (m221, m122, m141)]}

    def variables(t):
        return {"params": t[0], "batch_stats": t[1]}
    ju = JUNet(C, O, depth=2, start_filts=8)
    for name, mesh in (("a", m221), ("f_forward", m122)):
        ref[name] = np.asarray(jfwd(ju, mesh)(variables(unet), jax.device_put(
            payload["imgs_a"], batch_sharding(mesh))))
    ref["b"] = np.asarray(jfwd(JPSPFPNet(5, layer=50, fpn_dim=32), m141)(
        variables(psp), jax.device_put(payload["imgs_b"],
                                       batch_sharding(m141))))

    jm = jget_model(C, O, "unet_small")
    data = batch_sharding(m221)

    def jstate():
        tx = JT.make_optimizer(lr=0.01)
        p = jax.tree_util.tree_map(jnp.asarray, small[0])
        return JT.TrainState(step=jnp.zeros((), jnp.int32), params=p,
                             batch_stats=jax.tree_util.tree_map(
                                 jnp.asarray, small[1]),
                             opt_state=tx.init(p), tx=tx, apply_fn=jm.apply)
    s = jstate()
    step = JT.build_train_step(C, O, alpha=ALPHA, mesh=m221, donate=False)
    ref["losses"] = []
    for i, (img, tg) in enumerate(batches):
        s, m = step(s, jax.device_put(img, data), jax.device_put(tg, data),
                    jax.random.PRNGKey(i))
        ref["losses"].append({k: float(x) for k, x in m.items()})
    sc = jstate()
    cstep = JT.build_train_step_compact(C, OFFSETS, alpha=ALPHA, mesh=m221,
                                        donate=False)
    nhw = jax.sharding.NamedSharding(m221, jax.sharding.PartitionSpec(
        "data"))
    sc, cm = cstep(sc, jax.device_put(compact[0], data),
                   jax.device_put(compact[1], nhw),
                   jax.device_put(compact[2], nhw), jax.random.PRNGKey(0))

    def sd(st):
        return {k: t.numpy() for k, t in flax_to_state_dict(
            jax.tree_util.tree_map(np.asarray, st.params),
            jax.tree_util.tree_map(np.asarray, st.batch_stats)).items()}
    ref.update(after=sd(s), compact_after=sd(sc),
               compact_loss={k: float(x) for k, x in cm.items()},
               start={k: t.numpy() for k, t in flax_to_state_dict(
                   *small).items()})
    return dict(ranks=join(), ref=ref, payload=payload)


@pytest.fixture(scope="module")
def one_process(run):
    """The port's one-process aux step, validate, eval step and serve."""
    p = run["payload"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sa = _state(PSPNet(AUX_NOUT, layer=18), p["aux"])
        astep = TT.build_train_step_compact(AUX_C, SPIRAL_OFFSETS,
                                            alpha=20.0, aux_weight=0.4)
        sa, m = astep(sa, *p["aux_batch"],
                      torch.Generator().manual_seed(p["aux_seed"]))
        s = _state(get_model(C, O, "unet_small"), p["small"])
        step = TT.build_train_step(C, O, alpha=ALPHA)
        for img, tg in p["batches"]:
            s, _ = step(s, img, tg)
        evaluate = TT.build_eval_step(C, O, alpha=ALPHA)
        val = validate(p["val"], s, evaluate, 2, 0, 0, num_classes=C,
                       offset_list=OFFSETS, score=True, print_freq=100)
        probs, em = evaluate(s, *p["val"][0])
        unet = load_flax_weights(UNet(C, O, depth=2, start_filts=8),
                                 *p["unet"])
        serve = build_serving_pipeline(unet, C, OFFSETS,
                                       decode_size=(16, 16),
                                       hier_kwargs=HIER,
                                       overflow_fallback=True, device="cpu")
        served = [t.numpy() for t in serve(p["imgs_serve"])]
    finally:
        torch.set_num_threads(n)
    return dict(aux_loss={k: float(v) for k, v in m.items()},
                aux_after=_arrays(sa.model), aux_start=_arrays(
                    load_flax_weights(PSPNet(AUX_NOUT, layer=18),
                                      *p["aux"])),
                val=val, eval=(probs.numpy(), {k: v.numpy()
                                               for k, v in em.items()}),
                served=served)


def _assert_states_close(got, ref, start, what, atol=1e-5, stats=1e-5,
                         rel=0.25):
    for k, r in ref.items():
        g = got[k]
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, r, atol=stats, rtol=0,
                                       err_msg="%s %s" % (what, k))
            continue
        if atol is not None:
            np.testing.assert_allclose(g, r, atol=atol, rtol=0,
                                       err_msg="%s %s" % (what, k))
        du, dr = g - start[k], r - start[k]
        if np.linalg.norm(dr) < 1e-6:
            # a conv bias feeding a batch norm: zero gradient in exact
            # arithmetic, its update (norm ~1e-9) is rounding noise
            continue
        assert np.linalg.norm(du - dr) / np.linalg.norm(dr) <= rel, (what, k)


def test_rank_layout_is_the_reference_reshape(run):
    for r, out in enumerate(run["ranks"]):
        assert out["shapes"] == (
            {"data": 2, "spatial": 2, "model": 1},
            {"data": 1, "spatial": 2, "model": 2},
            {"data": 1, "spatial": 4, "model": 1})
        assert list(out["coords"]) == [lay[r] for lay in run["ref"]["layout"]]


def test_unet_forward_on_data_and_spatial_matches_jax(run):
    for out in run["ranks"]:
        np.testing.assert_allclose(out["a"], run["ref"]["a"], rtol=2e-5,
                                   atol=2e-6)


def test_pspfpnet_forward_with_uneven_c4_c5_matches_jax(run):
    # c4 and c5 of a 96-row input have 6 and 3 rows: 4 ranks run them whole
    assert 96 // 16 % 4 and 96 // 32 % 4
    for out in run["ranks"]:
        assert out["b"].shape == (2, 96, 192, 5)
        np.testing.assert_allclose(out["b"], run["ref"]["b"], rtol=2e-5,
                                   atol=2e-5)


def test_train_steps_on_data_and_spatial_match_jax(run):
    ref = run["ref"]
    for out in run["ranks"]:
        for got, want in zip(out["losses"], ref["losses"]):
            for k in ("loss", "cls_loss", "ofs_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=2e-5)
        _assert_states_close(out["after"], ref["after"], ref["start"],
                             "3 steps")
        for k in ("loss", "cls_loss", "ofs_loss"):
            np.testing.assert_allclose(out["compact_loss"][k],
                                       ref["compact_loss"][k], rtol=2e-5)
        _assert_states_close(out["compact_after"], ref["compact_after"],
                             ref["start"], "compact")
    a = run["ranks"][0]["after"]
    for out in run["ranks"][1:]:  # every rank holds the same state
        for k in a:
            np.testing.assert_array_equal(out["after"][k], a[k], err_msg=k)


def test_aux_step_with_dropout_and_model_axis_matches_one_process(
        run, one_process):
    for out in run["ranks"]:
        for k, v in one_process["aux_loss"].items():
            np.testing.assert_allclose(out["aux_loss"][k], v, rtol=1e-4)
        _assert_states_close(out["aux_after"], one_process["aux_after"],
                             one_process["aux_start"], "aux", atol=None,
                             stats=1e-3, rel=0.05)


def test_validate_and_eval_on_data_and_spatial_match_one_process(
        run, one_process):
    probs, m = one_process["eval"]
    for out in run["ranks"]:
        np.testing.assert_allclose(out["val"], one_process["val"],
                                   atol=1e-5)
        np.testing.assert_allclose(out["eval"][0], probs, atol=1e-5)
        for k, v in m.items():
            np.testing.assert_allclose(out["eval"][1][k], v, atol=1e-5,
                                       err_msg=k)


def test_serving_on_spatial_and_model_axes_equals_one_process(
        run, one_process):
    served = one_process["served"]
    assert served[0].max() > 0 and not served[2].any()
    for out in run["ranks"]:
        assert len(out["f_serve"]) == 3
        for got, want in zip(out["f_serve"], served):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(out["f_forward"], run["ref"]["f_forward"],
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("case", [c[0] for c in halo_cases()])
def test_halo_exchange_forward_gradient_and_gradcheck(run, case):
    for out in run["ranks"]:
        got = out["g"][case]
        assert got["finite"]
        assert got["out"] <= 1e-12 and got["dx"] <= 1e-12 \
            and got["dw"] <= 1e-12, got
        assert got["gradcheck"]
        # a 7-row output does not divide over 4 ranks: computed whole
        assert got["sharded"] == (case != "conv5_s2_p1")


def test_halo_exchange_rows_at_zero_and_minus_inf_fill(run):
    for out in run["ranks"]:
        assert out["g"]["exchange_0.0"] and out["g"]["exchange_-inf"]


def test_meshes_of_any_shape_are_accepted_and_bad_ones_refused():
    for shape in ({"data": 1, "spatial": 2, "model": 1},
                  {"data": 1, "spatial": 1, "model": 2},
                  {"data": 2, "spatial": 2, "model": 2}):
        n = int(np.prod(list(shape.values())))
        mesh = Mesh(shape, 0, n, torch.device("cpu"))
        assert check_mesh(mesh) is mesh
    with pytest.raises(ValueError, match="world"):
        check_mesh(Mesh({"data": 1, "spatial": 2, "model": 1}, 0, 4,
                        torch.device("cpu")))
    with pytest.raises(ValueError, match="make_mesh"):  # no groups to run
        Mesh({"data": 1, "spatial": 2, "model": 1}, 0, 2,
             torch.device("cpu")).axis("spatial")
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(spatial=2, device="cpu")  # one process, no group
    with pytest.raises(TypeError, match="make_mesh"):
        build_sharded_forward(UNet(C, O, depth=2, start_filts=8),
                              jmake_mesh(data=1, devices=jax.devices()[:1]))
