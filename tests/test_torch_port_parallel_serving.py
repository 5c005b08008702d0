"""Data-parallel serving (`serving.build_serving_pipeline(mesh=...)`) and
the sharded forward (`parallel/spatial.py`) on 2 gloo ranks of the CPU,
against the port's one-process serve and the JAX package's serve and
forward on a 2-device CPU mesh.

The UNet of `tests/test_serving.py` (depth 2, 8 filters, 3 classes, 2
offsets) with Flax's init, its head's biases set so that every frame
holds an instance (class 1 favoured, neighbours alike), 8 frames of
32x32 decoded at 16x16 with the capacities of that test; one rank
serves frames 0-3, the other 4-7:
- masks, classes (and overflow counts) equal to the one-process serve
  and to JAX's mesh serve, bit for bit;
- the overflow fallback on a batch where only rank 1's frames overflow
  (rank 0's are flat colours, rank 1's noise; the head scaled x20 so
  that noise overflows 256 components): the counts, and the masks after
  each rank re-decodes its own flagged frames with the exact mode;
- `build_sharded_forward` within 1e-5 of JAX's on the data mesh;
- a spatial axis accepted when the sharded forward and serving are
  built (`test_torch_port_spatial.py` runs them), a mesh whose axes do
  not multiply to its world and a JAX mesh refused."""

import copy

import jax
import numpy as np
import pytest
import torch

from mergenet_tpu.models import init_model
from mergenet_tpu.models.unet import UNet as JUNet
from mergenet_tpu.parallel import make_mesh as jmake_mesh
from mergenet_tpu.parallel.mesh import batch_sharding
from mergenet_tpu.parallel.spatial import build_sharded_forward as jfwd
from mergenet_tpu.serving import build_serving_pipeline as jserving
from mergenet_tpu_torch.convert import load_flax_weights
from mergenet_tpu_torch.models.unet import UNet
from mergenet_tpu_torch.parallel import Mesh
from mergenet_tpu_torch.parallel.spatial import build_sharded_forward
from mergenet_tpu_torch.serving import build_serving_pipeline
from torch_port_helpers import serve_ranks_worker, spawn_ranks

C, OFFSETS = 3, ((0, 1), (1, 0))
HIER = dict(max_components=1024, pair_components=256, pair_slots=4096)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jm = JUNet(C, len(OFFSETS), depth=2, start_filts=8)
    params, stats = jax.tree_util.tree_map(
        np.asarray, init_model(jm, jax.random.PRNGKey(0), (1, 32, 32, 3)))
    rng = np.random.default_rng(0)
    imgs = np.array(jax.random.uniform(jax.random.PRNGKey(1),
                                       (8, 32, 32, 3)))
    plain = copy.deepcopy(params)
    plain["Conv_0"]["bias"] = np.array([0, 0.5, -0.5, 2, 2], np.float32)
    hot = copy.deepcopy(params)
    hot["Conv_0"]["kernel"] = hot["Conv_0"]["kernel"] * 20
    hot["Conv_0"]["bias"] = np.array([0, 0.5, -0.5, 0, 0], np.float32)
    mixed = np.zeros((8, 32, 32, 3), np.float32)
    mixed[:4] = rng.random((4, 1, 1, 3))
    mixed[:4] = mixed[1]  # a flat frame that stays within budget
    mixed[4:] = rng.random((4, 32, 32, 3))
    cases = {"plain": dict(weights=(plain, stats), imgs=imgs, hier=HIER,
                           fallback=False),
             "overflow": dict(weights=(hot, stats), imgs=mixed,
                              hier=dict(max_components=256),
                              fallback=True)}
    ranks = spawn_ranks(serve_ranks_worker, 2,
                        tmp_path_factory.mktemp("serve"),
                        dict(C=C, offsets=OFFSETS, cases=cases))

    mesh = jmake_mesh(data=2, devices=jax.devices()[:2])
    ref, one = {}, {}
    torch.set_num_threads(1)
    for name, case in cases.items():
        p, b = case["weights"]
        serve = jserving(jm, C, OFFSETS, mesh, decode_size=(16, 16),
                         hier_kwargs=case["hier"],
                         overflow_fallback=case["fallback"])
        ref[name] = [np.asarray(t) for t in serve(
            {"params": p, "batch_stats": b},
            jax.device_put(case["imgs"], batch_sharding(mesh)))]
        model = load_flax_weights(UNet(C, len(OFFSETS), depth=2,
                                       start_filts=8), p, b)
        serve = build_serving_pipeline(
            model, C, OFFSETS, decode_size=(16, 16), hier_kwargs=case["hier"],
            overflow_fallback=case["fallback"], device="cpu")
        one[name] = [t.numpy() for t in serve(case["imgs"])]
    ref["forward"] = np.asarray(jfwd(jm, mesh)(
        {"params": plain, "batch_stats": stats},
        jax.device_put(imgs, batch_sharding(mesh))))
    return dict(ranks=ranks, ref=ref, one=one, params=params, stats=stats)


@pytest.mark.parametrize("case", ["plain", "overflow"])
def test_two_rank_serving_equals_one_process_and_jax(run, case):
    one, ref = run["one"][case], run["ref"][case]
    if case == "overflow":  # only rank 1's frames are over budget
        assert not one[2][:4].any() and one[2][4:].all()
    else:
        assert one[0].max() > 0
    for out in run["ranks"]:
        assert len(out[case]) == len(one)
        for got, a, b in zip(out[case], one, ref):
            np.testing.assert_array_equal(got, a)
            np.testing.assert_array_equal(got, b)


def test_sharded_forward_matches_jax(run):
    for out in run["ranks"]:
        np.testing.assert_allclose(out["forward"], run["ref"]["forward"],
                                   atol=1e-5, rtol=0)


def test_sharded_forward_refuses_a_spatial_axis(run):
    # a spatial axis is accepted (tests/test_torch_port_spatial.py serves
    # and forwards on one); a mesh whose axes do not multiply to its
    # world and a JAX mesh are refused
    model = load_flax_weights(UNet(C, len(OFFSETS), depth=2, start_filts=8),
                              run["params"], run["stats"])
    spatial = Mesh({"data": 1, "spatial": 2, "model": 1}, 0, 2,
                   torch.device("cpu"))
    assert build_sharded_forward(model, spatial).model is not model
    assert build_serving_pipeline(model, C, OFFSETS,
                                  mesh=spatial).model is not model
    bad = Mesh({"data": 1, "spatial": 2, "model": 1}, 0, 4,
               torch.device("cpu"))
    with pytest.raises(ValueError, match="world"):
        build_sharded_forward(model, bad)
    with pytest.raises(ValueError, match="world"):
        build_serving_pipeline(model, C, OFFSETS, mesh=bad)
    with pytest.raises(TypeError, match="make_mesh"):
        build_serving_pipeline(model, C, OFFSETS, mesh=jmake_mesh(
            data=1, devices=jax.devices()[:1]))
