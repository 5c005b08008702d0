"""The port's data-parallel layer (`parallel/mesh.py`, the steps' `mesh`,
the cross-rank batch norm, the checkpoint barriers) on 2 gloo ranks of
the CPU against the JAX package's step on a 2-device CPU mesh.

One module-scoped spawn (`torch_port_helpers.spawn_ranks`: a FileStore
rendezvous, no ports, one torch thread per rank) runs every port-side
case; JAX runs here on `make_mesh(data=2, devices=jax.devices()[:2])`.
unet_small at batch 4 of 32x32, alpha 2, from the same Flax variables:
- 3 steps of `build_train_step` and 1 of `build_train_step_compact`:
  losses within rtol 2e-5 (the gate of `tests/test_parallel.py`'s
  sharded step); parameters within atol 1e-5 and each parameter's
  update (new - old) within 0.25 of JAX's in relative L2 norm (the
  unet_small and PSPFPNet tolerances of `test_torch_port_train.py`;
  measured 0.0045 at most; the conv biases ahead of a batch norm,
  whose exact gradient is 0 and whose updates are ~1e-9 of rounding,
  are held by the atol only); batch-norm running statistics within
  1e-5 (the running variance biased, as the reference's);
- the 2-rank step against the port's one-process step on the whole
  batch, to the same tolerances;
- `shard_batch` against the JAX batch sharding's shards, and
  `data_axis_for_batch` against the reference's rule;
- the checkpoint barriers: rank 0 alone removes a stale checkpoint and
  writes; both ranks load the same tensors (bit for bit);
- `validate(pad_to=2)` over a partial batch against the one-process
  `validate`;
- the steps fed each rank's shard (`local_batch=True`, as a loader
  sharded by rank feeds them) against the steps fed the global batch,
  bit for bit, and the loaders' shards (`DataLoader` and the compact
  pipeline with `shard=(rank, world)`) against the whole batches;
- the cityscape train recipe on the 2 ranks (each loads its slice of
  every batch through the compact pipeline, rank 0 alone writes the
  logs) against the recipe in one process: the same `model_best`
  within atol 1e-5."""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models import get_model as jget_model
from mergenet_tpu.parallel import make_mesh as jmake_mesh
from mergenet_tpu.parallel import train as JT
from mergenet_tpu.parallel.mesh import batch_sharding
from mergenet_tpu.parallel.mesh import data_axis_for_batch as jdata_axis
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.convert import flax_to_state_dict, load_flax_weights
from mergenet_tpu_torch.data import DataLoader, rle
from mergenet_tpu_torch.data.pipeline import TrainPipeline
from mergenet_tpu_torch.egs.cityscape import train as P_train
from mergenet_tpu_torch.models import get_model
from mergenet_tpu_torch.parallel import (Mesh, data_axis_for_batch,
                                         make_mesh)
from mergenet_tpu_torch.parallel import train as TT
from mergenet_tpu_torch.parallel.mesh import check_mesh
from mergenet_tpu_torch.utils.checkpoint import load_checkpoint
from mergenet_tpu_torch.utils.train_utils import validate
from torch_port_helpers import spawn_ranks, train_ranks_worker

C, O, ALPHA, B, HW = 3, 2, 2.0, 4, 32
OFFSETS = ((0, 1), (1, 0))
STEPS = 3


def _np_tree(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _toy_coco(root):
    """Four 32x48 images of two rectangles each and their annotations;
    returns the train recipe's data flags."""
    images, anns = [], []
    for i in range(4):
        img = np.full((32, 48, 3), 40 + 30 * i, np.uint8)
        for x, y, w, h, cat in ((3 + i, 4, 14, 10, 1), (24, 15 - i, 16, 12,
                                                        2)):
            img[y:y + h, x:x + w] = (220, 60, 60) if cat == 1 \
                else (60, 60, 220)
            m = np.zeros((32, 48), np.uint8)
            m[y:y + h, x:x + w] = 1
            r = rle.encode(np.asfortranarray(m))
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": cat, "iscrowd": 0,
                         "segmentation": {"size": r["size"], "counts":
                                          r["counts"].decode("ascii")},
                         "area": int(m.sum()), "bbox": [x, y, w, h]})
        TIO.write_png(os.path.join(root, "img%d.png" % i), img)
        images.append({"id": i, "file_name": "img%d.png" % i,
                       "height": 32, "width": 48})
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": 1, "name": "car"}, {"id": 2, "name": "person"}]}, f)
    return ["--train-img", root, "--val-img", root, "--train-ann", ann,
            "--val-ann", ann, "--num-classes", "2", "--num-offsets", "2",
            "--arch", "unet_small", "--batch-size", "4", "--epochs", "1",
            "--input-pipeline", "grain", "--crop-size", "24", "--lr",
            "0.02", "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(31)
    jm = jget_model(C, O, "unet_small")
    v = jax.jit(lambda k: jm.init({"params": k, "dropout": k},
                                  jnp.zeros((1, HW, HW, 3)), train=False))(
        jax.random.PRNGKey(5))
    params, stats = _np_tree(v["params"]), _np_tree(v["batch_stats"])
    batches = [(rng.random((B, HW, HW, 3)).astype(np.float32),
                (rng.random((B, HW, HW, C + O)) < 0.5).astype(np.float32))
               for _ in range(STEPS)]
    mask = rng.integers(0, 4, (B, HW, HW)).astype(np.int32)
    compact = (rng.integers(0, 256, (B, HW, HW, 3)).astype(np.uint8), mask,
               rng.integers(0, C, (B, 6)).astype(np.int32))
    vi = rng.random((3, HW, HW, 3)).astype(np.float32)
    vt = (rng.random((3, HW, HW, C + O)) < 0.5).astype(np.float32)
    val = [(vi[:2], vt[:2]), (vi[2:], vt[2:])]
    recipe = _toy_coco(str(tmp_path_factory.mktemp("toy_coco")))
    payload = dict(C=C, O=O, alpha=ALPHA, offsets=OFFSETS, params=params,
                   batch_stats=stats, batches=batches, compact=compact,
                   val=val, recipe=recipe)
    rank_dir = tmp_path_factory.mktemp("ranks")
    ranks = spawn_ranks(train_ranks_worker, 2, rank_dir, payload)

    # JAX: the same steps on a 2-device data mesh
    mesh = jmake_mesh(data=2, devices=jax.devices()[:2])
    data = batch_sharding(mesh)

    def jstate():
        tx = JT.make_optimizer(lr=0.01)
        return JT.TrainState(step=jnp.zeros((), jnp.int32),
                             params=jax.tree_util.tree_map(jnp.asarray,
                                                           params),
                             batch_stats=jax.tree_util.tree_map(
                                 jnp.asarray, stats),
                             opt_state=tx.init(params), tx=tx,
                             apply_fn=jm.apply)
    s = jstate()
    step = JT.build_train_step(C, O, alpha=ALPHA, mesh=mesh, donate=False)
    jlosses = []
    for i, (img, tg) in enumerate(batches):
        s, m = step(s, jax.device_put(img, data), jax.device_put(tg, data),
                    jax.random.PRNGKey(i))
        jlosses.append({k: float(x) for k, x in m.items()})
    sc = jstate()
    cstep = JT.build_train_step_compact(C, OFFSETS, alpha=ALPHA, mesh=mesh,
                                        donate=False)
    nhw = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        "data"))
    sc, cm = cstep(sc, jax.device_put(compact[0], data),
                   jax.device_put(compact[1], nhw),
                   jax.device_put(compact[2], nhw), jax.random.PRNGKey(0))
    shards = [np.asarray(x.data) for x in sorted(
        jax.device_put(batches[0][0], data).addressable_shards,
        key=lambda x: x.index[0].start)]

    def sd(st):
        return {k: t.numpy() for k, t in flax_to_state_dict(
            _np_tree(st.params), _np_tree(st.batch_stats)).items()}

    start = {k: t.numpy() for k, t in flax_to_state_dict(params,
                                                         stats).items()}
    return dict(ranks=ranks, jlosses=jlosses, jafter=sd(s),
                jcompact={k: float(x) for k, x in cm.items()},
                jcompact_after=sd(sc), shards=shards, start=start,
                payload=payload, recipe_dir=rank_dir / "recipe")


@pytest.fixture(scope="module")
def one_process(run):
    """The port's one-process steps on the whole batch, from the same
    variables."""
    p = run["payload"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = load_flax_weights(get_model(C, O, "unet_small"),
                                  p["params"], p["batch_stats"])
        tx = TT.make_optimizer(lr=0.01)
        s = TT.TrainState(step=0, model=model,
                          optimizer=tx.init(model.parameters()), tx=tx)
        step = TT.build_train_step(C, O, alpha=ALPHA)
        losses = []
        for img, tg in p["batches"]:
            s, m = step(s, img, tg)
            losses.append({k: float(v) for k, v in m.items()})
        evaluate = TT.build_eval_step(C, O, alpha=ALPHA)
        val = validate(p["val"], s, evaluate, 2, 0, 0, num_classes=C,
                       offset_list=OFFSETS, score=True, print_freq=100)
    finally:
        torch.set_num_threads(n)
    return dict(losses=losses, val=val, after={
        k: v.detach().numpy() for k, v in s.model.state_dict().items()})


def _assert_states_close(got, ref, start, what):
    assert got.keys() >= {k for k in ref if "num_batches" not in k}
    for k, r in ref.items():
        g = got[k]
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=0,
                                   err_msg="%s %s" % (what, k))
        if k.endswith(("running_mean", "running_var")):
            continue
        du, dr = g - start[k], r - start[k]
        if np.linalg.norm(dr) < 1e-6:
            # a conv bias feeding a batch norm: zero gradient in exact
            # arithmetic, its update (norm ~1e-9) is rounding noise
            continue
        rel = np.linalg.norm(du - dr) / np.linalg.norm(dr)
        assert rel <= 0.25, (what, k, rel)


def test_mesh_shard_batch_and_data_axis_match_the_reference(run):
    for r, out in enumerate(run["ranks"]):
        assert (out["rank"], out["world"]) == (r, 2)
        assert out["shape"] == {"data": 2, "spatial": 1, "model": 1}
        np.testing.assert_array_equal(out["shard"], run["shards"][r])
    for b in range(1, 21):
        for n in range(1, 10):
            assert data_axis_for_batch(b, n) == jdata_axis(b, n), (b, n)
    assert data_axis_for_batch(16) == 1  # no process group: world 1
    mesh = make_mesh(device="cpu")
    assert (mesh.shape["data"], mesh.rank, mesh.world) == (1, 0, 1)


def test_two_rank_train_steps_match_jax_mesh_step(run):
    for out in run["ranks"]:
        for got, ref in zip(out["losses"], run["jlosses"]):
            for k in ("loss", "cls_loss", "ofs_loss"):
                np.testing.assert_allclose(got[k], ref[k], rtol=2e-5)
        _assert_states_close(out["after"], run["jafter"], run["start"],
                             "3 steps")
    a, b = (r["after"] for r in run["ranks"])
    for k in a:  # the ranks hold the same replicated state
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_rank_compact_step_matches_jax_mesh_step(run):
    for out in run["ranks"]:
        for k in ("loss", "cls_loss", "ofs_loss"):
            np.testing.assert_allclose(out["compact_loss"][k],
                                       run["jcompact"][k], rtol=2e-5)
        _assert_states_close(out["compact_after"], run["jcompact_after"],
                             run["start"], "compact")


def test_two_rank_step_matches_the_one_process_step(run, one_process):
    for out in run["ranks"]:
        for got, ref in zip(out["losses"], one_process["losses"]):
            for k in ("loss", "cls_loss", "ofs_loss"):
                np.testing.assert_allclose(got[k], ref[k], rtol=2e-5)
        _assert_states_close(out["after"], one_process["after"],
                             run["start"], "one process")
        # a partial last batch padded to the data axis, real rows scored
        np.testing.assert_allclose(out["val"], one_process["val"],
                                   atol=1e-5)


def test_checkpoint_barriers_rank0_writes_every_rank_loads(run):
    r0, r1 = run["ranks"]
    assert len(r0["removed"]) == 1 and r0["removed"][0].endswith(
        "checkpoint")
    assert r1["removed"] == []
    for out in (r0, r1):
        assert out["loaded_step"] == STEPS
        assert out["meta"]["offsets"] == [tuple(o) for o in OFFSETS]
        for k, v in r0["after"].items():
            np.testing.assert_array_equal(out["loaded"][k], v, err_msg=k)


def test_meshes_the_port_cannot_run_are_refused():
    # spatial and model axes are accepted (tests/test_torch_port_spatial.py
    # runs them on 4 ranks); axes that do not multiply to the world and a
    # JAX mesh stay refused
    spatial = Mesh({"data": 1, "spatial": 2, "model": 1}, 0, 2,
                   torch.device("cpu"))
    assert check_mesh(spatial) is spatial
    model = Mesh({"data": 1, "spatial": 1, "model": 2}, 1, 2,
                 torch.device("cpu"))
    assert check_mesh(model) is model
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(spatial=2, device="cpu")  # one process, no group
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="world"):
        check_mesh(Mesh({"data": 1, "spatial": 2, "model": 1}, 0, 4,
                        torch.device("cpu")))
    with pytest.raises(TypeError, match="make_mesh"):
        TT.build_eval_step(C, O, mesh=jmake_mesh(data=1,
                                                 devices=jax.devices()[:1]))
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(data=2, device="cpu")


def test_local_shards_step_as_the_global_batch(run):
    for r, out in enumerate(run["ranks"]):
        for k, v in out["after"].items():
            np.testing.assert_array_equal(out["after_local"][k], v,
                                          err_msg=k)
        for k, v in out["compact_after"].items():
            np.testing.assert_array_equal(out["compact_after_local"][k], v,
                                          err_msg=k)
        # the local eval step: this rank's rows, the global mean loss
        probs, loss = out["eval"]
        np.testing.assert_array_equal(out["eval_local"][0], probs[r:r + 1])
        assert out["eval_local"][1] == loss


def test_loaders_shard_each_batch_by_rank():
    data = [np.full((3,), i, np.int32) for i in range(11)]
    whole = list(DataLoader(data, batch_size=4, shuffle=True,
                            drop_last=True, seed=3))
    parts = [list(DataLoader(data, batch_size=4, shuffle=True,
                             drop_last=True, seed=3, shard=(r, 2)))
             for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 2
    for k, b in enumerate(whole):
        np.testing.assert_array_equal(
            np.concatenate([parts[0][k], parts[1][k]]), b)
    rng = np.random.default_rng(2)
    recs = [{"image": rng.integers(0, 256, (30, 40, 3)).astype(np.uint8),
             "mask": rng.integers(0, 3, (30, 40)).astype(np.int32),
             "object_class": rng.integers(0, 3, (4,)).astype(np.int32)}
            for _ in range(9)]
    whole = list(TrainPipeline(recs, 4, 24, seed=5, read_threads=1))
    parts = [list(TrainPipeline(recs, 4, 24, seed=5, read_threads=1,
                                shard=(r, 2))) for r in range(2)]
    assert len(whole) == len(parts[0]) == 2
    for k, b in enumerate(whole):
        for key, v in b.items():
            np.testing.assert_array_equal(
                np.concatenate([parts[0][k][key], parts[1][k][key]]), v)
    for bad in (dict(batch_size=3, drop_last=True),
                dict(batch_size=4, drop_last=False)):
        with pytest.raises(ValueError, match="shard"):
            DataLoader(data, shard=(0, 2), **bad)


def test_train_recipe_on_two_ranks_matches_one_process(run, tmp_path):
    """The recipe under a 2-rank group (each rank loads 2 of the batch's
    4 crops, the crops the whole batch would hold) against the recipe
    in one process on the whole batch."""
    assert [r["recipe_rc"] for r in run["ranks"]] == [0, 0]
    assert [r["recipe_batches"] for r in run["ranks"]] == [[2], [2]]
    argv = run["payload"]["recipe"] + [str(tmp_path / "one")]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert P_train.main(argv) == 0
    finally:
        torch.set_num_threads(n)

    def best(d):
        state = TT.create_train_state(get_model(2, 2, "unet_small"),
                                      TT.make_optimizer(), device="cpu")
        state, meta = load_checkpoint(os.path.join(d, "model_best"), state)
        return state.step, meta["offsets"], {
            k: v.numpy() for k, v in state.model.state_dict().items()}
    got, ref = best(run["recipe_dir"]), best(tmp_path / "one")
    assert got[:2] == ref[:2] and got[0] == 1
    for k, v in ref[2].items():
        np.testing.assert_allclose(got[2][k], v, atol=1e-5, rtol=0,
                                   err_msg=k)
    # rank 0 alone writes the scalar log
    assert [r["recipe_logs"] for r in run["ranks"]] == [
        [str(run["recipe_dir"])], []]
