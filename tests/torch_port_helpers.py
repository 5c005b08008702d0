"""Shared pieces of the `test_torch_port_*` tests and `chip_smoke.py`:
fixture paths, offset sets, random absorb planes, class widening,
label-grid comparison up to renaming, and the card check.  Imports no
JAX: the card-only tests and `chip_smoke.py` run where there is none."""

import os

import numpy as np
import pytest

FIX512 = os.path.join(os.path.dirname(__file__), "fixtures",
                      "certification512")
FIX19 = os.path.join(os.path.dirname(__file__), "fixtures",
                     "certification19")

#: decode_hierarchical arguments of the served frame (bench.py)
SERVE_KW = dict(object_merge_factor=1.0, merge_logprob_bias=0.03)

#: the fixture's offsets (certification512/offsets.npy) and the survey's
#: default spiral (core/config.py), which reach past absorb's halo
FIXTURE_OFFSETS = ((1, 0), (0, 2), (-2, -1), (2, -4), (5, 5), (-9, 7),
                   (-9, -16), (28, -10), (9, 48), (-80, 0))
SPIRAL_OFFSETS = ((1, 0), (0, 1), (-2, -1), (1, -2), (3, 2), (-4, 3),
                  (-4, -7), (10, -4), (3, 15), (-21, 0))


def absorb_planes(rng, H, W, O, classes=4, frozen=0.05, ties=True,
                  size_hi=120, comp_lo=-2):
    """Random stage-2 planes of the absorb scan, drawn from `rng` in this
    order: comp ids in [comp_lo, 60) (some negative by default), size in
    [1, size_hi), argcls in [0, classes), frozen (int32, each pixel with
    probability `frozen`), log_odds (O, H, W) float32, quantised to
    halves when `ties` (ties in priority, as on trained maps)."""
    comp = rng.integers(comp_lo, 60, (H, W)).astype(np.int32)
    size = rng.integers(1, size_hi, (H, W)).astype(np.int32)
    argc = rng.integers(0, classes, (H, W)).astype(np.int32)
    froz = (rng.random((H, W)) < frozen).astype(np.int32)
    lo = rng.standard_normal((O, H, W)) * 4
    lo = (np.round(lo) / 2 if ties else lo).astype(np.float32)
    return comp, size, argc, froz, lo


def wide_classes(cp, C=19):
    """Class probabilities widened to C classes: background stays class
    0, class c >= 1 becomes C - c (past the packed stats' 4 class bits
    for c <= C - 16), and the new classes get a small probability."""
    k = cp.shape[-1]
    wide = np.full(cp.shape[:-1] + (C,), 1e-6, np.float32)
    scaled = cp * np.float32(1 - (C - k) * 1e-6)
    wide[..., 0] = scaled[..., 0]
    wide[..., C - np.arange(1, k)] = scaled[..., 1:]
    return wide


def assert_same_partition(a, b, classes_a=None, classes_b=None):
    """Two label grids are the same partition up to renaming of ids
    (a bijection between their ids); with instance-class tables, matched
    instances (ids >= 1) also carry the same class."""
    a = np.asarray(a).ravel().astype(np.int64)
    b = np.asarray(b).ravel().astype(np.int64)
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    assert len(pairs) == len(np.unique(a)) == len(np.unique(b)), (
        "partitions differ: %d id pairs for %d / %d ids, %d pixels differ"
        % (len(pairs), len(np.unique(a)), len(np.unique(b)),
           _pixels_differing(a, b)))
    if classes_a is not None:
        ca, cb = np.asarray(classes_a), np.asarray(classes_b)
        for i, j in pairs:
            if i >= 1 and j >= 1:
                assert ca[i - 1] == cb[j - 1], (i, j, ca[i - 1], cb[j - 1])


def _pixels_differing(a, b):
    K = int(b.max()) + 1
    u, cnt = np.unique(a * K + b, return_counts=True)
    best = {}
    for code, c in zip(u, cnt):
        i = int(code) // K
        best[i] = max(best.get(i, 0), int(c))
    return int(a.size - sum(best.values()))


def logit(p):
    p = p.astype(np.float32)
    return (np.log(p) - np.log1p(-p)).astype(np.float32)


@pytest.fixture
def cuda_device():
    """torch.device('cuda'), or a skip when there is no GPU (decided at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (on the card: MERGENET_TPU_TESTS=1 python -m "
                    "pytest tests/test_torch_port_cuda.py -m cuda)")
    return torch.device("cuda")


#: the 8 certification512 fixtures' mask-AP and AP50 as the JAX package
#: scores them on the CPU (served settings `SERVE_KW`; hier:
#: decode_hierarchical + relabel_mask, exact: run_segmentation_device's
#: default mode, cpp: the committed cpp_mask_*.npz), under procedure (a),
#: the reference's (every image of val_ann.json), and (b), the 8 fixture
#: images only; "a01" is hier over fixtures 0 and 1 under (a); "c" is
#: procedure (c): the committed bench_ckpt.npz's net on the 50 val
#: images regenerated by the reference generator, hier and exact decodes
#: of its float32 maps, every val image scored (zero overflow); "c_jpeg"
#: is (c)'s hier decode on the committed JPEGs of those images
#: (tests/fixtures/jpeg/val/, quality 90, 4:2:0) read with cv2.imread;
#: "c_webp" the same on the committed q90 WebPs (tests/fixtures/webp/val/,
#: `tests/jax_certification_ap.py c_webp`); "c_jp2" on the committed JPEG
#: 2000 files (tests/fixtures/jp2/val/, cv2's writer at 1/10 of the raw
#: size, `tests/jax_certification_ap.py c_jp2`); "c_exact_0_7" is (c)'s exact
#: column on val images 0-7, scored over them (`tests/jax_certification_ap.py c_exact_0_7`)
JAX_AP = {"a": {"hier": (0.09725247524752474, 0.11262376237623763),
                "exact": (0.09628712871287129, 0.11633663366336634),
                "cpp": (0.0927062706270627, 0.11633663366336634)},
          "b": {"hier": (0.7429826732673268, 0.8675742574257426),
                "exact": (0.7390057755775578, 0.8985148514851485),
                "cpp": (0.7088778877887789, 0.8985148514851485)},
          "a01": {"hier": (0.02524752475247525, 0.028465346534653466)},
          "c": {"hier": (0.6920563049981829, 0.8145283278327833),
                "exact": (0.6562437697688676, 0.8091715064363579)},
          "c_jpeg": {"hier": (0.6876531846190053, 0.8105060506050605)},
          "c_webp": {"hier": (0.6938175404800658, 0.8105060506050605)},
          "c_jp2": {"hier": (0.6923888025323589, 0.8094588304984344)},
          "c_exact_0_7": {"exact": (0.7355486798679868,
                                    0.8985148514851485)}}


def coco_stats(coco, results, img_ids=None, cocoeval=None):
    """The 12 COCOeval('segm') stats of COCO `results` against the
    ground truth `coco` (stats[0] is AP, stats[1] AP50), with `cocoeval`
    (default: the port's COCOeval); `img_ids` replaces the evaluated
    image ids (None: every image of the ground truth)."""
    import contextlib
    import io
    if cocoeval is None:
        from mergenet_tpu_torch.data.cocoeval import COCOeval as cocoeval
    with contextlib.redirect_stdout(io.StringIO()):
        E = cocoeval(coco, coco.loadRes(results), "segm")
        if img_ids is not None:
            E.params.imgIds = list(img_ids)
        E.evaluate()
        E.accumulate()
        E.summarize()
    return [float(v) for v in E.stats]


def seeded_weights(model, seed):
    """Every conv weight of a port `model` drawn ~ N(0, 1 / fan_in) from
    a seeded generator (one pass: cheaper than `init_model`'s truncated
    normal on the CPU, for tests that need some seeded weights, not
    flax's init), then `randomize_batch_norm(model, seed + 1)`.  Returns
    the model."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=g) * fan_in ** -0.5)
    return randomize_batch_norm(model, seed + 1)


def randomize_batch_norm(model, seed):
    """Give every batch norm of a port `model` seeded non-trivial
    statistics and affine (scale and var in [0.5, 1.5), bias and mean
    ~ N(0, 0.1)) and every conv bias ~ N(0, 0.1), in place: a misplaced
    tensor cannot hide behind flax's init (mean 0, var 1, scale 1).
    Returns the model."""
    import torch
    from mergenet_tpu_torch.models.layers import SyncBatchNorm
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, SyncBatchNorm):
                n = mod.weight.numel()
                mod.weight.copy_(torch.rand(n, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(n, generator=g) * 0.1)
                mod.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                mod.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            elif isinstance(getattr(mod, "bias", None), torch.nn.Parameter):
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=g)
                               * 0.1)
    return model


def _varint(x):
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if not x:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _len_delim(field, payload):
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def caffe_layer(name, ltype, blobs, bias_term=None):
    """One caffe NetParameter `layer` (field 100) in the protobuf wire
    format: name, type, each blob as a BlobProto (shape + packed float32
    data) and, for a conv, `convolution_param.bias_term`."""
    payload = _len_delim(1, name.encode()) + _len_delim(2, ltype.encode())
    for arr in blobs:
        arr = np.asarray(arr, np.float32)
        shape = b"".join(_varint(1 << 3) + _varint(d) for d in arr.shape)
        payload += _len_delim(7, _len_delim(7, shape) + _len_delim(
            5, arr.astype("<f4").tobytes()))
    if bias_term is not None:
        payload += _len_delim(106, _varint(2 << 3) + _varint(int(bias_term)))
    return _len_delim(100, payload)


def write_pspnet_caffemodel(path, model, layer):
    """Write a port `PSPNet`'s weights as a caffemodel with the released
    PSPNet's layer names (`utils.weight_import.caffe_pspnet_mapping`):
    each conv's OIHW weight (+ bias on the two classifiers, bias_term
    false elsewhere) as a `ConvolutionData` layer, each batch norm as
    `<conv>/bn` `BNData` blobs gamma, beta, mean, var.  Layers are
    written one at a time (the full PSPNet-r101 is ~270 MB).  Returns
    the number of bytes written."""
    from mergenet_tpu_torch.utils.weight_import import caffe_pspnet_mapping
    n = 0
    with open(path, "wb") as f:
        for cname, cpath, bnpath in caffe_pspnet_mapping(layer):
            conv = model.get_submodule(cpath.replace("/", "."))
            blobs = [conv.weight.detach().float().cpu().numpy()]
            if bnpath is None:
                blobs.append(conv.bias.detach().float().cpu().numpy())
            rec = caffe_layer(cname, "ConvolutionData", blobs,
                              bias_term=bnpath is None)
            if bnpath is not None:
                bn = model.get_submodule(bnpath.replace("/", "."))
                rec += caffe_layer(cname + "/bn", "BNData", [
                    t.detach().float().cpu().numpy() for t in (
                        bn.weight, bn.bias, bn.running_mean,
                        bn.running_var)])
            f.write(rec)
            n += len(rec)
    return n


# ------------------------------------------------ data-parallel ranks

def spawn_ranks(worker, world, tmp_dir, payload):
    """Run `worker(mesh, payload, out_dir)` on `world` gloo ranks of the
    CPU (torch.multiprocessing.spawn; the rendezvous is a FileStore
    under `tmp_dir`, no ports), one torch thread each; returns each
    rank's result (what `worker` returned, through torch.save) in rank
    order."""
    return start_ranks(worker, world, tmp_dir, payload)()


def start_ranks(worker, world, tmp_dir, payload):
    """`spawn_ranks` without waiting: starts the ranks and returns
    join() -> each rank's result, so the caller works meanwhile."""
    import torch
    import torch.multiprocessing as mp
    with open(os.path.join(tmp_dir, "payload.pt"), "wb") as f:
        torch.save(payload, f)
    ctx = mp.spawn(_rank_main, args=(world, str(tmp_dir), worker),
                   nprocs=world, join=False)

    def join():
        while not ctx.join():
            pass
        return [torch.load(os.path.join(tmp_dir, "rank%d.pt" % r),
                           weights_only=False) for r in range(world)]
    return join


def _rank_main(rank, world, tmp_dir, worker):
    import torch
    import torch.distributed as dist
    from mergenet_tpu_torch.parallel import make_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        payload = torch.load(os.path.join(tmp_dir, "payload.pt"),
                             weights_only=False)
        out = worker(make_mesh(device="cpu"), payload, tmp_dir)
        torch.save(out, os.path.join(tmp_dir, "rank%d.pt" % rank))
    finally:
        if dist.is_initialized():  # a recipe may have left the group
            dist.destroy_process_group()


def _state_arrays(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def train_ranks_worker(mesh, p, tmp_dir):
    """One rank of `tests/test_torch_port_parallel.py`: the port's
    unet_small steps over `mesh` from the payload's Flax variables
    (`build_train_step` for p["steps"] batches, then one
    `build_train_step_compact` step from the same start, each also fed
    this rank's shard with `local_batch=True`), the eval step through
    `validate(pad_to=2)` and on a shard, `shard_batch`, the checkpoint
    barriers (which ranks remove a stale file, what each rank loads),
    and last the train recipe under this process group (it leaves the
    group)."""
    import contextlib
    import io

    import torch
    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.models import get_model
    from mergenet_tpu_torch.parallel import shard_batch
    from mergenet_tpu_torch.parallel.mesh import local_slice
    from mergenet_tpu_torch.parallel import train as T
    from mergenet_tpu_torch.utils import checkpoint as CK
    from mergenet_tpu_torch.utils.train_utils import validate
    C, O, alpha = p["C"], p["O"], p["alpha"]

    def state():
        model = load_flax_weights(get_model(C, O, "unet_small"),
                                  p["params"], p["batch_stats"])
        tx = T.make_optimizer(lr=0.01)
        return T.TrainState(step=0, model=model,
                            optimizer=tx.init(model.parameters()), tx=tx)

    out = {"rank": mesh.rank, "world": mesh.world, "shape": mesh.shape,
           "shard": shard_batch({"img": p["batches"][0][0]}, mesh)[
               "img"].numpy()}
    s = state()
    step = T.build_train_step(C, O, alpha=alpha, mesh=mesh)
    out["losses"] = []
    for img, tg in p["batches"]:
        s, m = step(s, img, tg)
        out["losses"].append({k: float(v) for k, v in m.items()})
    out["after"] = _state_arrays(s.model)
    sc = state()
    step = T.build_train_step_compact(C, p["offsets"], alpha=alpha,
                                      mesh=mesh)
    sc, m = step(sc, *p["compact"])
    out["compact_loss"] = {k: float(v) for k, v in m.items()}
    out["compact_after"] = _state_arrays(sc.model)

    # the same steps fed this rank's shard only, as a sharded loader does
    def mine(x):
        return x[local_slice(len(x), mesh)]
    sl = state()
    step = T.build_train_step(C, O, alpha=alpha, mesh=mesh,
                              local_batch=True)
    for img, tg in p["batches"]:
        sl, _ = step(sl, mine(img), mine(tg))
    out["after_local"] = _state_arrays(sl.model)
    sl = state()
    step = T.build_train_step_compact(C, p["offsets"], alpha=alpha,
                                      mesh=mesh, local_batch=True)
    sl, _ = step(sl, *map(mine, p["compact"]))
    out["compact_after_local"] = _state_arrays(sl.model)

    evaluate = T.build_eval_step(C, O, alpha=alpha, mesh=mesh)
    img, tg = p["val"][0]
    probs, m = evaluate(s, img, tg)
    out["eval"] = (probs.numpy(), float(m["loss"]))
    probs, m = T.build_eval_step(C, O, alpha=alpha, mesh=mesh,
                                 local_batch=True)(s, mine(img), mine(tg))
    out["eval_local"] = (probs.numpy(), float(m["loss"]))
    out["val"] = validate(p["val"], s, evaluate, 2, 0, 0, num_classes=C,
                          offset_list=p["offsets"], score=True, pad_to=2,
                          print_freq=100)

    # checkpoints: a stale file first, then the barrier-fenced save
    exp = os.path.join(tmp_dir, "exp")
    if mesh.rank == 0:
        os.makedirs(exp, exist_ok=True)
        with open(os.path.join(exp, "checkpoint"), "w") as f:
            f.write("stale")
    torch.distributed.barrier()
    removed, remove = [], os.remove
    CK.os.remove = lambda path: (removed.append(path), remove(path))
    try:
        CK.save_checkpoint(exp, s, True, offsets=p["offsets"], epoch=1,
                           best_iou=0.5)
    finally:
        CK.os.remove = remove
    out["removed"] = removed
    fresh = state()
    fresh, meta = CK.load_checkpoint(os.path.join(exp, "model_best"), fresh)
    out["loaded"] = _state_arrays(fresh.model)
    out["loaded_step"], out["meta"] = fresh.step, meta

    # the train recipe as torchrun starts it: each rank loads its slice
    # (`--tensorboard`: which ranks configure the scalar log)
    from mergenet_tpu_torch.egs.cityscape import train as recipe
    from mergenet_tpu_torch.utils import logging as tb
    os.environ["WORLD_SIZE"] = str(mesh.world)
    out["recipe_logs"], out["recipe_batches"] = [], []
    tb.configure = out["recipe_logs"].append
    build = recipe.build_train_step_compact

    def recording(*args, **kwargs):  # the batch each step is given
        step = build(*args, **kwargs)

        def rec(state, image, *rest):
            out["recipe_batches"].append(len(image))
            return step(state, image, *rest)
        return rec
    recipe.build_train_step_compact = recording
    with contextlib.redirect_stdout(io.StringIO()):
        out["recipe_rc"] = recipe.main(p["recipe"] + [
            os.path.join(tmp_dir, "recipe"), "--tensorboard"])
    return out


def serve_ranks_worker(mesh, p, tmp_dir):
    """One rank of `tests/test_torch_port_parallel_serving.py`: the
    serving pipeline over `mesh` (and with the overflow fallback on
    frames only one rank overflows) and `build_sharded_forward`, on a
    UNet holding the payload's Flax variables."""
    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.models.unet import UNet
    from mergenet_tpu_torch.parallel.spatial import build_sharded_forward
    from mergenet_tpu_torch.serving import build_serving_pipeline
    out = {}
    for name, case in p["cases"].items():
        model = load_flax_weights(UNet(p["C"], len(p["offsets"]), depth=2,
                                       start_filts=8), *case["weights"])
        serve = build_serving_pipeline(
            model, p["C"], p["offsets"], decode_size=(16, 16),
            hier_kwargs=case["hier"], overflow_fallback=case["fallback"],
            mesh=mesh)
        out[name] = [t.numpy() for t in serve(case["imgs"])]
        if name == "plain":
            fwd = build_sharded_forward(model, mesh)
            out["forward"] = fwd(case["imgs"]).numpy()
    return out
