"""One rank of `tests/test_torch_port_spatial.py` (4 gloo ranks of the
CPU, started by `torch_port_helpers.spawn_ranks`).  Imports the port
only, not JAX: the JAX side runs in the test process."""

import numpy as np
import torch

from torch_port_helpers import _state_arrays


class _Scatter(torch.autograd.Function):
    """A whole tensor (the same on every rank) -> this rank's rows; the
    backward gathers every rank's row gradients into the whole one (the
    adjoint for an input that every rank holds and perturbs alike)."""

    @staticmethod
    def forward(ctx, x, spc):
        ctx.spc = spc
        return spc.out(x).as_subclass(torch.Tensor).clone()

    @staticmethod
    def backward(ctx, g):
        from mergenet_tpu_torch.parallel import mesh as M
        return torch.cat(M.all_gather(g, ctx.spc.axis), 2), None


class _Shared(torch.autograd.Function):
    """A parameter every rank holds: identity; its gradient is the sum of
    the ranks' parts (what the train step's all-reduce does)."""

    @staticmethod
    def forward(ctx, w, axis):
        ctx.axis = axis
        return w.clone()

    @staticmethod
    def backward(ctx, g):
        from mergenet_tpu_torch.parallel import mesh as M
        return M.all_reduce_(g.contiguous().clone(), ctx.axis), None


class _ToPartial(torch.autograd.Function):
    """A whole output that every rank holds: identity; each rank's
    gradient is 1/S of the one given (the ranks' parts sum to it)."""

    @staticmethod
    def forward(ctx, y, n):
        ctx.n = n
        return y.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def halo_cases():
    """(name, k, fill, fn(spc, x, w) on rows, ref(x, w) on the whole)."""
    import torch.nn.functional as F

    def conv(stride, pad, dil):
        return (lambda spc, x, w: spc.conv(x, w, None, (stride, stride),
                                           (pad, pad), (dil, dil)),
                lambda x, w: F.conv2d(x, w, None, stride, pad, dil))

    def pool(k, stride, pad):
        return (lambda spc, x, w: spc.max_pool(x, k, stride, pad) * w.sum(),
                lambda x, w: F.max_pool2d(x, k, stride, pad) * w.sum())

    def up2():
        return (lambda spc, x, w: spc.resize(x, (2 * spc.height(x), 10),
                                             False) * w.sum(),
                lambda x, w: F.interpolate(x, (2 * x.shape[2], 10),
                                           mode="bilinear",
                                           align_corners=False) * w.sum())
    return [("conv3", 3, *conv(1, 1, 1)), ("conv3_s2", 3, *conv(2, 1, 1)),
            ("conv3_dil2", 3, *conv(1, 2, 2)), ("conv3_dil4", 3,
                                                 *conv(1, 4, 4)),
            ("conv3_dil8", 3, *conv(1, 8, 8)),
            ("conv5_s2_p1", 5, *conv(2, 1, 1)),
            ("conv7_s2", 7, *conv(2, 3, 1)), ("conv1_s2", 1, *conv(2, 0, 1)),
            ("maxpool3_s2", 1, *pool(3, 2, 1)), ("maxpool2", 1,
                                                  *pool(2, 2, 0)),
            ("upsample2", 1, *up2())]


def _halo_unit(mesh, p):
    """Each case's forward and gradients on the rows of a 4-way axis
    against the whole op, in float64, and `gradcheck` (fast mode) of
    the sharded op as one function of the whole input (every rank
    perturbs it alike)."""
    from mergenet_tpu_torch.parallel import halo
    from mergenet_tpu_torch.parallel.mesh import all_gather
    spc = halo.SpatialContext(mesh)
    axis = mesh.axis("spatial")
    out = {}
    for name, k, fn, ref in halo_cases():
        x = torch.tensor(p["halo_x"])
        w = torch.tensor(p["halo_w"][:, :, :k, :k]).contiguous()
        xr = spc.out(x.clone()).detach().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        y = fn(spc, xr, _Shared.apply(wr, axis))
        yw = halo.gather(y, axis) if halo.rows_dim(y) is not None else y
        gy = torch.tensor(p["halo_gy"][:, :, :yw.shape[2], :yw.shape[3]])
        # each rank's loss covers its own rows of the output
        (halo.plain(y) * spc.out(gy).as_subclass(torch.Tensor)
         if halo.rows_dim(y) is not None else y * gy / spc.S).sum() \
            .backward()
        xw = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        yref = ref(xw, ww)
        (yref * gy).sum().backward()
        gx = torch.cat(all_gather(xr.grad, axis), 2)
        out[name] = dict(
            out=float((yw - yref).abs().max()),
            dx=float((gx - xw.grad).abs().max()),
            dw=float((wr.grad - ww.grad).abs().max()),
            sharded=halo.rows_dim(y) is not None,
            finite=bool(torch.isfinite(yw).all()))
        xs = x[:, :, :, :3].clone().requires_grad_(True)
        ws = w[:1, :, :, :].clone().requires_grad_(True)

        def whole(xa, wa):
            rows = _Scatter.apply(xa, spc)
            if halo.rows_dim(spc.out(xa)) is not None:
                rows = halo.tag(rows)
            yy = fn(spc, rows, _Shared.apply(wa, axis))
            if halo.rows_dim(yy) is not None:
                yy = halo.gather(yy, axis)
            return _ToPartial.apply(halo.plain(yy), spc.S)
        # fast mode: one random projection of the Jacobian each way,
        # drawn alike on every rank (they run in lockstep)
        torch.manual_seed(len(out))
        out[name]["gradcheck"] = bool(torch.autograd.gradcheck(
            whole, (xs, ws), eps=1e-6, atol=1e-7, rtol=1e-5,
            fast_mode=True))
    # the exchange alone: the rows each rank gets, zero and -inf beyond
    # the image
    x = torch.tensor(p["halo_x"])
    rows = halo.plain(spc.out(x.clone()))
    for fill in (0.0, float("-inf")):
        ext = halo.halo(rows, axis, [2] * spc.S, [1] * spc.S, fill)
        s, h = spc.s, rows.shape[2]
        pad = torch.nn.functional.pad(x, (0, 0, 2, 1), value=fill)
        out["exchange_%s" % fill] = bool(torch.equal(
            ext, pad[:, :, s * h:s * h + h + 3]))
    return out


def spatial_ranks_worker(_, p, tmp_dir):
    """Every port-side case of the spatial tests on this rank, each on
    its own mesh: (a) the UNet forward on (2, 2, 1), (b) PSPFPNet-r50 on
    (1, 4, 1), (c) unet_small's train steps and (e) `validate` on
    (2, 2, 1), (d) PSPNet's aux steps with dropout on (1, 2, 2), (f)
    serving and the sharded forward on (1, 2, 2), (g) the halo unit
    cases on (1, 4, 1)."""
    from mergenet_tpu_torch.convert import load_flax_weights
    from mergenet_tpu_torch.models import PSPFPNet, PSPNet, get_model
    from mergenet_tpu_torch.models.unet import UNet
    from mergenet_tpu_torch.parallel import make_mesh
    from mergenet_tpu_torch.parallel import train as T
    from mergenet_tpu_torch.parallel.spatial import build_sharded_forward
    from mergenet_tpu_torch.serving import build_serving_pipeline
    from mergenet_tpu_torch.utils.train_utils import validate

    m221 = make_mesh(2, 2, 1, device="cpu")
    m122 = make_mesh(1, 2, 2, device="cpu")
    m141 = make_mesh(1, 4, 1, device="cpu")
    out = {"coords": (m221.coords, m122.coords, m141.coords),
           "shapes": (m221.shape, m122.shape, m141.shape)}

    unet = load_flax_weights(UNet(3, 2, depth=2, start_filts=8), *p["unet"])
    out["a"] = build_sharded_forward(unet, m221)(p["imgs_a"]).numpy()
    out["f_forward"] = build_sharded_forward(unet, m122)(
        p["imgs_a"]).numpy()
    psp = load_flax_weights(PSPFPNet(5, layer=50, fpn_dim=32), *p["psp"])
    out["b"] = build_sharded_forward(psp, m141)(p["imgs_b"]).numpy()

    C, O, alpha = 3, 2, 2.0

    def state(model, weights):
        model = load_flax_weights(model, *weights)
        tx = T.make_optimizer(lr=0.01)
        return T.TrainState(step=0, model=model,
                            optimizer=tx.init(model.parameters()), tx=tx)
    s = state(get_model(C, O, "unet_small"), p["small"])
    step = T.build_train_step(C, O, alpha=alpha, mesh=m221)
    out["losses"] = []
    for img, tg in p["batches"]:
        s, m = step(s, img, tg)
        out["losses"].append({k: float(v) for k, v in m.items()})
    out["after"] = _state_arrays(s.model)
    evaluate = T.build_eval_step(C, O, alpha=alpha, mesh=m221)
    out["val"] = validate(p["val"], s, evaluate, 2, 0, 0, num_classes=C,
                          offset_list=p["offsets"], score=True, pad_to=2,
                          print_freq=100)
    probs, m = evaluate(s, *p["val"][0])
    out["eval"] = (probs.numpy(), {k: v.numpy() for k, v in m.items()})
    sc = state(get_model(C, O, "unet_small"), p["small"])
    cstep = T.build_train_step_compact(C, p["offsets"], alpha=alpha,
                                       mesh=m221)
    sc, m = cstep(sc, *p["compact"])
    out["compact_loss"] = {k: float(v) for k, v in m.items()}
    out["compact_after"] = _state_arrays(sc.model)

    sa = state(PSPNet(p["aux_nout"], layer=18), p["aux"])
    astep = T.build_train_step_compact(
        p["aux_C"], p["aux_offsets"], alpha=20.0, aux_weight=0.4, remat=True,
        mesh=m122)
    gen = torch.Generator().manual_seed(p["aux_seed"])
    sa, m = astep(sa, *p["aux_batch"], gen)
    out["aux_loss"] = {k: float(v) for k, v in m.items()}
    out["aux_after"] = _state_arrays(sa.model)

    serve = build_serving_pipeline(unet, 3, p["offsets"],
                                   decode_size=(16, 16),
                                   hier_kwargs=p["hier"],
                                   overflow_fallback=True, mesh=m122)
    out["f_serve"] = [t.numpy() for t in serve(p["imgs_serve"])]

    out["g"] = _halo_unit(m141, p)
    return out
