"""Training state and the train/eval steps (`mergenet_tpu.parallel.train`
is the reference).

  * `TrainState`: the model (parameters and batch-norm statistics), its
    `torch.optim.SGD` (the momentum buffers), the optimizer recipe and
    the update count.
  * `make_optimizer`: SGD with nesterov momentum and coupled weight
    decay on every parameter (batch-norm scale and bias included), and
    the reference's MultiStepLR(gamma=0.2), read at the update count as
    optax reads its schedule.
  * `build_train_step` / `build_train_step_compact` / `build_eval_step`:
    forward, the channel-split class + alpha * offset loss (plus
    aux_weight times the same loss on PSPNet's auxiliary logits),
    backward and update; the compact step takes uint8 images, instance
    masks and class tables and builds the normalised input and the
    (C + O)-plane targets on the device.  The train steps take the
    reference's dropout `rng` last: a `torch.Generator` on the state's
    device, which models with dropout need in train mode.

Steps run where the state lives (`create_train_state(device=None)`
means CUDA and raises without it).  Inputs may be numpy arrays or
tensors; metrics come back as 0-d tensors on that device, unsynced.

With a `mesh` (`parallel.mesh.make_mesh`; the state on the mesh's
device), every rank gets the same global batch and takes the slice of
its data index, or with `local_batch=True` gets only that slice (a
loader sharded by data index, `data.DataLoader(shard=...)`).  With a
spatial axis above 1 each rank of it runs the rows of its block of the
image height (`parallel/halo.py`), and the compact step builds its
targets from the whole masks of its slice, then keeps its rows.  Batch
norm takes the global batch's statistics, each rank's loss covers its
own output rows, the gradients are averaged over every rank in one
`all_reduce` of the flattened gradients (a fixed order), and the loss
metrics are the global means: the reference's GSPMD step.  Dropout
draws the global batch's masks.  The eval step gathers the
probabilities and per-sample vectors of the whole batch on every rank
(with `local_batch`, it returns those of this rank's data slice)."""

import contextlib
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..models import REMAT_BLOCKS, init_model
from ..models.layers import Dropout, SyncBatchNorm
from ..ops.losses import bce_with_logits_loss, weighted_bce_with_logits_loss
from ..ops.targets import mask_to_target
from .halo import as_rows, gather_rows, plain, rows_dim, spatial
from .mesh import all_gather_batch, all_reduce_, check_mesh, local_slice

#: criteria that are means of per-pixel terms: on a height shard each
#: rank takes its own rows' mean; any other criterion gets whole maps
ROW_MEANS = (bce_with_logits_loss, weighted_bce_with_logits_loss)


def multistep_lr(base_lr, milestones, gamma=0.2, steps_per_epoch=1):
    """MultiStepLR as optax's `piecewise_constant_schedule` reads it: the
    update numbered `count` (0-based) uses base_lr times gamma once for
    each milestone epoch m with count >= m * steps_per_epoch, multiplied
    in float32 as optax does.  Returns schedule(count) -> lr."""
    boundaries = sorted(int(m) * steps_per_epoch for m in milestones or ())

    def schedule(count):
        v = np.float32(base_lr)
        for b in boundaries:
            if count >= b:
                v = np.float32(np.float32(gamma) * v)
        return float(v)
    return schedule


@dataclasses.dataclass(frozen=True)
class SGD:
    """The optimizer recipe (optax's `add_decayed_weights` then nesterov
    `sgd`, which is `torch.optim.SGD`'s update): `init(params)` builds
    the torch optimizer, `schedule(count)` gives each update's lr."""
    schedule: Callable[[int], float]
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 1e-4

    def init(self, params):
        return torch.optim.SGD(params, lr=self.schedule(0),
                               momentum=self.momentum,
                               nesterov=self.nesterov,
                               weight_decay=self.weight_decay)


def make_optimizer(lr=0.01, momentum=0.9, nesterov=True, weight_decay=1e-4,
                   milestones=None, gamma=0.2, steps_per_epoch=1):
    """SGD + nesterov momentum + coupled weight decay (added to the
    gradient before the momentum update) + MultiStepLR."""
    return SGD(multistep_lr(lr, milestones, gamma, steps_per_epoch),
               momentum, nesterov, weight_decay)


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    tx: SGD

    @property
    def device(self):
        return next(self.model.parameters()).device

    def apply_gradients(self):
        """One optimizer update with the lr of update number `step`."""
        lr = self.tx.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model, tx, seed=0, device=None):
    """Initialise `model` as flax does (`models.init_model`, from
    `seed`), move it to `device` (None means CUDA) and build its
    optimizer."""
    model = init_model(model, seed).to(resolve_device(device))
    return TrainState(step=0, model=model,
                      optimizer=tx.init(model.parameters()), tx=tx)


def _check(mesh):
    return None if mesh is None else check_mesh(mesh)


def _on(x, device, mesh=None, local=False):
    """`x` on `device`; with a mesh, the slice of this rank's data index
    only (`x` itself when it is that slice: `local`)."""
    if mesh is not None and not local:
        x = x[local_slice(x.shape[0], mesh)]
    return torch.as_tensor(x, device=device)


@contextlib.contextmanager
def _global_stats(model, mesh):
    """The model's batch norms take the global batch's statistics over
    `mesh` during the step, and its dropouts draw the global batch's
    masks."""
    bns = [m for m in model.modules()
           if isinstance(m, (SyncBatchNorm, Dropout))]
    for m in bns:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in bns:
            m.mesh = None


def _average_gradients(model, mesh):
    """Each gradient replaced by its mean over the ranks: one all_reduce
    of the gradients flattened in parameter order."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh.axis("world"))
    flat /= mesh.world
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def _global_mean(metrics, mesh):
    """Scalar metrics averaged over the ranks (equal blocks, or whole
    maps alike on every rank of an axis: the mean of the ranks' means is
    the global mean)."""
    keys = sorted(metrics)
    v = torch.stack([metrics[k] for k in keys])
    all_reduce_(v, mesh.axis("world"))
    v /= mesh.world
    return dict(zip(keys, v.unbind()))


def _matched(outs, target, mesh, criteria):
    """(outs, target) for the loss: a height shard of the output with
    the target's same rows when every criterion is a mean of per-pixel
    terms, else the whole output (gathered; the target is whole)."""
    if mesh is None or rows_dim(outs) is None:
        return outs, target
    if all(c is None or getattr(c, "func", c) in ROW_MEANS
           for c in criteria):
        return outs, as_rows(target, mesh)
    return gather_rows(outs, mesh), target


def _split_loss(logits, targets, num_classes, num_offsets, alpha,
                criterion_cls, criterion_ofs):
    """Channel-split class/offset objective; either criterion may be
    None (class-only / offset-only training)."""
    cls_loss = ofs_loss = logits.new_zeros(())
    if criterion_cls is not None and num_classes > 0:
        cls_loss = criterion_cls(logits[..., :num_classes],
                                 targets[..., :num_classes])
    if criterion_ofs is not None and num_offsets > 0:
        ofs_loss = criterion_ofs(logits[..., num_classes:],
                                 targets[..., num_classes:])
    return cls_loss + alpha * ofs_loss, cls_loss, ofs_loss


def _replay(rng):
    """`torch.utils.checkpoint`'s `context_fn` for a step drawing dropout
    masks from `rng`: checkpoint restores torch's global generators for
    the recomputation, not this one, so the recomputation puts `rng`
    back to its state at the forward (the same masks, as under
    `jax.checkpoint`) and afterwards where it was."""
    saved = rng.get_state()

    @contextlib.contextmanager
    def recompute():
        now = rng.get_state()
        rng.set_state(saved)
        try:
            yield
        finally:
            rng.set_state(now)
    return contextlib.nullcontext(), recompute()


@contextlib.contextmanager
def _checkpointed(model, rng):
    """Run each of `model`'s REMAT_BLOCKS through `torch.utils.checkpoint`
    (its activations are recomputed in the backward, with the dropout
    masks of its forward)."""
    blocks = [m for m in model.modules() if isinstance(m, REMAT_BLOCKS)]
    kw = {} if rng is None else {"context_fn": functools.partial(_replay,
                                                                 rng)}
    for m in blocks:
        m.forward = functools.partial(checkpoint, m.forward,
                                      use_reentrant=False, **kw)
    try:
        yield
    finally:
        for m in blocks:
            del m.forward


@contextlib.contextmanager
def _dropout_rng(model, rng):
    """The model's dropouts draw from `rng` during the step."""
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    for m in drops:
        m.generator = rng
    try:
        yield
    finally:
        for m in drops:
            m.generator = None


@contextlib.contextmanager
def _stats_frozen(model):
    """Batch-norm running statistics fixed while the backward recomputes
    checkpointed forwards: the forward that counts is the first, as under
    `jax.checkpoint`."""
    bns = [m for m in model.modules() if isinstance(m, SyncBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


def _grad_step(state, img, target, rng, num_classes, num_offsets, alpha,
               criterion_cls, criterion_ofs, remat, aux_weight, mesh):
    """forward (train mode, dropout from `rng`), loss (with the aux
    head's when `aux_weight`), backward, update; returns (state,
    metrics).  With `mesh`, `img` and `target` are the slice of this
    rank's data index, whole in height."""
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    kwargs = {"with_aux": True} if aux_weight else {}
    criteria = (criterion_cls, criterion_ofs)
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(_dropout_rng(model, rng))
        if mesh is not None:
            ctx.enter_context(_global_stats(model, mesh))
            ctx.enter_context(spatial(mesh))
            img = as_rows(img, mesh)
        if remat:
            ctx.enter_context(_checkpointed(model, rng))
        outs = model(img, **kwargs)
        if aux_weight:
            outs, aux = outs
            aux, tg = _matched(aux, target, mesh, criteria)
            aux_l, _, _ = _split_loss(aux, tg, num_classes, num_offsets,
                                      alpha, criterion_cls, criterion_ofs)
        outs, target = _matched(outs, target, mesh, criteria)
        total, cls_l, ofs_l = _split_loss(outs, target, num_classes,
                                          num_offsets, alpha, criterion_cls,
                                          criterion_ofs)
        if aux_weight:
            total = total + aux_weight * aux_l
        with _stats_frozen(model) if remat else contextlib.nullcontext():
            total.backward()
    if mesh is not None:
        _average_gradients(model, mesh)
    state.apply_gradients()
    metrics = {"loss": total.detach(), "cls_loss": cls_l.detach(),
               "ofs_loss": ofs_l.detach()}
    if aux_weight:
        metrics["aux_loss"] = aux_l.detach()
    if mesh is not None:
        metrics = _global_mean(metrics, mesh)
    return state, metrics


def build_train_step(num_classes, num_offsets, alpha=1.0,
                     criterion_cls=bce_with_logits_loss,
                     criterion_ofs=bce_with_logits_loss,
                     mesh=None, remat=False, aux_weight=0.0,
                     local_batch=False):
    """Returns step(state, img, target, rng=None) -> (state, metrics).

    img: (N, H, W, 3) float; target: (N, H, W, C+O) float; rng: the
    dropout `torch.Generator` (on the state's device), required when
    the model has dropout.  `remat=True` recomputes each block's forward
    in the backward (`torch.utils.checkpoint`): activation memory for
    FLOPs.  `aux_weight > 0` adds deep supervision on the model's
    auxiliary head (PSPNet): the model is called `with_aux=True`, the
    same split loss on the aux logits is added with this weight, and
    the metrics carry it as `aux_loss`.  `mesh`: data parallelism over
    its ranks, and `local_batch`: the inputs are this rank's shard
    (module docstring)."""
    mesh = _check(mesh)

    def step(state, img, target, rng=None):
        dev = state.device
        return _grad_step(state, _on(img, dev, mesh, local_batch),
                          _on(target, dev, mesh, local_batch), rng,
                          num_classes, num_offsets, alpha, criterion_cls,
                          criterion_ofs, remat, aux_weight, mesh)
    return step


def build_train_step_compact(num_classes, offsets, alpha=1.0,
                             criterion_cls=bce_with_logits_loss,
                             criterion_ofs=bce_with_logits_loss,
                             mesh=None, remat=False, aux_weight=0.0,
                             local_batch=False):
    """Train step over compact batches:
    step(state, image_u8, mask, object_class, rng=None) -> (state,
    metrics).

    image_u8: (N, H, W, 3) uint8; mask: (N, H, W) integer instance ids;
    object_class: (N, K) integer class tables; rng as in
    `build_train_step`.  The /256 normalisation and the (C + O)-plane
    targets (`ops.targets.mask_to_target`) are computed on the state's
    device; `remat`, `aux_weight`, `mesh` and `local_batch` as in
    `build_train_step`."""
    mesh = _check(mesh)
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)

    def step(state, image_u8, mask, object_class, rng=None):
        dev = state.device
        img = _on(image_u8, dev, mesh, local_batch).float() / 256.0
        target = mask_to_target(_on(mask, dev, mesh, local_batch),
                                _on(object_class, dev, mesh, local_batch),
                                num_classes, offsets)
        return _grad_step(state, img, target, rng, num_classes,
                          len(offsets), alpha, criterion_cls, criterion_ofs,
                          remat, aux_weight, mesh)
    return step


def build_eval_step(num_classes, num_offsets, alpha=1.0,
                    criterion_cls=bce_with_logits_loss,
                    criterion_ofs=bce_with_logits_loss, mesh=None,
                    local_batch=False):
    """Returns eval(state, img, target) -> (sigmoid_probs, metrics), with
    the model in eval mode.  metrics carries batch-mean scalars and
    per-sample (B,) vectors (`per_sample_*`, the criterion on each row)
    so callers that pad partial batches count real rows only.  With
    `mesh`, each rank evaluates its block and every rank gets the whole
    batch's probabilities and metrics; with `local_batch` as well, the
    inputs are the slice of this rank's data index and the
    probabilities and per-sample vectors are that slice's (the scalars
    still the global means)."""
    mesh = _check(mesh)
    loss = functools.partial(_split_loss, num_classes=num_classes,
                             num_offsets=num_offsets, alpha=alpha,
                             criterion_cls=criterion_cls,
                             criterion_ofs=criterion_ofs)

    @torch.no_grad()
    def step(state, img, target):
        dev = state.device
        target = _on(target, dev, mesh, local_batch)
        img = _on(img, dev, mesh, local_batch)
        with spatial(mesh):
            if mesh is not None:
                img = as_rows(img, mesh)
            outs = state.model.eval()(img)
        outs, target = _matched(outs, target, mesh,
                                (criterion_cls, criterion_ofs))
        total, cls_l, ofs_l = loss(outs, target)
        per_tot, per_cls, per_ofs = (torch.stack(v) for v in zip(
            *(loss(o, t) for o, t in zip(outs, target))))
        probs = torch.sigmoid(outs)
        scalars = {"loss": total, "cls_loss": cls_l, "ofs_loss": ofs_l}
        rows = {"per_sample_loss": per_tot, "per_sample_cls": per_cls,
                "per_sample_ofs": per_ofs}
        if mesh is None:
            return probs, {**scalars, **rows}
        scalars = _global_mean(scalars, mesh)
        # a sample's loss: the mean of its equal row blocks' means
        S = mesh.shape["spatial"]
        rows = {k: all_reduce_(v, mesh.axis("spatial")) / S
                for k, v in rows.items()}
        if local_batch:
            probs = plain(gather_rows(probs, mesh))
        else:
            rows = {k: all_gather_batch(v, mesh) for k, v in rows.items()}
            probs = all_gather_batch(probs, mesh)
        return probs, {**scalars, **rows}
    return step
