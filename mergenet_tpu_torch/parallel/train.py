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
    forward, the channel-split class + alpha * offset loss, backward and
    update; the compact step takes uint8 images, instance masks and
    class tables and builds the normalised input and the (C + O)-plane
    targets on the device.

Steps run where the state lives (`create_train_state(device=None)`
means CUDA and raises without it).  Inputs may be numpy arrays or
tensors; metrics come back as 0-d tensors on that device, unsynced."""

import contextlib
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..models import REMAT_BLOCKS, init_model
from ..models.layers import SyncBatchNorm
from ..ops.losses import bce_with_logits_loss
from ..ops.targets import mask_to_target


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


def _check_unported(mesh, aux_weight):
    if mesh is not None:
        raise NotImplementedError("data-parallel steps (mesh) wait for "
                                  "ROADMAP.md queue 1, item 8")
    if aux_weight:
        raise NotImplementedError("aux_weight needs PSPNet's aux head, "
                                  "which waits for ROADMAP.md queue 1, "
                                  "item 5")


def _on(x, device):
    return torch.as_tensor(x, device=device)


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


@contextlib.contextmanager
def _checkpointed(model):
    """Run each of `model`'s REMAT_BLOCKS through `torch.utils.checkpoint`
    (its activations are recomputed in the backward)."""
    blocks = [m for m in model.modules() if isinstance(m, REMAT_BLOCKS)]
    for m in blocks:
        m.forward = functools.partial(checkpoint, m.forward,
                                      use_reentrant=False)
    try:
        yield
    finally:
        for m in blocks:
            del m.forward


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


def _grad_step(state, img, target, num_classes, num_offsets, alpha,
               criterion_cls, criterion_ofs, remat):
    """forward (train mode), loss, backward, update; returns (state,
    metrics)."""
    model = state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    with _checkpointed(model) if remat else contextlib.nullcontext():
        outs = model(img)
    total, cls_l, ofs_l = _split_loss(outs, target, num_classes,
                                      num_offsets, alpha, criterion_cls,
                                      criterion_ofs)
    with _stats_frozen(model) if remat else contextlib.nullcontext():
        total.backward()
    state.apply_gradients()
    return state, {"loss": total.detach(), "cls_loss": cls_l.detach(),
                   "ofs_loss": ofs_l.detach()}


def build_train_step(num_classes, num_offsets, alpha=1.0,
                     criterion_cls=bce_with_logits_loss,
                     criterion_ofs=bce_with_logits_loss,
                     mesh=None, remat=False, aux_weight=0.0):
    """Returns step(state, img, target) -> (state, metrics).

    img: (N, H, W, 3) float; target: (N, H, W, C+O) float.  `remat=True`
    recomputes each block's forward in the backward
    (`torch.utils.checkpoint`): activation memory for FLOPs."""
    _check_unported(mesh, aux_weight)

    def step(state, img, target):
        dev = state.device
        return _grad_step(state, _on(img, dev), _on(target, dev),
                          num_classes, num_offsets, alpha, criterion_cls,
                          criterion_ofs, remat)
    return step


def build_train_step_compact(num_classes, offsets, alpha=1.0,
                             criterion_cls=bce_with_logits_loss,
                             criterion_ofs=bce_with_logits_loss,
                             mesh=None, remat=False, aux_weight=0.0):
    """Train step over compact batches:
    step(state, image_u8, mask, object_class) -> (state, metrics).

    image_u8: (N, H, W, 3) uint8; mask: (N, H, W) integer instance ids;
    object_class: (N, K) integer class tables.  The /256 normalisation
    and the (C + O)-plane targets (`ops.targets.mask_to_target`) are
    computed on the state's device."""
    _check_unported(mesh, aux_weight)
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)

    def step(state, image_u8, mask, object_class):
        dev = state.device
        img = _on(image_u8, dev).float() / 256.0
        target = mask_to_target(_on(mask, dev), _on(object_class, dev),
                                num_classes, offsets)
        return _grad_step(state, img, target, num_classes, len(offsets),
                          alpha, criterion_cls, criterion_ofs, remat)
    return step


def build_eval_step(num_classes, num_offsets, alpha=1.0,
                    criterion_cls=bce_with_logits_loss,
                    criterion_ofs=bce_with_logits_loss, mesh=None):
    """Returns eval(state, img, target) -> (sigmoid_probs, metrics), with
    the model in eval mode.  metrics carries batch-mean scalars and
    per-sample (B,) vectors (`per_sample_*`, the criterion on each row)
    so callers that pad partial batches count real rows only."""
    _check_unported(mesh, 0.0)
    loss = functools.partial(_split_loss, num_classes=num_classes,
                             num_offsets=num_offsets, alpha=alpha,
                             criterion_cls=criterion_cls,
                             criterion_ofs=criterion_ofs)

    @torch.no_grad()
    def step(state, img, target):
        dev = state.device
        target = _on(target, dev)
        outs = state.model.eval()(_on(img, dev))
        total, cls_l, ofs_l = loss(outs, target)
        per_tot, per_cls, per_ofs = (torch.stack(v) for v in zip(
            *(loss(o, t) for o, t in zip(outs, target))))
        return torch.sigmoid(outs), {
            "loss": total, "cls_loss": cls_l, "ofs_loss": ofs_l,
            "per_sample_loss": per_tot, "per_sample_cls": per_cls,
            "per_sample_ofs": per_ofs}
    return step
