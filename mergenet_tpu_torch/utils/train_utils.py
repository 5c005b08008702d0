"""Epoch-level training and validation loops
(`mergenet_tpu.utils.train_utils` is the reference).

The (state, step_fn) convention of the reference: steps come from
`parallel.build_train_step(_compact)` / `build_eval_step` and close over
the losses.  Loaders yield numpy (img, target) batches in NHWC, (N, H,
W, 3) / (N, H, W, C+O) float32, or compact dicts for `train_compact`."""

import os
import time

import numpy as np

from .. import io
from ..core.offsets import generate_offsets  # noqa: F401 (reference home)
from ..ops.metrics import offsetIoU, runningScore
from . import logging as tb
from .checkpoint import save_checkpoint as _save_ckpt

__all__ = ["train", "train_compact", "validate", "sample",
           "save_checkpoint", "AverageMeter", "generate_offsets"]


class AverageMeter(object):
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def train(trainloader, state, train_step, batch_size, epoch, iterations,
          num_classes=0, class_nms=None, offset_list=None,
          print_freq=10, log_freq=1000, tensorboard=False, score=False,
          eval_step=None, lr_for_log=None):
    """Train for one epoch; returns (state, iterations).

    `train_step(state, img, target) -> (state, metrics)` is the step from
    `build_train_step`.  With `score=True`, `eval_step` (from
    `build_eval_step`) scores IoU on the training batches after each
    update."""
    with_class = num_classes > 0
    with_offset = offset_list is not None and len(offset_list) > 0
    cls_losses, ofs_losses = AverageMeter(), AverageMeter()
    all_losses, batch_time = AverageMeter(), AverageMeter()
    if score and with_class:
        score_metrics = runningScore(num_classes, class_nms)
    if score and with_offset:
        offset_metrics = offsetIoU(offset_list)
    if tensorboard and lr_for_log is not None:
        tb.log_value("learning_rate", lr_for_log, epoch)

    end = time.time()
    num_batches = len(trainloader) if hasattr(trainloader, "__len__") else 0
    for i, (img, target) in enumerate(trainloader):
        state, metrics = train_step(state, img, target)
        iterations += 1

        if score and (with_class or with_offset) and eval_step is not None:
            probs, _ = eval_step(state, img, target)
            if with_class:
                score_metrics.update(probs[..., :num_classes],
                                     target[..., :num_classes])
            if with_offset:
                offset_metrics.update(probs[..., num_classes:],
                                      target[..., num_classes:])

        # meters (the host waits for the device here, once per step)
        all_losses.update(float(metrics["loss"]), batch_size)
        if with_class:
            cls_losses.update(float(metrics["cls_loss"]), batch_size)
        if with_offset:
            ofs_losses.update(float(metrics["ofs_loss"]), batch_size)
        batch_time.update(time.time() - end)
        end = time.time()

        if i % print_freq == 0:
            print("Train: [{0}][{1}/{2}]\t"
                  "Time {bt.val:.3f} ({bt.avg:.3f})\t"
                  "Loss {loss.val:.4f} ({loss.avg:.4f})".format(
                      epoch, i, num_batches, bt=batch_time,
                      loss=all_losses))
        if tensorboard and iterations % log_freq == 0:
            if with_class:
                tb.log_value("train_cls_loss", cls_losses.avg,
                             int(iterations / log_freq))
            if with_offset:
                tb.log_value("train_ofs_loss", ofs_losses.avg,
                             int(iterations / log_freq))

    if score and with_class:
        scores, _ = score_metrics.get_scores()
        if tensorboard:
            tb.log_value("train_iou", scores["mean_IU"], epoch)
        score_metrics.print_stat()
    if score and with_offset:
        iou, mean_iou = offset_metrics.get_scores()
        if tensorboard:
            tb.log_value("train_ofs_miou", mean_iou, epoch)
        offset_metrics.print_stat()

    return state, iterations


def train_compact(batches, state, train_step, batch_size, epoch,
                  iterations, print_freq=10, log_freq=1000,
                  tensorboard=False):
    """Train one epoch over compact batches (dicts of `image` uint8,
    `mask` and `object_class` integers) with `build_train_step_compact`,
    which normalises and builds the (C + O)-plane targets on the device.
    Returns (state, iterations)."""
    all_losses, batch_time = AverageMeter(), AverageMeter()
    cls_losses, ofs_losses = AverageMeter(), AverageMeter()
    end = time.time()
    for i, batch in enumerate(batches):
        state, metrics = train_step(state, batch["image"], batch["mask"],
                                    batch["object_class"])
        iterations += 1
        all_losses.update(float(metrics["loss"]), batch_size)
        cls_losses.update(float(metrics["cls_loss"]), batch_size)
        ofs_losses.update(float(metrics["ofs_loss"]), batch_size)
        batch_time.update(time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            print("Train(compact): [{0}][{1}]\t"
                  "Time {bt.val:.3f} ({bt.avg:.3f})\t"
                  "Loss {loss.val:.4f} ({loss.avg:.4f})".format(
                      epoch, i, bt=batch_time, loss=all_losses))
        if tensorboard and iterations % log_freq == 0:
            tb.log_value("train_cls_loss", cls_losses.avg,
                         int(iterations / log_freq))
            tb.log_value("train_ofs_loss", ofs_losses.avg,
                         int(iterations / log_freq))
    return state, iterations


def _pad_batch(arr, multiple):
    """Pad the batch dim up to a multiple by repeating the last sample;
    returns (padded, n_real)."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    a = np.asarray(arr)
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)], 0), n


def validate(validateloader, state, eval_step, batch_size, epoch, iterations,
             num_classes=0, class_nms=None, offset_list=None,
             print_freq=10, log_freq=1000, tensorboard=False, score=False,
             pad_to=1):
    """Validate; returns the model-selection signal: class mean IoU plus
    offset mean IoU when both heads are scored (score=True), else
    -avg_loss (still 'higher is better').

    `pad_to` pads partial batches by repeating the last sample; the
    score metrics and the loss meters count only the real rows (the
    loss through the eval step's `per_sample_*` vectors)."""
    with_class = num_classes > 0
    with_offset = offset_list is not None and len(offset_list) > 0
    cls_losses, ofs_losses = AverageMeter(), AverageMeter()
    all_losses, batch_time = AverageMeter(), AverageMeter()
    if score and with_class:
        score_metrics = runningScore(num_classes, class_nms)
    if score and with_offset:
        offset_metrics = offsetIoU(offset_list)

    end = time.time()
    num_batches = len(validateloader) if hasattr(validateloader, "__len__") \
        else 0
    for i, batch in enumerate(validateloader):
        img, target = batch[-2], batch[-1]  # tolerate (id, img, target)
        if pad_to > 1:
            img, n_real = _pad_batch(img, pad_to)
            target, _ = _pad_batch(target, pad_to)
        else:
            n_real = img.shape[0]
        probs, metrics = eval_step(state, img, target)

        def _real_mean(key):
            return float(metrics[key][:n_real].double().mean())
        all_losses.update(_real_mean("per_sample_loss"), n_real)
        if with_class:
            cls_losses.update(_real_mean("per_sample_cls"), n_real)
        if with_offset:
            ofs_losses.update(_real_mean("per_sample_ofs"), n_real)
        if score and with_class:
            score_metrics.update(probs[:n_real, ..., :num_classes],
                                 target[:n_real, ..., :num_classes])
        if score and with_offset:
            offset_metrics.update(probs[:n_real, ..., num_classes:],
                                  target[:n_real, ..., num_classes:])
        batch_time.update(time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            print("Val: [{0}][{1}/{2}]\t"
                  "Time {bt.val:.3f} ({bt.avg:.3f})\t"
                  "Loss {loss.val:.4f} ({loss.avg:.4f})".format(
                      epoch, i, num_batches, bt=batch_time,
                      loss=all_losses))

    if tensorboard:
        if with_class:
            tb.log_value("val_cls_loss", cls_losses.avg,
                         int(max(iterations, 1) / log_freq))
        if with_offset:
            tb.log_value("val_ofs_loss", ofs_losses.avg,
                         int(max(iterations, 1) / log_freq))

    mean_cls_iou = mean_ofs_iou = None
    if score and with_class:
        scores, _ = score_metrics.get_scores()
        mean_cls_iou = scores["mean_IU"]
        if tensorboard:
            tb.log_value("val_iou", mean_cls_iou, epoch)
        score_metrics.print_stat()
    if score and with_offset:
        _, mean_ofs_iou = offset_metrics.get_scores()
        if tensorboard:
            tb.log_value("val_ofs_miou", mean_ofs_iou, epoch)
        offset_metrics.print_stat()

    if mean_cls_iou is not None and mean_ofs_iou is not None:
        return mean_cls_iou + mean_ofs_iou
    if mean_cls_iou is not None:
        return mean_cls_iou
    if mean_ofs_iou is not None:
        return mean_ofs_iou
    return -all_losses.avg


def _save_plane_png(path, plane):
    """Write a [0, 1] float (H, W) plane, or an (H, W, 3) image, as an
    8-bit PNG (grayscale or RGB)."""
    arr = np.clip(np.asarray(plane), 0.0, 1.0)
    io.write_png(path, (arr * 255).astype(np.uint8))


def sample(state, eval_step, dataloader, outdir, n_classes, n_offsets,
           pad_to=1):
    """Dump one batch's first image, its target planes and the sigmoid
    predictions as PNGs for eyeballing.  The raw image is written as
    RGB (the reference's cv2 writer stores the channels swapped)."""
    os.makedirs(outdir, exist_ok=True)
    batch = next(iter(dataloader))
    img, target = batch[-2], batch[-1]
    if pad_to > 1:
        img, _ = _pad_batch(img, pad_to)
        target, _ = _pad_batch(target, pad_to)
    img, target = np.asarray(img), np.asarray(target)
    _save_plane_png("{0}/raw.png".format(outdir), img[0])
    for i in range(n_classes):
        _save_plane_png("{0}/class_{1}.png".format(outdir, i),
                        target[0, :, :, i])
    for i in range(n_offsets):
        _save_plane_png("{0}/bound_{1}.png".format(outdir, i),
                        target[0, :, :, n_classes + i])
    probs, _ = eval_step(state, img, target)
    probs = probs.cpu().numpy()
    for i in range(n_classes):
        _save_plane_png("{0}/class_{1}pred.png".format(outdir, i),
                        probs[0, :, :, i])
    for i in range(n_offsets):
        _save_plane_png("{0}/bound_{1}pred.png".format(outdir, i),
                        probs[0, :, :, n_classes + i])


def save_checkpoint(dir, state, is_best, filename="checkpoint", **meta):
    """`utils.checkpoint.save_checkpoint` under the reference's call
    shape save_checkpoint(dir, state, is_best)."""
    _save_ckpt(dir, state, is_best, filename=filename, **meta)
