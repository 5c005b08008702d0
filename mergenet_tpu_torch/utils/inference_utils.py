"""Inference loops (`mergenet_tpu.utils.inference_utils` is the
reference): run the class or offset head over a dataset and persist
per-image probability maps as `<id>.{class,offset}.npy`, in the
reference's channel-first (C, H, W) float32 layout, so that the decode
stages read them as they read the reference's.

The loader is any iterable of `(ids, imgs[, targets])` batches (numpy
arrays or tensors, images (N, H, W, 3) NHWC float); the images move to
the state's device, where the model runs in eval mode."""

import os
import time

import numpy as np
import torch

from ..ops.metrics import offsetIoU, runningScore
from .train_utils import AverageMeter


def _forward_sigmoid(state):
    @torch.no_grad()
    def f(img):
        return torch.sigmoid(state.model.eval()(img).float())
    return f


def _run(dataloader, state, fwd, planes, outdir, suffix, metrics,
         print_freq):
    """The loop both heads share: forward each batch, score `planes` of
    it against the targets when `metrics` is given, save `planes`."""
    batch_time = AverageMeter()
    os.makedirs(outdir, exist_ok=True)
    end = time.time()
    num_batches = len(dataloader) if hasattr(dataloader, "__len__") else 0
    for i, vals in enumerate(dataloader):
        image_ids = np.asarray(vals[0])
        output = fwd(torch.as_tensor(vals[1], device=state.device))
        if metrics is not None:
            metrics.update(output[..., planes],
                           torch.as_tensor(vals[2])[..., planes])
        output = output[..., planes].cpu().numpy()
        for k, image_id in enumerate(image_ids):
            save(output[k], outdir, str(image_id), suffix=suffix)
        batch_time.update(time.time() - end)
        end = time.time()
        if i % print_freq == 0:
            print("Val: [{0}/{1}]\t"
                  "Time {bt.val:.3f} ({bt.avg:.3f})\t".format(
                      i, num_batches, bt=batch_time))
            if metrics is not None:
                metrics.print_stat()
    if metrics is not None:
        metrics.print_stat()


def class_inference(dataloader, exp_dir, state, n_classes, batch_size,
                    print_freq=10, score=False, class_nms=None,
                    tile_predict_fn=None):
    """Run class-head inference; writes `<exp_dir>/npy/<id>.class.npy`
    (the first `n_classes` planes).  `tile_predict_fn(img) -> probs`,
    when given, replaces the plain sigmoid forward (the full-resolution
    sliding-window path, `models.tile_predict`); it gets the batch on
    the state's device.  `score=True` prints `runningScore` over the
    loader's targets."""
    fwd = tile_predict_fn if tile_predict_fn is not None \
        else _forward_sigmoid(state)
    metrics = runningScore(n_classes, class_nms) if score else None
    _run(dataloader, state, fwd, slice(None, n_classes),
         "{}/npy".format(exp_dir), "class", metrics, print_freq)


def offset_inference(dataloader, exp_dir, state, offset_list, batch_size,
                     print_freq=10, score=False):
    """Run offset-head inference; writes `<exp_dir>/npy/<id>.offset.npy`
    (the last len(offset_list) planes); `score=True` prints
    `offsetIoU`."""
    n_offsets = len(offset_list)
    metrics = offsetIoU(offset_list) if score else None
    _run(dataloader, state, _forward_sigmoid(state),
         slice(-n_offsets, None), "{}/npy".format(exp_dir), "offset",
         metrics, print_freq)


def save(pred, outdir, name, suffix="class"):
    """Persist one image's probability planes as
    `<outdir>/<name>.<suffix>.npy` in the reference's channel-first
    (C, H, W) float32 layout; `pred` is (H, W, C)."""
    arr = np.asarray(pred, dtype=np.float32)
    if arr.ndim == 3:  # NHWC slice (H, W, C) -> (C, H, W)
        arr = np.moveaxis(arr, -1, 0)
    np.save(outdir + "/" + name + "." + suffix + ".npy", arr)
