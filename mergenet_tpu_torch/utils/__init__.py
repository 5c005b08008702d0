"""Utilities of the port (`mergenet_tpu.utils` is the reference): the
epoch loops, checkpoints and scalar logging, the inference loops, the
weight importers (`weight_import`, `caffe_import`) and profiling."""

from ..ops.metrics import offsetIoU, runningScore
from .inference_utils import class_inference, offset_inference, save
from .train_utils import (AverageMeter, generate_offsets, sample,
                          save_checkpoint, train, train_compact, validate)

__all__ = ["train", "train_compact", "validate", "sample",
           "save_checkpoint", "AverageMeter", "generate_offsets",
           "class_inference", "offset_inference", "save",
           "runningScore", "offsetIoU"]
