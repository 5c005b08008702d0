"""Training utilities of the port (`mergenet_tpu.utils` is the
reference): the epoch loops, checkpoints and scalar logging."""

from ..ops.metrics import offsetIoU, runningScore
from .train_utils import (AverageMeter, generate_offsets, sample,
                          save_checkpoint, train, train_compact, validate)

__all__ = ["train", "train_compact", "validate", "sample",
           "save_checkpoint", "AverageMeter", "generate_offsets",
           "runningScore", "offsetIoU"]
