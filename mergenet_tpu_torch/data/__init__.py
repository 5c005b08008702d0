"""Evaluation data of the port (`mergenet_tpu.data` is the reference):
the COCO json API, RLE masks and mask-AP.  The dataset classes come with
the data slice."""

from .coco import COCO

__all__ = ["COCO"]
