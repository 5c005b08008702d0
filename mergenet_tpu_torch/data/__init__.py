"""Data of the port (`mergenet_tpu.data` is the reference): the COCO json
API, RLE masks and mask-AP, the datasets and loaders, the compact
training pipeline (`pipeline.py`, the counterpart of the reference's
grain pipeline), the synthetic generator and cv2's image operations in
numpy (`imgproc.py`), its JPEG decoder (`jpeg.py`), its WebP decoder
(`webp.py`) and its other raster readers (`tiff.py`, `bmp.py`,
`pxm.py`, `sunras.py`, `hdr.py`, `gif.py` over `codecs.py`)."""

from .dataset import (AllDataset, OffsetDataset, ClassDataset, COCOTestset,
                      DataLoader)
from .coco import COCO
from . import webp  # noqa: F401  (the WebP reader, as data.webp)

# reference recipe compatibility: egs/coco scripts import COCODataset
# (the original `egs/coco/local/train.py:16`, a stale name for AllDataset)
COCODataset = AllDataset

__all__ = ["AllDataset", "OffsetDataset", "ClassDataset", "COCOTestset",
           "COCODataset", "DataLoader", "COCO"]
