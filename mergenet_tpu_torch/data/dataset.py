"""COCO-json datasets of the port, a copy of `mergenet_tpu/data/dataset.py`
without cv2: images (PNG, JPEG, TIFF, BMP, PxM, Sun raster, HDR, GIF)
are read by `imgproc.imread_rgb` and resized by `imgproc.resize`, which
compute what cv2.imread and cv2.resize compute, bit for bit.  Crops draw from the same `np.random.RandomState(seed)` as
the reference's, so equal seeds give equal crops.

Capability parity with the original `utils/dataset.py` (AllDataset /
OffsetDataset / ClassDataset / COCOTestset) with the same constructor
surface — img_dir/annfile, scale, crop/crop_size, mode
train/val/test/oracle, limits, cache, job/num_jobs sharding — but emitting
channel-last numpy arrays (NHWC) with host-built targets
(`ops.targets.mask_to_target_np`); the compact (mask, class-table)
records whose targets are built on the card come from `pipeline.py`.

Border handling uses the sign-correct OffsetDataset logic everywhere (the
reference AllDataset variant is wrong for positive offsets,
`dataset.py:123-127` vs `:266-276`).

A light `DataLoader` (batch/shuffle/drop_last, threaded prefetch) gives
the reference's batches from the same seed.
"""

import os
import time

import numpy as np

from .coco import COCO
from . import imgproc
from . import rle as maskUtils
from ..ops.targets import mask_to_target_np


def anns_to_mask(anns, height, width, catIds=None):
    """Annotations -> instance-aware mask (+ object_class when catIds given).

    Instance ids 1..N in annotation order; overlaps are first-wins
    (reference dataset.py:486-508)."""
    mask = np.zeros((height, width), dtype="uint16")
    if catIds:
        object_class = [0]  # background class id 0
    object_id = 1
    for ann in anns:
        rle = ann_to_rle(ann, height, width)
        m = maskUtils.decode(rle) * object_id
        object_id += 1
        mask = m * (mask == 0) + mask
        if catIds:
            object_class.append(catIds.index(ann["category_id"]))
    if catIds:
        return mask, object_class
    return mask


def anns_to_mask_class(anns, height, width, catIds):
    """Annotations -> semantic (instance-unaware) class mask."""
    mask = np.zeros((height, width), dtype="uint8")
    for ann in anns:
        class_id = catIds.index(ann["category_id"])
        rle = ann_to_rle(ann, height, width)
        m = maskUtils.decode(rle) * class_id
        mask = m * (mask == 0) + mask
    return mask


def ann_to_rle(ann, height, width):
    """Polygon / uncompressed RLE / RLE annotation -> RLE
    (reference dataset.py:525-542)."""
    segm = ann["segmentation"]
    if isinstance(segm, list):
        rles = maskUtils.frPyObjects(segm, height, width)
        return maskUtils.merge(rles)
    if isinstance(segm["counts"], list):
        return maskUtils.frPyObjects(segm, height, width)
    return segm


def resize_image_and_mask(img, mask, scale):
    """Downsample (H, W, 3) image + (H, W) mask by integer `scale`
    (cv2.resize INTER_LINEAR and INTER_NEAREST, through `imgproc`)."""
    h, w = img.shape[:2]
    height, width = int(h / scale), int(w / scale)
    img = imgproc.resize(img, (width, height))
    mask = imgproc.resize(mask, (width, height),
                          interpolation=imgproc.INTER_NEAREST)
    return img, mask


def crop_image_and_mask(img, mask, height, width, rng=None):
    """Random crop with center zero-padding when too small
    (reference dataset.py:559-585), HWC layout."""
    rng = rng or np.random
    h, w = img.shape[:2]
    if h < height:
        diff = height - h
        top, bot = diff // 2, diff - diff // 2
        img = np.pad(img, ((top, bot), (0, 0), (0, 0)), "constant")
        mask = np.pad(mask, ((top, bot), (0, 0)), "constant")
    if w < width:
        diff = width - w
        left, right = diff // 2, diff - diff // 2
        img = np.pad(img, ((0, 0), (left, right), (0, 0)), "constant")
        mask = np.pad(mask, ((0, 0), (left, right)), "constant")
    h, w = img.shape[:2]
    top = rng.randint(0, h - height + 1)
    left = rng.randint(0, w - width + 1)
    return (img[top:top + height, left:left + width],
            mask[top:top + height, left:left + width])


def crop_image_and_target(img, target, height, width, rng=None):
    """Random crop of image (H, W, 3) + target (H, W, C)."""
    rng = rng or np.random
    h, w = img.shape[:2]
    if h < height:
        diff = height - h
        top, bot = diff // 2, diff - diff // 2
        img = np.pad(img, ((top, bot), (0, 0), (0, 0)), "constant")
        target = np.pad(target, ((top, bot), (0, 0), (0, 0)), "constant")
    if w < width:
        diff = width - w
        left, right = diff // 2, diff - diff // 2
        img = np.pad(img, ((0, 0), (left, right), (0, 0)), "constant")
        target = np.pad(target, ((0, 0), (left, right), (0, 0)), "constant")
    h, w = img.shape[:2]
    top = rng.randint(0, h - height + 1)
    left = rng.randint(0, w - width + 1)
    return (img[top:top + height, left:left + width],
            target[top:top + height, left:left + width])


def _as_pair(crop_size):
    if crop_size is None:
        return None
    if isinstance(crop_size, (tuple, list)):
        return tuple(crop_size)
    return (crop_size, crop_size)


class _CocoDatasetBase:
    """Shared machinery: id list, limits, job sharding, caching, loading."""

    def __init__(self, img_dir, annfile, scale=1, crop=False, crop_size=None,
                 mode="train", limits=None, cache=False, job=0, num_jobs=1,
                 with_cats=True, seed=None):
        self.img_dir = img_dir
        self.coco = COCO(annfile)
        self.scale = scale
        self.crop = crop
        self.crop_size = _as_pair(crop_size)
        if (crop is False and crop_size is not None) or \
                (crop is True and crop_size is None):
            raise ValueError("crop and crop size should match")
        if mode not in ("train", "val", "test", "oracle"):
            raise ValueError("mode should be one of [train, val, test, "
                             "oracle] but given {}".format(mode))
        self.mode = mode
        self.rng = np.random.RandomState(seed)

        self.ids = list(self.coco.imgs.keys())
        self.catIds = [0]
        self.catNms = ["background"]
        if with_cats:
            cats = self.coco.loadCats(self.coco.getCatIds())
            self.catIds.extend([c["id"] for c in cats])
            self.catNms.extend([c["name"] for c in cats])
        if limits:
            self.limits = limits
            self.ids = self.ids[:limits]
        # multi-process job sharding (reference dataset.py:56-63)
        self.job = job
        self.num_jobs = num_jobs
        assert job <= num_jobs
        if self.job > 0:  # job id is 1-indexed
            self.ids = np.array_split(
                np.array(self.ids), self.num_jobs)[self.job - 1].tolist()

        self.cache = cache
        if self.cache:
            t0 = time.time()
            self.all_imgs, self.all_targets = [], []
            for img_id in self.ids:
                img, anns = self._load_img(img_id)
                img, target = self._prepare(img, anns, skip_crop=True)
                self.all_imgs.append(img)
                self.all_targets.append(target)
            print("Cached {} images into memory (t={:.1f}s)".format(
                len(self.ids), time.time() - t0))

    def _load_img(self, img_id):
        ann_ids = self.coco.getAnnIds(imgIds=img_id)
        anns = self.coco.loadAnns(ann_ids)
        img_path = self.coco.loadImgs(img_id)[0]["file_name"]
        img = imgproc.imread_rgb(os.path.join(self.img_dir, img_path))
        return img, anns  # (H, W, 3) RGB

    # subclasses implement _make_target(mask-ish) and _prepare

    def _to_float(self, img):
        return img.astype("float32") / 256.0

    def __getitem__(self, index):
        img_id = self.ids[index]
        if self.mode == "train":
            if self.cache:
                img = self.all_imgs[index]
                target = self.all_targets[index]
                if self.crop:
                    img, target = crop_image_and_target(
                        img, target, self.crop_size[0], self.crop_size[1],
                        self.rng)
            else:
                img, anns = self._load_img(img_id)
                img, target = self._prepare(img, anns)
            return self._to_float(img), target.astype("float32")
        if self.mode == "val":
            img, anns = self._load_img(img_id)
            img, target = self._prepare(img, anns, skip_crop=True)
            return img_id, self._to_float(img), target.astype("float32")
        if self.mode == "test":
            img, anns = self._load_img(img_id)
            h, w = img.shape[:2]
            return img_id, self._to_float(img), (h, w)
        # oracle: ground-truth target alongside the original image
        img, anns = self._load_img(img_id)
        ori_img = img
        h, w = img.shape[:2]
        img, target = self._prepare(img, anns, skip_crop=True)
        return img_id, ori_img, (h, w), target.astype("float32")

    def __len__(self):
        return len(self.ids)


class AllDataset(_CocoDatasetBase):
    """Combined class + offset target: (H, W, num_classes + num_offsets)."""

    def __init__(self, img_dir, annfile, num_classes, offset_list, **kw):
        self.num_classes = num_classes
        self.offset_list = [tuple(o) for o in offset_list]
        super().__init__(img_dir, annfile, with_cats=True, **kw)
        for i in range(len(self.catIds)):
            print("Class Name: {} \t Class Id:{} \t Category Id:{}".format(
                self.catNms[i], i, self.catIds[i]))

    def _prepare(self, img, anns, skip_crop=False):
        mask, object_class = anns_to_mask(
            anns, img.shape[0], img.shape[1], self.catIds)
        if self.scale != 1:
            img, mask = resize_image_and_mask(img, mask, self.scale)
        if self.crop and not skip_crop and not self.cache:
            img, mask = crop_image_and_mask(
                img, mask, self.crop_size[0], self.crop_size[1], self.rng)
        target = mask_to_target_np(
            mask.astype(np.int64), np.asarray(object_class),
            self.num_classes, self.offset_list)
        return img, target


class OffsetDataset(_CocoDatasetBase):
    """Offset-only target: (H, W, num_offsets)."""

    def __init__(self, img_dir, annfile, offset_list, **kw):
        self.offset_list = [tuple(o) for o in offset_list]
        super().__init__(img_dir, annfile, with_cats=False, **kw)

    def _prepare(self, img, anns, skip_crop=False):
        mask = anns_to_mask(anns, img.shape[0], img.shape[1])
        if self.scale != 1:
            img, mask = resize_image_and_mask(img, mask, self.scale)
        if self.crop and not skip_crop and not self.cache:
            img, mask = crop_image_and_mask(
                img, mask, self.crop_size[0], self.crop_size[1], self.rng)
        # identity class table: sameness planes only need instance identity
        n = int(mask.max()) + 1
        target = mask_to_target_np(mask.astype(np.int64), np.arange(n),
                                   0, self.offset_list)
        return img, target


class ClassDataset(_CocoDatasetBase):
    """Class-only one-hot target: (H, W, num_classes).  `caffe=True`
    switches to mean-subtracted BGR x256 preprocessing
    (reference dataset.py:431-438)."""

    def __init__(self, img_dir, annfile, caffe=False, **kw):
        self.caffe = caffe
        super().__init__(img_dir, annfile, with_cats=True, **kw)
        for i in range(len(self.catIds)):
            print("Class Name: {} \t Class Id:{} \t Category Id:{}".format(
                self.catNms[i], i, self.catIds[i]))

    def _to_float(self, img):
        if not self.caffe:
            return img.astype("float32") / 256.0
        img = img.astype("float32")
        img -= np.array([123.68, 116.779, 103.939])[None, None, :]
        return img[:, :, ::-1].copy()  # RGB -> BGR

    def _prepare(self, img, anns, skip_crop=False):
        mask = anns_to_mask_class(anns, img.shape[0], img.shape[1],
                                  self.catIds)
        if self.scale != 1:
            img, mask = resize_image_and_mask(img, mask, self.scale)
        if self.crop and not skip_crop and not self.cache:
            img, mask = crop_image_and_mask(
                img, mask, self.crop_size[0], self.crop_size[1], self.rng)
        n = len(self.catIds)
        target = np.zeros(mask.shape + (n,), np.float32)
        for c in range(n):
            target[:, :, c] = mask == c
        return img, target


class COCOTestset:
    """Raw images + ids for submission-style inference
    (reference dataset.py:619-650)."""

    def __init__(self, img_dir, info_file, c_cfg=None, class_nms=None):
        self.img_dir = img_dir
        self.coco = COCO(info_file)
        self.c_cfg = c_cfg
        self.class_nms = class_nms
        self.catIds = [0]
        if self.class_nms:
            cats = self.coco.loadCats(self.coco.getCatIds())
            all_nms = [c["name"] for c in cats]
            for nm in self.class_nms:
                if nm not in all_nms:
                    raise ValueError(
                        "the given class name {} should be included in the "
                        "dataset".format(nm))
            if c_cfg is not None:
                assert len(class_nms) + 1 == c_cfg.num_classes
            catIds = self.coco.getCatIds(catNms=self.class_nms)
            self.catIds.extend(catIds)
            self.ids = self.coco.getImgIds(catIds=catIds)
        else:
            self.ids = list(self.coco.imgs.keys())
            self.catIds.extend(self.coco.getCatIds())

    def __getitem__(self, index):
        img_id = self.ids[index]
        img_path = self.coco.loadImgs(img_id)[0]["file_name"]
        img = imgproc.imread_rgb(os.path.join(self.img_dir, img_path))
        return img, img_id

    def __len__(self):
        return len(self.ids)


def _shard_slice(shard, batch_size, drop_last=True):
    """The slice of each batch that loader `index` of `count` yields
    (all of it without a shard)."""
    if shard is None:
        return slice(None)
    index, count = shard
    if not drop_last or batch_size % count or not 0 <= index < count:
        raise ValueError("shard %s of batches of %d needs drop_last and a "
                         "batch size that the count divides"
                         % (shard, batch_size))
    b = batch_size // count
    return slice(index * b, (index + 1) * b)


class DataLoader:
    """Minimal batching loader: shuffle, batch, drop_last; yields stacked
    numpy arrays (the reference's loader, batch for batch from a seed).

    `prefetch > 0` assembles batches on a background thread so host data
    prep overlaps the card's step.

    `shard=(index, count)`: every one of `count` loaders draws the same
    order and yields only its contiguous `batch_size // count` slice of
    each batch (a data-parallel rank's shard; `drop_last` and a batch
    size that `count` divides are required)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, drop_last=False,
                 seed=0, prefetch=0, shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rng = np.random.RandomState(seed)
        self.shard = _shard_slice(shard, batch_size, drop_last)

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        n = len(order)
        step = self.batch_size
        end = n - (n % step) if self.drop_last else n
        for s in range(0, end, step):
            items = [self.dataset[int(i)] for i in order[s:s + step][
                self.shard]]
            yield self._collate(items)

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        import queue
        import threading
        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is sentinel:
                break
            yield batch
        if err:
            raise err[0]

    @staticmethod
    def _collate(items):
        first = items[0]
        if isinstance(first, tuple):
            cols = []
            for j in range(len(first)):
                vals = [it[j] for it in items]
                if isinstance(first[j], np.ndarray):
                    cols.append(np.stack(vals))
                else:
                    cols.append(np.asarray(vals))
            return tuple(cols)
        return np.stack(items)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size
