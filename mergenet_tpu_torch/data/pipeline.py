"""The compact training input pipeline, the port's counterpart of
`mergenet_tpu/data/grain_pipeline.py` without grain or cv2.

The host ships compact records (uint8 image, int32 instance mask, int32
class table) and `parallel.train.build_train_step_compact` builds the
(C + O)-plane target on the card.

    CocoInstanceSource  index -> {image uint8 (H, W, 3), mask int32 (H, W),
                                  object_class int32 (MAX_INSTANCES,)},
                        the reference's records exactly
    RandomCrop          fixed-size crop with centred zero padding when the
                        image is smaller (the reference's `RandomCrop`,
                        given the same offsets)
    make_train_pipeline shuffle -> crop -> batch(drop_remainder), read by
                        a thread pool and prefetched on a thread

Sample order and crop offsets differ from grain's.  grain's shuffle and
its per-record crop generators cannot be reproduced without grain, so
here epoch `e` of a pass visits the records in
`np.random.default_rng([seed, e]).permutation(n)` order, and the k-th
sample of the pass (in epoch e) is cropped at offsets drawn by
`RandomCrop` from `np.random.default_rng([seed, e, k])`.  A
seed gives the same batches on every run and under any number of read
threads.  The per-epoch seed `seed * 10007 + epoch` of the training
recipe (`egs/cityscape/local/train.py:278-283`) is the caller's."""

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import imgproc
from .coco import COCO
from .dataset import anns_to_mask, resize_image_and_mask

#: class table capacity per record (instances beyond this are background)
MAX_INSTANCES = 256


class CocoInstanceSource:
    """Random-access compact records over a COCO-json instance dataset."""

    def __init__(self, img_dir, annfile, scale=1, limits=None):
        self.img_dir = img_dir
        self.coco = COCO(annfile)
        self.scale = scale
        self.catIds = [0] + self.coco.getCatIds()
        self.ids = list(self.coco.imgs.keys())
        if limits:
            self.ids = self.ids[:limits]

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index):
        img_id = self.ids[int(index)]
        ann_ids = self.coco.getAnnIds(imgIds=img_id)
        anns = self.coco.loadAnns(ann_ids)
        img_path = self.coco.loadImgs(img_id)[0]["file_name"]
        img = imgproc.imread_rgb(os.path.join(self.img_dir, img_path))
        mask, object_class = anns_to_mask(anns, img.shape[0], img.shape[1],
                                          self.catIds)
        if self.scale != 1:
            img, mask = resize_image_and_mask(img, mask, self.scale)
        oc = np.zeros((MAX_INSTANCES,), np.int32)
        n = min(len(object_class), MAX_INSTANCES)
        oc[:n] = object_class[:n]
        # instances beyond capacity fall back to background
        mask = np.where(mask < MAX_INSTANCES, mask, 0)
        return {"image": img.astype(np.uint8),
                "mask": mask.astype(np.int32),
                "object_class": oc}


class RandomCrop:
    """Fixed-size random crop with centred zero padding when the image is
    smaller than the crop (the reference's `RandomCrop`)."""

    def __init__(self, height, width):
        self.height = height
        self.width = width

    def pad(self, record):
        """The record's image and mask zero-padded (centred) to at least
        the crop size."""
        img, mask = record["image"], record["mask"]
        h, w = img.shape[:2]
        if h < self.height:
            diff = self.height - h
            top, bot = diff // 2, diff - diff // 2
            img = np.pad(img, ((top, bot), (0, 0), (0, 0)), "constant")
            mask = np.pad(mask, ((top, bot), (0, 0)), "constant")
        if w < self.width:
            diff = self.width - w
            left, right = diff // 2, diff - diff // 2
            img = np.pad(img, ((0, 0), (left, right), (0, 0)), "constant")
            mask = np.pad(mask, ((0, 0), (left, right)), "constant")
        return img, mask

    def crop(self, record, top, left):
        """The crop at (top, left) of the padded record."""
        img, mask = self.pad(record)
        return {"image": img[top:top + self.height,
                             left:left + self.width],
                "mask": mask[top:top + self.height,
                             left:left + self.width],
                "object_class": record["object_class"]}

    def random_map(self, record, rng):
        """Crop at offsets drawn from the numpy Generator `rng` as the
        reference draws them (`rng.integers(0, h - height + 1)`, then the
        left offset)."""
        img, _ = self.pad(record)
        h, w = img.shape[:2]
        top = int(rng.integers(0, h - self.height + 1))
        left = int(rng.integers(0, w - self.width + 1))
        return self.crop(record, top, left)


class TrainPipeline:
    """Iterable of compact batches: shuffle -> crop -> batch with the
    remainder dropped, `num_epochs` passes (None: one), records read by
    `read_threads` threads and up to `prefetch_buffer` batches assembled
    ahead on a background thread."""

    def __init__(self, source, batch_size, crop_size, seed=0, shuffle=True,
                 num_epochs=None, read_threads=2, prefetch_buffer=4):
        self.source = source
        self.batch_size = batch_size
        self.crop = RandomCrop(crop_size, crop_size)
        self.seed = int(seed)
        self.shuffle = shuffle
        self.num_epochs = num_epochs or 1
        self.read_threads = max(1, read_threads)
        self.prefetch_buffer = max(1, prefetch_buffer)

    def order(self):
        """(epoch, position in the pass, record index) of every sample of
        the pass that makes a full batch, in order."""
        n = len(self.source)
        out = []
        for e in range(self.num_epochs):
            idx = (np.random.default_rng([self.seed, e]).permutation(n)
                   if self.shuffle else np.arange(n))
            out += [(e, int(i)) for i in idx]
        end = len(out) - len(out) % self.batch_size
        return [(e, k, i) for k, (e, i) in enumerate(out[:end])]

    def __len__(self):
        return len(self.order()) // self.batch_size

    def _sample(self, item):
        e, k, i = item
        rng = np.random.default_rng([self.seed, e, k])
        return self.crop.random_map(self.source[i], rng)

    def _batches(self, pool):
        order = self.order()
        for s in range(0, len(order), self.batch_size):
            recs = list(pool.map(self._sample, order[s:s + self.batch_size]))
            yield {k: np.stack([r[k] for r in recs]) for k in recs[0]}

    def __iter__(self):
        q = queue.Queue(maxsize=self.prefetch_buffer)
        done, err = object(), []
        stop = threading.Event()

        def worker():
            try:
                with ThreadPoolExecutor(self.read_threads) as pool:
                    for batch in self._batches(pool):
                        while not stop.is_set():
                            try:
                                q.put(batch, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is done:
                    break
                yield batch
        finally:
            stop.set()
            while t.is_alive():  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.05)
        if err:
            raise err[0]


def make_train_pipeline(img_dir, annfile, batch_size, crop_size,
                        scale=1, limits=None, seed=0, shuffle=True,
                        num_epochs=None, read_threads=2,
                        prefetch_buffer=4, source=None):
    """Build the pipeline; returns (batches, source).

    Iterating `batches` yields dicts of stacked numpy arrays:
        image (B, S, S, 3) uint8, mask (B, S, S) int32,
        object_class (B, MAX_INSTANCES) int32
    for `build_train_step_compact`, which normalises and builds the
    targets on the card.  Pass `source` to reuse a CocoInstanceSource
    across epochs (vary `seed` per epoch for fresh shuffles and crops)."""
    if source is None:
        source = CocoInstanceSource(img_dir, annfile, scale=scale,
                                    limits=limits)
    return TrainPipeline(source, batch_size, crop_size, seed=seed,
                         shuffle=shuffle, num_epochs=num_epochs,
                         read_threads=read_threads,
                         prefetch_buffer=prefetch_buffer), source
