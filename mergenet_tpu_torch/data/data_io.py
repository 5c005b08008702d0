"""Legacy npy-based dataset IO (the "waldo" format), a copy of
`mergenet_tpu/data/data_io.py` whose square rescale goes through
`imgproc.resize` (cv2.resize INTER_LINEAR on float32) instead of cv2.

Capability parity with reference `utils/data_io.py:14-202`: `DataSaver`
persists {img, mask, object_class} triplets as per-suffix npy files plus an
`image_ids.txt` index; `WaldoDataset` / `WaldoTestset` read them back.  The
reference depended on an external unfulfilled `waldo` package for combined-
image conversion; here the conversion is self-contained
(`ops.targets.mask_to_target_np`).  Arrays are channel-last.
"""

import os

import numpy as np

from . import imgproc
from ..ops.targets import mask_to_target_np
from ..core.types import validate_image_with_mask


class DataSaver:
    """Writes image_with_mask dicts to `dir/{img,mask,object_class}/
    <name>.<suffix>.npy` plus an image_ids.txt index."""

    def __init__(self, dir, cfg, train=True):
        self.dir = dir
        self.cfg = cfg
        self.train = train
        self.suffixes = ["img", "mask", "object_class"] if train else ["img"]
        for suffix in self.suffixes:
            os.makedirs(os.path.join(self.dir, suffix), exist_ok=True)
        self.ids = []

    def write_image(self, name, image_with_mask):
        self.__validate_name(name)
        if self.train:
            validate_image_with_mask(image_with_mask, self.cfg)
        for suffix in self.suffixes:
            path = os.path.join(self.dir, suffix)
            filename = path + "/" + name + "." + suffix + ".npy"
            if suffix == "object_class":
                np.save(filename, np.array(image_with_mask[suffix]))
            else:
                np.save(filename, image_with_mask[suffix])
        self.ids.append(name)

    def write_index(self):
        with open(self.dir + "/image_ids.txt", "w") as fh:
            for id in self.ids:
                fh.write(id + "\n")

    def __validate_name(self, name):
        if " " in name or "/" in name:
            raise ValueError(
                "image id should not contain space or slash but got "
                "{}".format(name))
        if name in self.ids:
            raise ValueError("got duplicated image id: {}".format(name))


class WaldoDataset:
    """Reads DataSaver output; yields (img, class_label, bound[, mask]) in
    channel-last float32."""

    def __init__(self, dir, c_cfg, size, cache=True, mask=False, crop=True,
                 seed=None):
        self.c_cfg = c_cfg
        self.size = size
        self.dir = dir
        self.cache = cache
        self.mask = mask
        self.crop = crop
        self.rng = np.random.RandomState(seed)
        with open(self.dir + "/image_ids.txt") as ids_file:
            self.ids = [line.strip() for line in ids_file]
        self.data = []
        if self.cache:
            for id in self.ids:
                self.data.append(self.__load_data(id))

    def __load_data(self, id):
        out = {}
        for suffix in ["img", "mask", "object_class"]:
            path = os.path.join(self.dir, suffix)
            filename = path + "/" + id + "." + suffix + ".npy"
            if suffix == "object_class":
                out[suffix] = np.load(filename).tolist()
            else:
                out[suffix] = np.load(filename)
        return out

    def __getitem__(self, index):
        x = self.data[index] if self.cache else \
            self.__load_data(self.ids[index])
        img = x["img"].astype("float32")
        if img.ndim == 2:
            img = img[..., None]
        if img.max() > 1.5:
            img = img / 256.0
        mask = x["mask"].astype(np.int64)
        oc = np.asarray(x["object_class"], np.int64)
        n_classes = self.c_cfg.num_classes
        offsets = [tuple(o) for o in self.c_cfg.offsets]
        target = mask_to_target_np(mask, oc, n_classes, offsets)
        if self.crop:
            h, w = img.shape[:2]
            top = self.rng.randint(0, max(1, h - self.size + 1))
            left = self.rng.randint(0, max(1, w - self.size + 1))
            img = img[top:top + self.size, left:left + self.size]
            target = target[top:top + self.size, left:left + self.size]
            mask = mask[top:top + self.size, left:left + self.size]
        class_label = target[..., :n_classes]
        bound = target[..., n_classes:]
        if self.mask:
            return img, class_label, bound, mask
        return img, class_label, bound

    def __len__(self):
        return len(self.ids)


class WaldoTestset:
    """Test images from DataSaver output: (img, size, id); optional square
    rescale and job sharding."""

    def __init__(self, dir, scale_size=0, job=0, num_jobs=1, cache=True):
        self.dir = dir
        self.scale_size = scale_size
        assert job <= num_jobs
        with open(self.dir + "/image_ids.txt") as ids_file:
            self.ids = [line.strip() for line in ids_file]
        if job > 0:
            self.ids = np.array_split(
                np.array(self.ids), num_jobs)[job - 1].tolist()
        self.cache = cache
        self.data = []
        self.original_sizes = []
        if self.cache:
            for id in self.ids:
                img = self.__load_data(id)
                self.original_sizes.append(img.shape[:2])
                self.data.append(self.__maybe_scale(img))

    def __load_data(self, id):
        return np.load(os.path.join(self.dir, "img",
                                    id + ".img.npy"))

    def __maybe_scale(self, img):
        if self.scale_size == 0:
            return img
        return imgproc.resize(img.astype(np.float32),
                              (self.scale_size, self.scale_size))

    def __getitem__(self, index):
        id = self.ids[index]
        if self.cache:
            img = self.data[index]
            size = self.original_sizes[index]
        else:
            img = self.__load_data(id)
            size = img.shape[:2]
            img = self.__maybe_scale(img)
        img = img.astype("float32") / 256.0
        return img, size, id

    def __len__(self):
        return len(self.ids)
