"""The port's data slice against the JAX package's and the reference
generator, on a tiny regenerated dataset (no JAX compile):

- `data/synthetic.py` against `egs/cityscape/local/make_synthetic_data.py`
  (images pixel for pixel, json byte for byte), and its first 8 val
  annotations at 512x1024 against both committed `val_ann.json` files;
- `AllDataset`, `OffsetDataset`, `ClassDataset` (also `caffe=True`) in
  the four modes with crops, cache, limits, `job`/`num_jobs` and
  `scale=2`, on annotations that hold polygons and uncompressed RLE
  besides compressed RLE; `COCOTestset`; `DataLoader` with shuffle,
  drop_last and prefetch; the `COCODataset` alias;
- `data_io`'s `DataSaver`, `WaldoDataset` and `WaldoTestset`;
- `pipeline`: `CocoInstanceSource` records, `RandomCrop` given the same
  generator (or offsets, or needing padding), and the batches' shapes,
  dtypes and determinism.

Every comparison is exact: equal seeds give equal crops and batches."""

import contextlib
import importlib.util
import io as _io
import json
import os

import cv2
import numpy as np
import pytest

from mergenet_tpu.core import CoreConfig as JCoreConfig
from mergenet_tpu.data import data_io as jdata_io
from mergenet_tpu.data import dataset as jdataset
from mergenet_tpu.data import grain_pipeline as jgrain
from mergenet_tpu_torch import data as tdata
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.core import CoreConfig
from mergenet_tpu_torch.data import data_io as tdata_io
from mergenet_tpu_torch.data import dataset as tdataset
from mergenet_tpu_torch.data import pipeline as tpipe
from mergenet_tpu_torch.data import synthetic
from torch_port_helpers import FIX19, FIX512

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFFSETS = ((1, 0), (0, 2), (-2, -1), (5, 5), (-9, 7))


def _reference_generator():
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_data", os.path.join(
            ROOT, "egs", "cityscape", "local", "make_synthetic_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(_io.StringIO()):
        return fn(*a, **kw)


def _write(ref, out, n_train, n_val, H, W, C, seed):
    _quiet(ref.write_split, out, "train", n_train, H, W, C, 8, seed)
    _quiet(ref.write_split, out, "val", n_val, H, W, C, 8, seed + 1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A tiny dataset written by the reference generator (cv2 PNGs, which
    use every PNG filter), whose train json also holds a polygon and an
    uncompressed-RLE annotation (`instancesonly_mixed.json`)."""
    out = str(tmp_path_factory.mktemp("synthetic"))
    _write(_reference_generator(), out, 6, 3, 48, 80, 9, 5)
    ann_dir = os.path.join(out, "annotations")
    with open(os.path.join(ann_dir, "instancesonly_train.json")) as f:
        d = json.load(f)
    from mergenet_tpu_torch.data import rle
    m = rle.decode(d["annotations"][2]["segmentation"])
    d["annotations"][2]["segmentation"] = {
        "size": [48, 80], "counts": rle._counts_from_mask(m)}
    d["annotations"].append({
        "id": 999, "image_id": 1, "category_id": 3, "iscrowd": 0,
        "area": 1, "bbox": [0, 0, 1, 1],
        "segmentation": [[3.5, 2.0, 60.5, 10.4, 79.9, 47.6, 7.0, 30.5],
                         [40.0, 40.0, 45.5, 20.0, 50.0, 41.0]]})
    with open(os.path.join(ann_dir, "instancesonly_mixed.json"), "w") as f:
        json.dump(d, f)
    return out


def _paths(data, split="train", ann="train"):
    return (os.path.join(data, split), os.path.join(
        data, "annotations", "instancesonly_%s.json" % ann))


def _assert_same(a, b, where=""):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, "%s[%d]" % (where, i))
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], "%s[%r]" % (where, k))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


# ------------------------------------------------------------- generator

@pytest.mark.parametrize("C", [9, 19])
def test_generator_equals_reference(tmp_path, C):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _write(_reference_generator(), ref_dir, 3, 2, 64, 128, C, 7)
    _quiet(synthetic.main, ["--out-dir", port_dir, "--train-images", "3",
                            "--val-images", "2", "--height", "64",
                            "--width", "128", "--num-classes", str(C),
                            "--seed", "7"])
    for split, n in (("train", 3), ("val", 2)):
        name = "annotations/instancesonly_%s.json" % split
        with open(os.path.join(ref_dir, name), "rb") as f, \
                open(os.path.join(port_dir, name), "rb") as g:
            assert f.read() == g.read()
        for i in range(n):
            fname = "%s/%s_%05d.png" % (split, split, i)
            ref = cv2.cvtColor(cv2.imread(os.path.join(ref_dir, fname)),
                               cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(
                TIO.read_png_rgb(os.path.join(port_dir, fname)), ref)


@pytest.mark.parametrize("fix,C", [(FIX512, 9), (FIX19, 19)])
def test_generator_val_annotations_equal_committed(tmp_path, fix, C):
    """The certification data is seed 100's val split (seed 101) at
    512x1024: the port's first 8 images carry the committed annotations."""
    if not os.path.exists(os.path.join(fix, "val_ann.json")):
        pytest.skip("%s is not in this checkout" % fix)
    _quiet(synthetic.write_split, str(tmp_path), "val", 8, 512, 1024, C, 8,
           101)
    with open(os.path.join(str(tmp_path), "annotations",
                           "instancesonly_val.json")) as f:
        got = json.load(f)
    with open(os.path.join(fix, "val_ann.json")) as f:
        ref = json.load(f)
    assert got["categories"] == ref["categories"]
    assert got["images"] == ref["images"][:8]
    assert got["annotations"] == [a for a in ref["annotations"]
                                  if a["image_id"] < 8]


# -------------------------------------------------------------- datasets

DATASETS = {
    "all": (lambda m, *p, **kw: m.AllDataset(*p, 9, OFFSETS, **kw)),
    "offset": (lambda m, *p, **kw: m.OffsetDataset(*p, OFFSETS, **kw)),
    "class": (lambda m, *p, **kw: m.ClassDataset(*p, **kw)),
    "class_caffe": (lambda m, *p, **kw: m.ClassDataset(*p, caffe=True,
                                                       **kw)),
}
OPTIONS = {
    "plain": {},
    "crop": dict(crop=True, crop_size=(40, 56), seed=3),
    "crop_pad": dict(crop=True, crop_size=64, seed=4),
    "cache_crop": dict(cache=True, crop=True, crop_size=32, seed=5),
    "limits_job": dict(limits=5, job=2, num_jobs=2),
    "scale2": dict(scale=2, crop=True, crop_size=16, seed=6),
}


@pytest.mark.parametrize("kind", sorted(DATASETS))
@pytest.mark.parametrize("mode", ["train", "val", "test", "oracle"])
def test_datasets_equal_reference(data, kind, mode):
    for name, kw in OPTIONS.items():
        if mode != "train" and name not in ("plain", "limits_job",
                                            "scale2"):
            continue
        made = [_quiet(DATASETS[kind], m, *_paths(data, ann="mixed"),
                       mode=mode, **kw) for m in (jdataset, tdataset)]
        ref, got = made
        assert len(got) == len(ref) and got.ids == ref.ids
        assert got.catIds == ref.catIds
        for rep in range(2):  # a second pass draws fresh crops
            for i in range(len(ref)):
                _assert_same(got[i], ref[i], "%s %s %s %d" % (
                    kind, mode, name, i))


def test_annotation_helpers_equal_reference(data):
    coco = _quiet(tdata.COCO, _paths(data, ann="mixed")[1])
    cats = [0] + coco.getCatIds()
    for img_id in coco.getImgIds():
        anns = coco.loadAnns(coco.getAnnIds(imgIds=img_id))
        for a in anns:
            assert tdataset.ann_to_rle(a, 48, 80) == jdataset.ann_to_rle(
                a, 48, 80)
        _assert_same(tdataset.anns_to_mask(anns, 48, 80, cats),
                     jdataset.anns_to_mask(anns, 48, 80, cats))
        _assert_same(tdataset.anns_to_mask_class(anns, 48, 80, cats),
                     jdataset.anns_to_mask_class(anns, 48, 80, cats))
    assert tdata.COCODataset is tdata.AllDataset
    assert set(tdata.__all__) == {"AllDataset", "OffsetDataset",
                                  "ClassDataset", "COCOTestset",
                                  "COCODataset", "DataLoader", "COCO"}


@pytest.mark.parametrize("class_nms", [None, ["class2", "class5"]])
def test_coco_testset_equals_reference(data, class_nms):
    sets = [_quiet(m.COCOTestset, *_paths(data, ann="mixed"),
                   class_nms=class_nms) for m in (jdataset, tdataset)]
    assert sets[1].ids == sets[0].ids and sets[1].catIds == sets[0].catIds
    for i in range(len(sets[0])):
        _assert_same(sets[1][i], sets[0][i])


@pytest.mark.parametrize("shuffle,drop_last,prefetch,batch",
                         [(False, False, 0, 4), (True, True, 2, 4),
                          (True, False, 1, 3)])
def test_dataloader_equals_reference(data, shuffle, drop_last, prefetch,
                                     batch):
    ref_ds, got_ds = (_quiet(m.AllDataset, *_paths(data), 9, OFFSETS,
                             crop=True, crop_size=32, seed=8)
                      for m in (jdataset, tdataset))
    loaders = [m.DataLoader(ds, batch_size=batch, shuffle=shuffle,
                            drop_last=drop_last, seed=11, prefetch=prefetch)
               for m, ds in ((jdataset, ref_ds), (tdataset, got_ds))]
    assert len(loaders[1]) == len(loaders[0])
    for epoch in range(2):
        ref, got = (list(ld) for ld in loaders)
        assert len(got) == len(ref) == len(loaders[0])
        _assert_same(got, ref, "epoch %d" % epoch)


def test_dataloader_prefetch_surfaces_errors(data):
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise KeyError("sample %d" % i)

    with pytest.raises(KeyError, match="sample 0"):
        list(tdataset.DataLoader(Broken(), prefetch=2))


# --------------------------------------------------------------- data_io

def _cfg(m):
    c = m()
    c.num_classes = 3
    c.num_colors = 3
    c.offsets = [(1, 0), (0, 1), (-2, 3)]
    return c


def _samples():
    rng = np.random.RandomState(0)
    for k in range(3):
        img = rng.randint(0, 255, (30, 44, 3)).astype(np.uint8)
        mask = np.zeros((30, 44), np.int64)
        mask[2:8 + k, 3:19] = 1
        mask[12:25, 20 + k:40] = 2
        yield "im%d" % k, {"img": img, "mask": mask,
                           "object_class": [0, 1, 2]}


def test_data_io_equals_reference(tmp_path):
    dirs = {}
    for tag, m, cfg in (("ref", jdata_io, _cfg(JCoreConfig)),
                        ("port", tdata_io, _cfg(CoreConfig))):
        dirs[tag] = str(tmp_path / tag)
        saver = m.DataSaver(dirs[tag], cfg)
        for name, x in _samples():
            saver.write_image(name, x)
        with pytest.raises(ValueError):
            saver.write_image("im0", x)  # duplicate
        with pytest.raises(ValueError):
            saver.write_image("bad name", x)
        saver.write_index()
    for root, _, files in os.walk(dirs["ref"]):
        for f in files:
            a = os.path.join(root, f)
            b = os.path.join(dirs["port"], os.path.relpath(a, dirs["ref"]))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
    for kw in (dict(size=16, mask=True, seed=2), dict(size=12, crop=True,
                                                       cache=False, seed=3),
               dict(size=8, crop=False)):
        ref = jdata_io.WaldoDataset(dirs["ref"], _cfg(JCoreConfig), **kw)
        got = tdata_io.WaldoDataset(dirs["port"], _cfg(CoreConfig), **kw)
        assert len(got) == len(ref) == 3
        for i in range(3):
            _assert_same(got[i], ref[i], str(kw))
    for kw in (dict(scale_size=24), dict(scale_size=0, cache=False),
               dict(scale_size=20, job=1, num_jobs=2, cache=False)):
        ref = jdata_io.WaldoTestset(dirs["ref"], **kw)
        got = tdata_io.WaldoTestset(dirs["port"], **kw)
        assert got.ids == ref.ids
        for i in range(len(ref)):
            _assert_same(got[i], ref[i], str(kw))


# -------------------------------------------------------------- pipeline

@pytest.mark.parametrize("kw", [{}, dict(scale=2, limits=4)])
def test_instance_source_records_equal_reference(data, kw):
    ref = jgrain.CocoInstanceSource(*_paths(data, ann="mixed"), **kw)
    got = tpipe.CocoInstanceSource(*_paths(data, ann="mixed"), **kw)
    assert len(got) == len(ref) and got.catIds == ref.catIds
    for i in range(len(ref)):
        _assert_same(got[i], ref[i], str(i))
    assert tpipe.MAX_INSTANCES == jgrain.MAX_INSTANCES


@pytest.mark.parametrize("size", [(24, 40), (64, 100), (48, 80)])
def test_random_crop_equals_reference(data, size):
    """Given the same numpy Generator (so the same offsets), the crop
    equals the reference's, padding included when the crop is larger
    than the image; and `crop(record, top, left)` is that crop."""
    rec = tpipe.CocoInstanceSource(*_paths(data))[1]
    ref_crop, got_crop = jgrain.RandomCrop(*size), tpipe.RandomCrop(*size)
    for seed in range(4):
        ref = ref_crop.random_map(rec, np.random.default_rng(seed))
        got = got_crop.random_map(rec, np.random.default_rng(seed))
        _assert_same(got, ref, str((size, seed)))
        rng = np.random.default_rng(seed)
        h, w = got_crop.pad(rec)[0].shape[:2]
        top = int(rng.integers(0, h - size[0] + 1))
        left = int(rng.integers(0, w - size[1] + 1))
        _assert_same(got_crop.crop(rec, top, left), ref)
        assert got["image"].shape == size + (3,)


def test_train_pipeline_batches(data):
    src = tpipe.CocoInstanceSource(*_paths(data))
    runs = []
    for threads in (1, 3):
        batches, s = tpipe.make_train_pipeline(
            None, None, batch_size=4, crop_size=32, seed=12, num_epochs=2,
            read_threads=threads, prefetch_buffer=1, source=src)
        assert s is src and len(batches) == 3  # 12 samples, remainder 0
        runs.append(list(batches))
    _assert_same(runs[0], runs[1])
    for b in runs[0]:
        assert b["image"].shape == (4, 32, 32, 3)
        assert b["image"].dtype == np.uint8
        assert b["mask"].shape == (4, 32, 32) and b["mask"].dtype == np.int32
        assert b["object_class"].shape == (4, tpipe.MAX_INSTANCES)
        assert b["object_class"].dtype == np.int32
    one, _ = tpipe.make_train_pipeline(*_paths(data), batch_size=4,
                                       crop_size=32, seed=12)
    assert len(one) == 1 and len(list(one)) == 1  # 6 samples: 2 dropped
    other, _ = tpipe.make_train_pipeline(*_paths(data), batch_size=4,
                                         crop_size=32, seed=13)
    assert not np.array_equal(next(iter(other))["image"],
                              runs[0][0]["image"])
    early = iter(tpipe.make_train_pipeline(
        None, None, batch_size=2, crop_size=32, num_epochs=3,
        prefetch_buffer=1, source=src)[0])
    next(early)
    early.close()  # a consumer that stops early leaves no thread behind
