"""The port's JPEG reader (`mergenet_tpu_torch/data/jpeg.py` and
`native/jpeg.cc`) against cv2, whose libjpeg-turbo the JAX package reads
images with: every array bit for bit equal to `cv2.cvtColor(cv2.imread(
path), cv2.COLOR_BGR2RGB)`.

- the committed files (`tests/fixtures/jpeg/`, written by
  `tests/make_jpeg_fixtures.py`) against their recorded cv2 digests, and
  the digests against this cv2;
- seeded `cv2.imencode` cases: sizes from 1x1 to 70x50 and 1024-wide
  rows, every sampling factor cv2 writes, grey, progressive, optimised
  Huffman tables, restart intervals 1-4, qualities 1-100;
- files written by `jpeg_craft.write_jpeg` with what cv2's encoder never
  writes: coefficients that overflow the inverse DCT's 16-bit lanes,
  16-bit quantisation tables (SOF1), sampling factors 1-4 in unusual
  patterns, RGB by Adobe flag or component ids, no DHT (Annex K
  tables), a DQT redefined between scans;
- EXIF orientations 1-8 in both byte orders, and which APP1 cv2 takes;
- what it refuses (truncated data, SOF3, SOF9, 4 components) and what it
  skips as libjpeg does (fill bytes, bytes before a marker, no EOI);
- the JAX package's datasets, test set and grain records against the
  port's on a JPEG split, and `certify.score` on one.

Needs g++ (the decoder is built at its first call)."""

import contextlib
import hashlib
import importlib.util
import io as _io
import json
import os
import shutil

import cv2
import numpy as np
import pytest

from jpeg_craft import (blocks_shape, exif_app1, find_marker,
                        insert_after_soi, segment, write_jpeg)
from mergenet_tpu_torch.data import imgproc, jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXJ = os.path.join(ROOT, "tests", "fixtures", "jpeg")
with open(os.path.join(FIXJ, "cv2_digests.json")) as _f:
    DIGESTS = json.load(_f)


def _cv2_read(path):
    img = cv2.imread(path)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _sha(img):
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _assert_reads_as_cv2(data, tmp_path, name="a.jpg"):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    ref = _cv2_read(path)
    assert ref is not None
    got = imgproc.imread_rgb(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------ committed files

def test_committed_digests_equal_cv2():
    assert len(DIGESTS) == 62
    for rel, d in DIGESTS.items():
        img = _cv2_read(os.path.join(FIXJ, rel))
        assert [list(img.shape), _sha(img)] == [d["shape"], d["sha256"]], rel


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_committed_file_decodes_bit_equal(rel):
    img = imgproc.imread_rgb(os.path.join(FIXJ, rel))
    assert list(img.shape) == DIGESTS[rel]["shape"]
    assert _sha(img) == DIGESTS[rel]["sha256"]


# ----------------------------------------------------- cv2's encodings

_SAMPLING = {s: getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR_%d" % s)
             for s in (411, 420, 422, 440, 444)}
#: (H, W, grey, sampling, quality, progressive, optimise, restart)
ENCODINGS = [
    (1, 1, False, 420, 90, False, False, 0),
    (1, 1, True, 444, 50, True, False, 0),
    (2, 3, False, 411, 90, False, False, 1),
    (3, 2, False, 440, 100, True, False, 0),
    (5, 7, False, 422, 1, False, True, 2),
    (8, 8, False, 444, 90, True, True, 3),
    (9, 17, False, 420, 50, True, False, 4),
    (16, 16, True, 420, 1, False, False, 1),
    (15, 33, False, 411, 100, False, False, 0),
    (17, 15, False, 440, 90, True, True, 0),
    (24, 31, False, 422, 50, False, False, 4),
    (31, 24, False, 420, 100, True, False, 2),
    (33, 47, True, 444, 90, True, True, 3),
    (40, 40, False, 411, 50, True, False, 0),
    (47, 65, False, 440, 1, False, True, 1),
    (50, 70, False, 420, 90, False, False, 0),
    (70, 50, False, 422, 100, True, True, 0),
    (63, 63, False, 444, 1, True, False, 2),
    (2, 1024, False, 420, 90, False, False, 0),
    (3, 1024, False, 411, 50, True, True, 1),
    (1, 1024, True, 444, 100, False, False, 4),
    (4, 1023, False, 440, 90, True, False, 0),
    (13, 2, False, 422, 90, False, False, 3),
    (2, 13, False, 440, 50, True, False, 0),
]


@pytest.mark.parametrize("case", ENCODINGS, ids=[
    "%dx%d%s-%d-q%d%s%s%s" % (h, w, "g" if g else "", s, q, "-p" if p else "",
                              "-o" if o else "", "-r%d" % r if r else "")
    for h, w, g, s, q, p, o, r in ENCODINGS])
def test_cv2_encoding_decodes_bit_equal(case, tmp_path):
    H, W, grey, samp, q, prog, opt, rst = case
    rng = np.random.default_rng(H * 1000 + W)
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    smooth = cv2.GaussianBlur(img, (5, 5), 3)
    img = np.where(rng.random((H, W, 1)) < 0.7, smooth, img)  # edges too
    if grey:
        img = img[..., 0]
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              _SAMPLING[samp], cv2.IMWRITE_JPEG_PROGRESSIVE, int(prog),
              cv2.IMWRITE_JPEG_OPTIMIZE, int(opt),
              cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    _assert_reads_as_cv2(bytes(buf), tmp_path)


# ---------------------------------------------------- crafted encodings

#: (sampling factors per component, coefficient kind, 16-bit tables)
CRAFTED = [
    (((1, 1),), "extreme", False),
    (((2, 2),), "rows", True),
    (((1, 1), (1, 1), (1, 1)), "extreme", True),
    (((2, 2), (1, 1), (1, 1)), "rows", False),
    (((1, 1), (2, 2), (2, 2)), "mild", False),
    (((4, 1), (1, 1), (1, 1)), "extreme", False),
    (((1, 4), (1, 1), (1, 1)), "mild", True),
    (((2, 1), (1, 2), (1, 1)), "extreme", False),
    (((3, 1), (1, 1), (1, 1)), "rows", False),
    (((2, 2), (2, 1), (1, 2)), "mild", False),
    (((1, 2), (1, 1), (1, 1)), "extreme", True),
    (((3, 2), (1, 1), (1, 1)), "mild", False),
    (((2, 3), (2, 1), (1, 1)), "rows", True),
    (((2, 2), (1, 2), (2, 1)), "extreme", False),
]


def _coefs(rng, kind, shape):
    if kind == "mild":
        c = np.round(rng.standard_normal(shape + (8, 8)) * 3).astype(int)
        c[..., 0, 0] = rng.integers(-60, 60, shape)
    elif kind == "extreme":  # 16-bit lanes overflow in both passes
        c = rng.integers(-1500, 1500, shape + (8, 8)) * (
            rng.random(shape + (8, 8)) < 0.3)
    else:  # row 0 only: the column pass is skipped
        c = np.zeros(shape + (8, 8), int)
        c[..., 0, :] = rng.integers(-2000, 2000, shape + (8,)) * (
            rng.random(shape + (8,)) < 0.5)
    return c


@pytest.mark.parametrize("i", range(len(CRAFTED)))
def test_crafted_encoding_decodes_bit_equal(i, tmp_path):
    pattern, kind, q16 = CRAFTED[i]
    rng = np.random.default_rng(i)
    comps = [(h, v, min(k, 1)) for k, (h, v) in enumerate(pattern)]
    for H, W in ((1, 1), (int(rng.integers(2, 60)), int(rng.integers(2, 60)))):
        coefs = [_coefs(rng, kind, blocks_shape(comps, k, W, H))
                 for k in range(len(comps))]
        qt = {0: rng.integers(1, 3000 if q16 else 256, 64),
              1: rng.integers(1, 65536 if q16 else 256, 64)}
        data = write_jpeg(comps, W, H, coefs, qt, sof=0xC1 if q16 else 0xC0,
                          q16=q16, restart=i % 3)
        _assert_reads_as_cv2(data, tmp_path)


@pytest.mark.parametrize("markers", [
    dict(jfif=False, adobe=0), dict(jfif=False, ids=[82, 71, 66]),
    dict(jfif=False, ids=[5, 6, 7]), dict(jfif=False, adobe=1,
                                          ids=[82, 71, 66]),
    dict(jfif=True, ids=[82, 71, 66])],
    ids=["adobe0", "rgb_ids", "other_ids", "adobe1_rgb_ids", "jfif_rgb_ids"])
def test_colour_space_follows_markers_and_ids(markers, tmp_path):
    rng = np.random.default_rng(7)
    comps = [(2, 1, 0), (1, 1, 1), (1, 1, 1)]
    coefs = [_coefs(rng, "mild", blocks_shape(comps, k, 37, 21))
             for k in range(3)]
    data = write_jpeg(comps, 37, 21, coefs, {0: rng.integers(1, 40, 64),
                                             1: rng.integers(1, 40, 64)},
                      **markers)
    _assert_reads_as_cv2(data, tmp_path)


def _bench_jpeg(**params):
    img = cv2.imread(os.path.join(ROOT, "tests", "fixtures",
                                  "certification512", "bench_img.png"))
    args = [cv2.IMWRITE_JPEG_QUALITY, 75]
    for k, v in params.items():
        args += [getattr(cv2, "IMWRITE_JPEG_" + k.upper()), v]
    return bytes(cv2.imencode(".jpg", img[:120, :200], args)[1])


def test_tables_between_scans_and_annex_k_defaults(tmp_path):
    """A DQT redefined after a component's first scan does not reach it
    (tables are latched); a file without DHT decodes with T.81 Annex K's
    tables, as libjpeg's std_huff_tables supplies them."""
    prog = _bench_jpeg(progressive=1)
    sos = prog.index(b"\xff\xda")
    second = prog.index(b"\xff\xc4", sos)  # the DHT before scan 2
    dqt = segment(0xDB, b"\x00" + bytes(range(1, 65)) + b"\x01"
                  + bytes([7] * 64))
    _assert_reads_as_cv2(prog[:second] + dqt + prog[second:], tmp_path)
    base = _bench_jpeg()  # libjpeg's default tables are Annex K's
    i = find_marker(base, 0xC4)
    n = int.from_bytes(base[i + 2:i + 4], "big")
    while base[i:i + 2] == b"\xff\xc4":
        n = int.from_bytes(base[i + 2:i + 4], "big")
        base = base[:i] + base[i + 2 + n:]
    assert b"\xff\xc4" not in base[:base.index(b"\xff\xda")]
    _assert_reads_as_cv2(base, tmp_path, "nodht.jpg")


# ------------------------------------------------------------------ EXIF

@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_applied_as_cv2(orientation, big_endian, tmp_path):
    data = insert_after_soi(_bench_jpeg(sampling_factor=cv2.
                                        IMWRITE_JPEG_SAMPLING_FACTOR_420),
                            exif_app1(orientation, big_endian))
    _assert_reads_as_cv2(data, tmp_path)


def test_exif_segment_cv2_takes(tmp_path):
    """The first well-formed Exif APP1 before the first scan: other APP1
    payloads, a malformed TIFF header and an empty IFD0 are passed over,
    a later Exif APP1 is not read, an orientation outside 1-8 is none."""
    base = _bench_jpeg()

    def ex(o, prefix=b"Exif\x00\x00"):
        e = exif_app1(o, False)
        return e[:4] + prefix + e[10:]
    xmp = segment(0xE1, b"http://ns.adobe.com/xap/1.0/\x00<x/>")
    empty = segment(0xE1, b"Exif\x00\x00II*\x00\x08\x00\x00\x00\x00\x00")
    junk = segment(0xE1, b"Exif\x00\x00XXXXXXXX")
    for k, segs in enumerate([xmp + ex(6), ex(6, b"Exif\x00X"), ex(6) + ex(3),
                              ex(9) + ex(6), junk + ex(6), empty + ex(8),
                              ex(0) + ex(6)]):
        _assert_reads_as_cv2(insert_after_soi(base, segs), tmp_path,
                             "e%d.jpg" % k)
    prog = _bench_jpeg(progressive=1)
    i = prog.index(b"\xff\xc4", prog.index(b"\xff\xda"))
    got = jpeg.decode_jpeg(prog[:i] + ex(6) + prog[i:])
    assert got.shape == (120, 200, 3)  # after the first scan: not read


# ----------------------------------------------------- refused, skipped

def test_refuses_what_it_does_not_decode(tmp_path):
    """Each raises ValueError naming the file and the cause.  (cv2.imdecode
    returns None for the cut files, where cv2.imread pads them with grey
    after libjpeg's warning; libjpeg-turbo 3 decodes SOF3, SOF9 and
    4-component files, which the port does not.)"""
    base = _bench_jpeg()
    sof = find_marker(base, 0xC0)
    end = sof + 2 + int.from_bytes(base[sof + 2:sof + 4], "big")

    def with_sof(m):
        return base[:sof + 1] + bytes([m]) + base[sof + 2:]
    four = (b"\xff\xc0" + (20).to_bytes(2, "big") + base[sof + 4:sof + 9]
            + b"\x04" + base[sof + 10:end] + b"\x04\x11\x00")
    prog = _bench_jpeg(progressive=1)
    cases = {"lossless": with_sof(0xC3), "arithmetic": with_sof(0xC9),
             "hierarchical": with_sof(0xC5),
             "CMYK": base[:sof] + four + base[end:],
             "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:],
             "premature end": base[:len(base) // 2],
             "premature end|truncated": prog[:len(prog) * 2 // 3],
             "expected restart marker": _bench_jpeg(rst_interval=2).replace(
                 b"\xff\xd1", b"\xff\xd3", 1),
             # over cv2's 2^30 pixels; a header far larger than its data
             "too big": base[:sof + 5] + b"\x9c\x40\x9c\x40" + base[sof + 9:],
             "truncated": base[:sof + 5] + b"\x4e\x20\x4e\x20"
             + base[sof + 9:]}
    for cause, data in cases.items():
        path = str(tmp_path / "bad.jpg")
        with open(path, "wb") as f:
            f.write(data)
        with pytest.raises(ValueError, match=cause) as e:
            imgproc.imread_rgb(path)
        assert path in str(e.value)
    path = str(tmp_path / "x.bmp")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        imgproc.imread_rgb(path)


def test_skips_what_libjpeg_skips(tmp_path):
    """FF fill bytes before markers, stray bytes between a scan and the
    next marker, data after EOI and a missing EOI read as cv2 reads
    them."""
    for prog in (0, 1):
        b = _bench_jpeg(progressive=prog, rst_interval=3)
        eoi = len(b) - 2
        for k, data in enumerate([
                b[:2] + b"\xff\xff" + b[2:], b[:eoi] + b"\x12\x34" + b[eoi:],
                b[:eoi] + b"\xff\xff\xff" + b[eoi:], b + b"trailing",
                b[:eoi]]):
            _assert_reads_as_cv2(data, tmp_path, "s%d%d.jpg" % (prog, k))


# ----------------------------------------------- datasets on a JPEG split

def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(_io.StringIO()):
        return fn(*a, **kw)


def _jpeg_split(src, dst, splits=("train", "val")):
    """`src`'s splits with every image re-encoded by cv2 as a JPEG
    (quality 90, 4:2:0) and the jsons naming the .jpg files."""
    os.makedirs(os.path.join(dst, "annotations"), exist_ok=True)
    for split in splits:
        os.makedirs(os.path.join(dst, split), exist_ok=True)
        ann = os.path.join("annotations", "instancesonly_%s.json" % split)
        with open(os.path.join(src, ann)) as f:
            d = json.load(f)
        for im in d["images"]:
            img = cv2.imread(os.path.join(src, split, im["file_name"]))
            im["file_name"] = os.path.splitext(im["file_name"])[0] + ".jpg"
            cv2.imwrite(os.path.join(dst, split, im["file_name"]), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
        with open(os.path.join(dst, ann), "w") as f:
            json.dump(d, f)
    return dst


@pytest.fixture(scope="module")
def jdata(tmp_path_factory):
    from mergenet_tpu_torch.data import synthetic
    src = str(tmp_path_factory.mktemp("png"))
    _quiet(synthetic.generate, src, 2, 2, 40, 72, 9, seed=3)
    return _jpeg_split(src, str(tmp_path_factory.mktemp("jpg")))


def test_datasets_on_jpeg_split_equal_reference(jdata):
    from mergenet_tpu.data import dataset as jdataset
    from mergenet_tpu_torch.data import dataset as tdataset
    offsets = ((1, 0), (0, 2), (-2, -1), (5, 5))
    img, ann = (os.path.join(jdata, "train"), os.path.join(
        jdata, "annotations", "instancesonly_train.json"))
    kinds = {"all": lambda m, **kw: m.AllDataset(img, ann, 9, offsets, **kw),
             "offset": lambda m, **kw: m.OffsetDataset(img, ann, offsets,
                                                       **kw),
             "class": lambda m, **kw: m.ClassDataset(img, ann, **kw)}
    for name, make in kinds.items():
        for kw in ({}, dict(crop=True, crop_size=(24, 40), seed=3),
                   dict(scale=2, crop=True, crop_size=16, seed=6)):
            ref, got = (_quiet(make, m, **kw) for m in (jdataset, tdataset))
            assert len(got) == len(ref) == 2
            for i in range(len(ref)):
                _assert_same(got[i], ref[i], "%s %s %d" % (name, kw, i))
    ref = _quiet(jdataset.COCOTestset, img, ann)
    got = _quiet(tdataset.COCOTestset, img, ann)
    for i in range(len(ref)):
        _assert_same(got[i], ref[i], "test set %d" % i)


def _assert_same(a, b, where=""):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
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
        assert a == b, (where, a, b)


def test_compact_records_on_jpeg_split_equal_grain(jdata):
    from mergenet_tpu.data import grain_pipeline as jgrain
    from mergenet_tpu_torch.data import pipeline as tpipe
    paths = (os.path.join(jdata, "train"), os.path.join(
        jdata, "annotations", "instancesonly_train.json"))
    for kw in ({}, dict(scale=2)):
        ref = jgrain.CocoInstanceSource(*paths, **kw)
        got = tpipe.CocoInstanceSource(*paths, **kw)
        for i in range(len(ref)):
            _assert_same(got[i], ref[i], str(i))
            for seed in range(2):
                rc, gc = jgrain.RandomCrop(32, 48), tpipe.RandomCrop(32, 48)
                _assert_same(
                    gc.random_map(got[i], np.random.default_rng(seed)),
                    rc.random_map(ref[i], np.random.default_rng(seed)),
                    "crop %d %d" % (i, seed))


def test_score_on_jpeg_split_equals_jax_package(tmp_path):
    """`certify.score` reads a val split of JPEGs as cv2 reads them: its
    maps are the port's net on cv2's arrays, and its hier AP is the JAX
    package's decode of those maps."""
    import jax.numpy as jnp
    import torch
    from mergenet_tpu.data.coco import COCO as JCOCO
    from mergenet_tpu.decoder.device import (decode_hierarchical,
                                             relabel_mask)
    from mergenet_tpu_torch import certify as CT
    from mergenet_tpu_torch.core import generate_offsets
    from mergenet_tpu_torch.models import get_model, init_model
    spec = importlib.util.spec_from_file_location(
        "make_certification_fixtures",
        os.path.join(ROOT, "scripts", "make_certification_fixtures.py"))
    cert = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cert)
    C, O = 9, 5
    offsets = tuple(generate_offsets(80, O))
    src = str(tmp_path / "png")
    CT.regenerate(src, train_images=1, val_images=2, height=64, width=128,
                  num_classes=C, seed=100)
    data = _jpeg_split(src, str(tmp_path / "jpg"), ("val",))
    shutil.rmtree(src)
    net = init_model(get_model(C, O, "unet_small"), 3)
    maps = {}
    got = CT.score(net, data, C, offsets, ("hier",), device="cpu",
                   on_probs=lambda n, i, cp, sp: maps.__setitem__(i, (cp,
                                                                      sp)))
    with contextlib.redirect_stdout(_io.StringIO()):
        jcoco = JCOCO(os.path.join(data, "annotations",
                                   "instancesonly_val.json"))
    res = []
    for img_id, (cp, sp) in sorted(maps.items()):
        fname = jcoco.loadImgs(img_id)[0]["file_name"]
        img = _cv2_read(os.path.join(data, "val", fname))
        with torch.no_grad():
            probs = torch.sigmoid(net(torch.from_numpy(
                img.astype(np.float32)[None] / 256.0)))[0].numpy()
        np.testing.assert_array_equal(np.concatenate([cp, sp], -1), probs)
        comp, rc, ii = decode_hierarchical(jnp.asarray(cp), jnp.asarray(sp),
                                           C, offsets, **CT.DECODE_KW)
        mask, ic = relabel_mask(comp, rc, ii)
        res += cert.mask_to_results(
            np.asarray(mask), [int(c) for c in np.asarray(ic) if c >= 0],
            img_id)
    assert got["images"] == 2
    assert got["hier"] == cert.coco_ap(jcoco, res)
    assert got["results"]["hier"] == res
