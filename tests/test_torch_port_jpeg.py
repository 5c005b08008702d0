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
- the processes and colour spaces cv2 reads past baseline, each written
  by `jpeg_craft` and held to cv2 or to refusing as cv2 refuses:
  arithmetic coding (SOF9, SOF10: DAC tables, restarts, successive
  approximation), lossless (SOF3: predictors 1-7, point transforms,
  precisions 2-16, restarts, non-interleaved scans; grey, YCbCr and YCCK
  lossless refused), 12-bit samples and 2 components (refused), 4
  components (Adobe CMYK and YCCK, 1x1 and 2x2 sampling, a seeded sweep
  of CMYK values), and arithmetic and Huffman codings of the same
  coefficients decoded to the same bytes without cv2;
- what it refuses (truncated data, hierarchical, 12-bit) and what it
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
                        insert_after_soi, lossless_shape, segment, write_jpeg, write_jpeg_arith,
                        write_lossless)
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
    assert len(DIGESTS) == 70
    for rel, d in DIGESTS.items():
        img = _cv2_read(os.path.join(FIXJ, rel))
        assert [list(img.shape), _sha(img)] == [d["shape"], d["sha256"]], rel


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_committed_file_decodes_bit_equal(rel):
    img = imgproc.imread_rgb(os.path.join(FIXJ, rel))
    assert list(img.shape) == DIGESTS[rel]["shape"]
    assert _sha(img) == DIGESTS[rel]["sha256"]


def test_committed_arithmetic_transcodings_equal_their_huffman_files():
    pairs = {rel: d["transcoded_from"] for rel, d in DIGESTS.items()
             if "transcoded_from" in d}
    assert len(pairs) == 4
    for rel, src in pairs.items():
        with open(os.path.join(FIXJ, rel), "rb") as f:
            head = f.read()
        head = head[:head.index(b"\xff\xda")]
        assert (b"\xff\xca" if "prog" in rel else b"\xff\xc9") in head
        np.testing.assert_array_equal(
            imgproc.imread_rgb(os.path.join(FIXJ, rel)),
            imgproc.imread_rgb(os.path.join(FIXJ, src)), err_msg=rel)


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


# ------------------------------------ past baseline: what cv2 reads, step 0

def _both(data, tmp_path, name="c.jpg"):
    """(cv2's RGB or None, the port's RGB or its ValueError) of `data`."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        got = imgproc.imread_rgb(path)
    except ValueError as e:
        assert path in str(e)
        got = e
    return _cv2_read(path), got


def _assert_both_refuse(data, tmp_path, cause):
    ref, got = _both(data, tmp_path)
    assert ref is None
    assert isinstance(got, ValueError) and cause in str(got), got


def _mixed_coefs(rng, comps, W, H):
    """Coefficients of every size: mostly small, DCs spread, a few past
    the inverse DCT's 16-bit lanes."""
    out = []
    for k in range(len(comps)):
        shape = blocks_shape(comps, k, W, H)
        c = np.round(rng.standard_normal(shape + (8, 8)) * 3).astype(int)
        c[..., 0, 0] = rng.integers(-400, 400, shape)
        big = rng.random(shape + (8, 8)) < 0.02
        c[big] = rng.integers(-2000, 2000, int(big.sum()))
        out.append(c)
    return out


#: (sampling factors, progressive, restart interval, DAC tables)
ARITH = [
    (((1, 1),), False, 0, None),
    (((2, 2), (1, 1), (1, 1)), False, 0, None),
    (((2, 2), (1, 1), (1, 1)), False, 3, {(0, 0): (2, 5), (1, 0): 2}),
    (((2, 1), (1, 1), (1, 1)), False, 1, {(0, 0): (0, 0), (0, 1): (3, 3),
                                         (1, 0): 63, (1, 1): 0}),
    (((1, 1),), True, 2, {(0, 0): (1, 9), (1, 0): 20}),
    (((2, 2), (1, 1), (1, 1)), True, 0, None),
    (((1, 2), (1, 1), (1, 1)), True, 5, {(0, 1): (4, 12), (1, 1): 1}),
    (((1, 1), (1, 1), (1, 1)), True, 0, {(0, 0): (15, 15), (1, 0): 255}),
]


@pytest.mark.parametrize("case", ARITH, ids=[
    "%s-%s%s%s" % ("".join("%d%d" % f for f in p), "prog" if g else "seq",
                   "-r%d" % r if r else "", "-dac" if d else "")
    for p, g, r, d in ARITH])
def test_arithmetic_decodes_as_cv2(case, tmp_path):
    """SOF9 and SOF10 at each sampling, with and without DAC tables and
    restart intervals: the port equals cv2, and both equal the decode
    of the same coefficients Huffman-coded."""
    pattern, prog, rst, dac = case
    rng = np.random.default_rng(len(pattern) * 100 + rst)
    comps = [(h, v, min(k, 1)) for k, (h, v) in enumerate(pattern)]
    W, H = int(rng.integers(1, 60)), int(rng.integers(1, 45))
    coefs = _mixed_coefs(rng, comps, W, H)
    qt = {0: rng.integers(1, 30, 64), 1: rng.integers(1, 30, 64)}
    data = write_jpeg_arith(comps, W, H, coefs, qt, progressive=prog,
                            restart=rst, dac=dac)
    ref, got = _both(data, tmp_path)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jpeg.decode_jpeg(write_jpeg(comps, W, H, coefs, qt, sof=0xC1,
                                         restart=rst)))


#: (components, scan script) of the coding pairs
PAIRS = [
    (1, None), (3, None), (4, None),
    (3, [((0, 1, 2), 0, 0, 0, 2), ((0,), 1, 63, 0, 3), ((1,), 1, 63, 0, 0),
         ((2,), 1, 9, 0, 0), ((2,), 10, 63, 0, 0), ((0, 1, 2), 0, 0, 2, 1),
         ((0,), 1, 63, 3, 2), ((0, 1, 2), 0, 0, 1, 0), ((0,), 1, 63, 2, 1),
         ((0,), 1, 63, 1, 0)]),
]


@pytest.mark.parametrize("n,scans", PAIRS, ids=["1", "3", "4", "3-sa"])
def test_arithmetic_and_huffman_codings_decode_equal(n, scans):
    """Needs no cv2: the same quantised coefficients, Huffman-coded
    (SOF1) and arithmetic-coded (sequential, and progressive by
    libjpeg's script or by one with deeper successive approximation),
    decode to the same bytes."""
    rng = np.random.default_rng(n)
    comps = [(2, 2, 0), (1, 1, 1), (1, 1, 1), (2, 1, 0)][:n]
    if n == 1:
        comps = [(1, 1, 0)]
    for W, H in ((1, 1), (37, 29), (64, 16)):
        coefs = _mixed_coefs(rng, comps, W, H)
        qt = {0: rng.integers(1, 40, 64), 1: rng.integers(1, 40, 64)}
        ref = jpeg.decode_jpeg(write_jpeg(comps, W, H, coefs, qt, sof=0xC1,
                                          adobe=2 if n == 4 else None))
        for prog in (False, True):
            data = write_jpeg_arith(
                comps, W, H, coefs, qt, progressive=prog, restart=W % 4,
                scans=scans if prog else None, adobe=2 if n == 4 else None)
            np.testing.assert_array_equal(jpeg.decode_jpeg(data), ref)


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_decodes_as_cv2(predictor, tmp_path):
    """SOF3 RGB (Adobe transform 0, or ids R G B) with each predictor, at
    point transforms 0-3, 1x1 and subsampled components, restart
    intervals of whole MCU rows: cv2's samples << Pt, replicated."""
    rng = np.random.default_rng(predictor)
    for pt, pattern, markers, rows in (
            (0, ((1, 1), (1, 1), (1, 1)), dict(adobe=0), 0),
            (predictor % 4, ((2, 2), (1, 1), (1, 1)), dict(adobe=0), 1),
            (1, ((1, 1), (2, 1), (1, 2)), dict(ids=[82, 71, 66]), 2),
            (3, ((1, 1),) * 4, {}, 3)):
        comps = [(h, v, 0) for h, v in pattern]
        W, H = int(rng.integers(1, 40)), int(rng.integers(1, 30))
        samples = [rng.integers(0, 256, lossless_shape(comps, k, W, H))
                   for k in range(len(comps))]
        per_row = -(-W // max(h for h, _ in pattern))
        data = write_lossless(comps, W, H, samples, predictor=predictor,
                              pt=pt, restart=rows * per_row, jfif=False,
                              **markers)
        ref, got = _both(data, tmp_path)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("precision", range(2, 17))
def test_lossless_precision_as_cv2(precision, tmp_path):
    """2- to 8-bit lossless samples read unscaled (a 5-bit file's values
    stay below 32); 9- to 16-bit files are refused by both."""
    rng = np.random.default_rng(precision)
    comps = [(1, 1, 0)] * 3
    samples = [rng.integers(0, 1 << precision, (11, 13)) for _ in range(3)]
    data = write_lossless(comps, 13, 11, samples, precision=precision,
                          predictor=precision % 7 + 1,
                          pt=min(2, precision - 1), jfif=False, adobe=0)
    if precision > 8:
        _assert_both_refuse(data, tmp_path, "%d-bit lossless" % precision)
        return
    ref, got = _both(data, tmp_path)
    np.testing.assert_array_equal(got, ref)
    assert int(got.max()) < 1 << precision


def test_lossless_non_interleaved_scans_as_cv2(tmp_path):
    """One scan per component (and a scan of two), with restarts every
    row or two: a restart inside an iMCU row of a component with v > 1
    makes that iMCU row's first row the 1-D row, as libjpeg decodes."""
    rng = np.random.default_rng(11)
    for pattern, scans, every in (
            (((1, 2), (1, 1), (1, 1)), [(0,), (1,), (2,)], 1),
            (((2, 2), (1, 1), (2, 1)), [(0,), (1, 2)], 2),
            (((1, 3), (1, 1), (1, 1), (1, 3)), [(0,), (1,), (2,), (3,)], 1),
            (((1, 1), (1, 1), (1, 1)), [(2,), (0,), (1,)], 3)):
        comps = [(h, v, 0) for h, v in pattern]
        W, H = int(rng.integers(2, 30)), int(rng.integers(2, 30))
        samples = [rng.integers(0, 256, lossless_shape(comps, k, W, H))
                   for k in range(len(comps))]
        own = -(-W * pattern[0][0] // max(h for h, _ in pattern))
        data = write_lossless(comps, W, H, samples, predictor=4,
                              restart=every * own, scans=scans, jfif=False,
                              adobe=0 if len(comps) == 3 else None)
        ref, got = _both(data, tmp_path)
        if isinstance(got, ValueError):  # libjpeg's rule: whole MCU rows
            assert ref is None and "restart interval" in str(got)
            continue
        np.testing.assert_array_equal(got, ref)


def test_lossless_refused_as_cv2(tmp_path):
    """What cv2 does not read in lossless mode, the port refuses: grey,
    YCbCr and YCCK (no colour conversion in lossless mode), 2
    components, restarts that are not whole MCU rows, predictor 0, and
    lossless arithmetic coding (SOF11)."""
    rng = np.random.default_rng(5)

    def ll(n, **kw):
        comps = [(1, 1, 0)] * n
        return write_lossless(comps, 10, 6, [rng.integers(0, 256, (6, 10))
                                             for _ in range(n)], **kw)
    _assert_both_refuse(ll(1), tmp_path, "lossless JPEG in grey")
    _assert_both_refuse(ll(3), tmp_path, "lossless JPEG in YCbCr")
    _assert_both_refuse(ll(4, jfif=False, adobe=2), tmp_path,
                        "lossless JPEG in YCCK")
    _assert_both_refuse(ll(2, jfif=False), tmp_path,
                        "2-component JPEG")
    _assert_both_refuse(ll(3, jfif=False, adobe=0, restart=3), tmp_path,
                        "restart interval 3")
    data = bytearray(ll(3, jfif=False, adobe=0))
    sos = data.index(b"\xff\xda")
    data[sos + 11] = 0  # Ss: predictor 0
    _assert_both_refuse(bytes(data), tmp_path, "bad lossless JPEG scan")
    data = bytearray(ll(3, jfif=False, adobe=0))
    data[data.index(b"\xff\xc3") + 1] = 0xCB
    _assert_both_refuse(bytes(data), tmp_path, "SOF11")


@pytest.mark.parametrize("marker", [0xC1, 0xC2, 0xC9, 0xCA],
                         ids=["SOF1", "SOF2", "SOF9", "SOF10"])
def test_twelve_bit_refused_as_cv2(marker, tmp_path):
    """12-bit samples: cv2 reads none of them (nor does the port)."""
    rng = np.random.default_rng(marker)
    comps = [(2, 2, 0), (1, 1, 1), (1, 1, 1)]
    coefs = _mixed_coefs(rng, comps, 21, 17)
    qt = {0: rng.integers(1, 30, 64), 1: rng.integers(1, 30, 64)}
    if marker in (0xC1, 0xC9):
        write = write_jpeg if marker == 0xC1 else write_jpeg_arith
        data = write(comps, 21, 17, coefs, qt, precision=12,
                     **({"sof": 0xC1} if marker == 0xC1 else {}))
    elif marker == 0xCA:
        data = write_jpeg_arith(comps, 21, 17, coefs, qt, progressive=True,
                                precision=12)
    else:  # a progressive Huffman file of cv2's, its precision made 12
        data = bytearray(_bench_jpeg(progressive=1))
        data[data.index(b"\xff\xc2") + 4] = 12
        data = bytes(data)
    _assert_both_refuse(data, tmp_path, "12-bit JPEG")


#: (sampling factors, Adobe transform or None, JFIF marker)
FOUR = [
    (((1, 1),) * 4, 0, False), (((1, 1),) * 4, 2, False),
    (((1, 1),) * 4, None, False), (((1, 1),) * 4, 1, False),
    (((1, 1),) * 4, None, True),
    (((2, 2), (1, 1), (1, 1), (2, 2)), 0, False),
    (((2, 2), (1, 1), (1, 1), (2, 2)), 2, False),
    (((2, 2), (1, 1), (1, 1), (1, 1)), 2, True),
    (((1, 2), (2, 1), (1, 1), (2, 2)), None, False),
]


@pytest.mark.parametrize("case", FOUR, ids=[
    "%s-%s%s" % ("".join("%d%d" % f for f in p), "none" if a is None
                 else "adobe%d" % a, "-jfif" if j else "")
    for p, a, j in FOUR])
def test_four_components_as_cv2(case, tmp_path):
    """4 components: CMYK with Adobe transform 0 or no Adobe marker (a
    JFIF marker changes nothing), YCCK with transform 2 (and 1, which
    libjpeg takes for YCCK), at 1x1 and 2x2 sampling."""
    pattern, adobe, jfif = case
    rng = np.random.default_rng(len(pattern) + (adobe or 7))
    comps = [(h, v, min(k, 1)) for k, (h, v) in enumerate(pattern)]
    for W, H in ((1, 1), (int(rng.integers(2, 50)), int(rng.integers(2, 40)))):
        coefs = _mixed_coefs(rng, comps, W, H)
        qt = {0: rng.integers(1, 20, 64), 1: rng.integers(1, 20, 64)}
        data = write_jpeg(comps, W, H, coefs, qt, jfif=jfif, adobe=adobe)
        ref, got = _both(data, tmp_path)
        np.testing.assert_array_equal(got, ref)


def test_cmyk_to_rgb_sweep_as_cv2(tmp_path):
    """cv2's CMYK -> BGR, R = K - ((255 - C) * K >> 8), found with a
    seeded sweep of (C, M, Y, K): flat 8x8 blocks at 4:4:4 with unit
    quantisation decode to exactly the chosen values."""
    rng = np.random.default_rng(16)
    t = rng.integers(0, 256, (1024, 4))
    t[:256] = np.arange(256)[:, None]
    t[256:384, 3], t[384:512, 3] = 255, 0
    comps = [(1, 1, 0)] * 4
    coefs = []
    for k in range(4):
        c = np.zeros((16, 64, 8, 8), int)
        c[..., 0, 0] = (8 * (t[:, k] - 128)).reshape(16, 64)
        coefs.append(c)
    data = write_jpeg(comps, 512, 128, coefs, {0: np.ones(64, int)},
                      jfif=False, adobe=0)
    ref, got = _both(data, tmp_path)
    np.testing.assert_array_equal(got, ref)
    c, m, y, k = t.T

    def ink(v):
        return k - ((255 - v) * k >> 8)
    np.testing.assert_array_equal(got[::8, ::8].reshape(-1, 3),
                                  np.stack([ink(c), ink(m), ink(y)], 1))


def test_two_components_refused_as_cv2(tmp_path):
    rng = np.random.default_rng(2)
    comps = [(1, 1, 0), (1, 1, 0)]
    for kw in (dict(jfif=False), dict(jfif=True)):
        data = write_jpeg(comps, 9, 7, _mixed_coefs(rng, comps, 9, 7),
                          {0: rng.integers(1, 20, 64)}, **kw)
        _assert_both_refuse(data, tmp_path, "2-component JPEG")


# ----------------------------------------------------- refused, skipped

def test_refuses_what_it_does_not_decode(tmp_path):
    """Each raises ValueError naming the file and the cause: the
    processes cv2 does not read either (hierarchical, 12-bit; the
    lossless, 2-component and 12-bit cases are held to cv2's refusals
    above) and, on purpose, cut or corrupt data, where cv2.imdecode
    returns None for the cut Huffman files and cv2.imread pads them with
    grey after libjpeg's warning (it pads cut arithmetic-coded data with
    zero bytes)."""
    base = _bench_jpeg()
    sof = find_marker(base, 0xC0)

    def with_sof(m):
        return base[:sof + 1] + bytes([m]) + base[sof + 2:]
    prog = _bench_jpeg(progressive=1)
    rng = np.random.default_rng(0)
    comps = [(2, 2, 0), (1, 1, 1), (1, 1, 1)]
    arith = write_jpeg_arith(comps, 64, 48, _mixed_coefs(rng, comps, 64, 48),
                             {0: rng.integers(1, 9, 64),
                              1: rng.integers(1, 9, 64)})
    cases = {"hierarchical": with_sof(0xC5),
             "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:],
             "premature end": base[:len(base) // 2],
             "premature end|truncated": prog[:len(prog) * 2 // 3],
             "premature end of data segment": arith[:len(arith) // 2],
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
