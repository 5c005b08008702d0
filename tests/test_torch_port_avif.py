"""The port's AVIF reader (`mergenet_tpu_torch/data/avif.py` over
`data/native/avif.cc`, built with g++ at the first call) against
`cv2.imread` (OpenCV 5.0.0 over its bundled libavif 1.4.2, libaom 3.14.1
and libyuv), bit for bit, and against cv2's refusals (cv2 returns None;
the port raises ValueError naming the file):

- the committed `tests/fixtures/avif` (`make_avif_fixtures.py`) against
  cv2's digests, which are held to cv2 here too;
- step 0's rows: the container variants `avif_craft` rewraps around one
  AV1 payload (properties dropped, added, non-essential; idat, extents;
  where items lie against cv2's 500-byte sniff; Exif orientations and
  offsets; grids; alpha; an avis sequence), each against cv2;
- AV1 from the encoders: Pillow's libaom with the in-loop filters off
  (speeds, qualities, subsamplings, screen content, IntraBC, 128
  superblocks, tiles, delta q, delta lf), cv2's own files at 8, 10 and
  12 bits with the later tools switched off in the header, and the
  colour matrices cv2 converts by different routes (a faster twin runs;
  the seeded random sweep is marked slow);
- the frames with a tool decoded after reconstruction (cv2's quality-90
  file among them) raise "not yet read", naming the tools;
- truncated and corrupt files (seeded; the all-variant sweep is marked
  slow, a faster twin runs);
- the constant tables of `avif.cc` against cv2's libaom and libavif
  (skipped where cv2's libraries are absent), and the conversion against
  libyuv's own functions in cv2's libavif;
- the coverage counters over the fixtures;
- the decoder source includes and links no library."""

import glob
import hashlib
import io as _io
import json
import os
import re
import struct
import subprocess

import cv2
import numpy as np
import pytest
from PIL import Image

import avif_craft as ac
import webp_craft as wc
from mergenet_tpu_torch.data import avif, imgproc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "avif")
with open(os.path.join(FIX, "cv2_digests.json")) as _f:
    DIGESTS = json.load(_f)
NF = {"enable-cdef": "0", "enable-restoration": "0", "loopfilter-control": "0"}
BENCH = cv2.imread(os.path.join(ROOT, "tests", "fixtures", "certification512",
                                "bench_img.png"))
CROP = np.ascontiguousarray(BENCH[192:256, 384:512, ::-1])
WIDE = np.ascontiguousarray(BENCH[128:256, 256:512, ::-1])


def _both(data, tmp_path, name="c.avif"):
    """(cv2's RGB or None, the port's RGB or its ValueError) of file
    bytes `data`."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    ref = cv2.imread(path)
    try:
        got = imgproc.imread_rgb(path)
    except ValueError as e:
        assert path in str(e), e
        got = e
    return (None if ref is None else ref[..., ::-1]), got


def _as_cv2(data, tmp_path, where="", refused=None):
    """The port reads `data` as cv2 does (or refuses it as cv2 does);
    `refused` pins which of the two cv2 does."""
    ref, got = _both(data, tmp_path)
    if refused is not None:
        assert (ref is None) == refused, (where, "cv2 refused: %s"
                                          % (ref is None))
    if ref is None:
        assert isinstance(got, ValueError), (where, "cv2 refuses, port reads")
        assert avif.NOT_YET not in str(got), (where, got)
        return None
    assert not isinstance(got, ValueError), (where, got)
    assert got.dtype == np.uint8 and got.shape == ref.shape, where
    np.testing.assert_array_equal(got, ref, err_msg=str(where))
    return got


def _digest(img):
    return [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]


def _pil(rgb, **kw):
    f = _io.BytesIO()
    mode = "RGBA" if rgb.ndim == 3 and rgb.shape[2] == 4 else "RGB"
    Image.fromarray(np.ascontiguousarray(rgb), mode).save(f, "AVIF", **kw)
    return f.getvalue()


def _cv2_avif(bgr, quality, depth=8):
    prm = [cv2.IMWRITE_AVIF_QUALITY, quality]
    if depth > 8:
        prm += [cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", bgr, prm)
    assert ok
    return bytes(buf)


BASE = _pil(CROP, quality=90, advanced=NF)


# ------------------------------------------------------------ fixtures

def test_committed_digests_equal_cv2():
    """cv2 still reads (or refuses) every committed file as its digest
    says."""
    for rel, d in DIGESTS.items():
        img = cv2.imread(os.path.join(FIX, rel))
        if d["sha256"] is None:
            assert img is None, rel
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        assert _digest(img) == [d["shape"], d["sha256"]], rel


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_committed_file_reads_bit_equal(rel):
    d = DIGESTS[rel]
    path = os.path.join(FIX, rel)
    if d["sha256"] is None or "not_yet" in d:
        with pytest.raises(ValueError) as e:
            imgproc.imread_rgb(path)
        assert path in str(e.value)
        if "not_yet" in d:
            assert "AVIF with %s" % d["not_yet"] in str(e.value)
            assert avif.NOT_YET in str(e.value)
        else:
            assert avif.NOT_YET not in str(e.value)
        return
    img = imgproc.imread_rgb(path)
    assert _digest(img) == [d["shape"], d["sha256"]]


def test_committed_lossless_files_are_their_pngs():
    """The lossless val files' digests are those of the PNGs they came
    from (recorded by make_avif_fixtures.py; chip_smoke.py holds the
    port's reads to the regenerated PNGs)."""
    lossless = {k: d for k, d in DIGESTS.items() if "png" in d}
    assert len(lossless) == 2
    for rel, d in lossless.items():
        assert d["png"] == os.path.basename(rel)[:-5] + ".png"
        assert d["shape"] == [512, 1024, 3]
        with open(os.path.join(FIX, rel), "rb") as f:
            m = ac.parse(f.read())
        units = ac.obus(m["items"][m["primary"]]["data"])
        seq = ac.seq_header(next(p for t, e, p in units if t == 1))
        assert (seq["mc"], seq["ssx"], seq["ssy"]) == (0, 0, 0), rel


def test_fixtures_are_small():
    total = sum(os.path.getsize(os.path.join(FIX, k)) for k in DIGESTS)
    assert total < 3.5e6


# ------------------------------------------------------------- step 0

def _rewrap(data=BASE, drop=(), add=(), **kw):
    m = ac.parse(data)
    it = m["items"][m["primary"]]
    it["props"] = [(e, p) for e, p in it["props"] if p[4:8] not in drop]
    it["props"] += list(add)
    return ac.write(m, **kw)


def _exif(payload, first=True):
    m = ac.parse(BASE)
    av = m["items"][1]
    ex = {"type": b"Exif", "name": b"", "props": [], "data": payload}
    if first:
        m["items"], m["primary"], m["refs"] = {1: ex, 2: av}, 2, [
            (b"cdsc", 1, [2])]
    else:
        m["items"], m["refs"] = {1: av, 2: ex}, [(b"cdsc", 2, [1])]
    return ac.write(m)


def _grid(n, **kw):
    tiles = [ac.parse(_pil(np.ascontiguousarray(BENCH[r:r + n, c:c + n,
                                                      ::-1]),
                           quality=90, advanced=NF))["items"][1]
             for r in (0, n) for c in (0, n)]
    items = {1: {"type": b"grid", "name": b"", "data": ac.grid(2, 2, 2 * n,
                                                               2 * n),
                 "props": [(0, ac.ispe(2 * n, 2 * n))]}}
    for i, t in enumerate(tiles):
        items[2 + i] = dict(t)
    return ac.write({"brands": [b"avif", b"\0" * 4, b"avif", b"mif1"],
                     "primary": 1, "items": items,
                     "refs": [(b"dimg", 1, [2, 3, 4, 5])]}, **kw)


#: step 0's table: (row, file maker, cv2 refuses)
STEP0 = [
    ("pillow's file", lambda: BASE, False),
    ("no pixi", lambda: _rewrap(drop=(b"pixi",)), False),
    ("no ispe", lambda: _rewrap(drop=(b"ispe",)), True),
    ("no av1C", lambda: _rewrap(drop=(b"av1C",)), True),
    ("no colr", lambda: _rewrap(drop=(b"colr",)), False),
    ("pixi depth 10", lambda: _rewrap(drop=(b"pixi",),
                                      add=[(0, ac.pixi(10, 10, 10))]), True),
    ("pixi one channel", lambda: _rewrap(drop=(b"pixi",),
                                         add=[(0, ac.pixi(8))]), False),
    ("irot 1", lambda: _rewrap(add=[(1, ac.irot(1))]), False),
    ("irot 3", lambda: _rewrap(add=[(1, ac.irot(3))]), False),
    ("imir 0", lambda: _rewrap(add=[(1, ac.imir(0))]), False),
    ("imir 1", lambda: _rewrap(add=[(1, ac.imir(1))]), False),
    ("clap", lambda: _rewrap(add=[(1, ac.clap(64, 32))]), False),
    ("clap invalid", lambda: _rewrap(add=[(1, ac.clap(63, 31, (1, 2),
                                                      (1, 2)))]), False),
    ("irot not essential", lambda: _rewrap(add=[(0, ac.irot(1))]), True),
    ("imir not essential", lambda: _rewrap(add=[(0, ac.imir(0))]), True),
    ("clap not essential", lambda: _rewrap(add=[(0, ac.clap(64, 32))]),
     True),
    ("ICC colr", lambda: _rewrap(drop=(b"colr",),
                                 add=[(0, ac.colr_icc(b"\0" * 64))]), False),
    ("nclx and ICC colr", lambda: _rewrap(add=[(0, ac.colr_icc(b"\0" * 64))]),
     False),
    ("unknown essential property", lambda: _rewrap(
        add=[(1, ac.box(b"xxxx", b"abcd"))]), True),
    ("unknown property", lambda: _rewrap(add=[(0, ac.box(b"xxxx", b"ab"))]),
     False),
    ("idat", lambda: ac.write(ac.parse(BASE), idat=True), False),
    ("three extents", lambda: ac.write(ac.parse(BASE),
                                       split={1: [100, 7]}), False),
    ("ftyp without avif", lambda: ac.write(
        ac.parse(BASE), ftyp_box=ac.ftyp(b"mif1", 0, (b"mif1",))), True),
    ("avis brand without moov", lambda: ac.write(
        ac.parse(BASE), ftyp_box=ac.ftyp(b"avis", 0, (b"avif",))), True),
    ("mdat before meta", lambda: ac.write(ac.parse(BASE), mdat_first=True),
     True),
    ("free box, meta inside 500", lambda: ac.write(
        ac.parse(BASE), before_meta=ac.box(b"free", b"\0" * 100)), False),
    ("free box, meta past 500", lambda: ac.write(
        ac.parse(BASE), before_meta=ac.box(b"free", b"\0" * 1000)), True),
    ("item data past 500", lambda: ac.write(ac.parse(BASE), gap=600), False),
    ("exif 1", lambda: _exif(b"\0" * 4 + wc.exif_payload(1)), False),
    ("exif 6 after the image", lambda: _exif(
        b"\0" * 4 + wc.exif_payload(6), first=False), True),
    ("exif bad offset", lambda: _exif(struct.pack(">I", 100)
                                      + wc.exif_payload(6)), True),
    ("exif with Exif prefix", lambda: _exif(
        struct.pack(">I", 6) + b"Exif\0\0" + wc.exif_payload(6)), False),
    ("grid 2x2 of 64 in idat", lambda: _grid(64, idat=True), False),
    ("grid descriptor past 500", lambda: _grid(64, gap=600), True),
    ("grid descriptor inside 500", lambda: _grid(64), False),
    ("grid tiles of 32", lambda: _grid(32, idat=True), True),
    ("alpha", lambda: _pil(np.dstack([CROP, np.full(CROP.shape[:2], 7,
                                                    np.uint8)]),
                           quality=90, advanced=NF), False),
    ("avis", lambda: _pil(CROP, quality=90, advanced=NF, save_all=True,
                          append_images=[Image.fromarray(
                              np.ascontiguousarray(CROP[::-1]))]), False),
]


@pytest.mark.parametrize("row", STEP0, ids=[r[0] for r in STEP0])
def test_step0_row(row, tmp_path):
    name, make, refused = row
    _as_cv2(make(), tmp_path, name, refused=refused)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, tmp_path):
    got = _as_cv2(_exif(b"\0" * 4 + wc.exif_payload(
        orientation, big_endian=orientation % 2 == 0)), tmp_path,
        orientation, refused=False)
    assert got.shape[:2] == ((128, 64) if orientation >= 5 else (64, 128))


@pytest.mark.parametrize("size", [(130, 64), (64, 32)])
def test_ispe_other_than_the_frame_is_not_yet_read(size, tmp_path):
    """libavif rescales the frame to ispe with libyuv's scaler, which
    the port does not: it refuses as not yet read."""
    ref, got = _both(_rewrap(drop=(b"ispe",), add=[(0, ac.ispe(*size))]),
                     tmp_path)
    assert ref is not None and ref.shape[:2] == size[::-1]
    assert isinstance(got, ValueError) and avif.NOT_YET in str(got)


# ------------------------------------------------------------ encoders

ENCODER = [
    dict(quality=100), dict(quality=100, subsampling="4:4:4"),
    dict(quality=97, speed=0), dict(quality=75, speed=10),
    dict(quality=40, speed=4), dict(quality=5, speed=6),
    dict(quality=80, subsampling="4:2:2"),
    dict(quality=80, subsampling="4:0:0"),
    dict(quality=80, range="limited"),
    dict(quality=85, advanced={"tune-content": "screen"}),
    dict(quality=90, advanced={"tune-content": "screen",
                               "enable-intrabc": "1"}),
    dict(quality=50, advanced={"sb-size": "128"}),
    dict(quality=60, advanced={"deltaq-mode": "2", "delta-lf-mode": "1"}),
    dict(quality=60, advanced={"cdf-update-mode": "0"}),
    dict(quality=60, advanced={"reduced-tx-type-set": "1"}),
    dict(quality=60, advanced={"enable-filter-intra": "0",
                               "enable-intra-edge-filter": "0"}),
]


@pytest.mark.parametrize("kw", ENCODER, ids=lambda k: "-".join(
    "%s=%s" % i for i in sorted(k.items()))[:60])
def test_pillow_encoder(kw, tmp_path):
    kw = dict(kw)
    kw["advanced"] = dict(NF, **kw.get("advanced", {}))
    _as_cv2(_pil(WIDE, **kw), tmp_path, kw, refused=False)


def test_pillow_tiles(tmp_path):
    data = _pil(np.ascontiguousarray(BENCH[:256, :, ::-1]), quality=50,
                speed=9, tile_rows=1, tile_cols=2, advanced=NF)
    _as_cv2(data, tmp_path, "tiles", refused=False)
    # the same frame as a frame header OBU and one tile group per tile
    _as_cv2(ac.split_tile_groups(data), tmp_path, "tile groups",
            refused=False)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("quality", [100, 60, 10])
def test_cv2_encoder_depths(depth, quality, tmp_path):
    """cv2's files (lossless at 100; lossy with the loop filter, CDEF and
    quantizer matrices switched off in the header, the tile data as
    libaom wrote it) at each depth."""
    bgr = BENCH[100:163, 200:327]
    if depth > 8:
        bgr = bgr.astype(np.uint16) * (1 << (depth - 8)) + 1
    data = _cv2_avif(bgr, quality, depth)
    if quality < 100:
        data = ac.strip_filters(data, qm=True)
    _as_cv2(data, tmp_path, (depth, quality), refused=False)


@pytest.mark.parametrize("nclx", [
    (1, 1, 1), (1, 1, 0), (2, 2, 1), (1, 5, 0), (1, 6, 1), (9, 9, 1),
    (9, 9, 0), (1, 8, 1), (1, 8, 0), (1, 4, 1), (1, 7, 0), (1, 15, 1),
    (2, 12, 1), (5, 12, 1), (9, 12, 0), (4, 12, 1), (7, 12, 0), (8, 12, 1),
    (10, 12, 1), (11, 12, 1), (12, 12, 1), (22, 12, 1), (3, 12, 1),
    (1, 3, 1), (1, 10, 1), (1, 14, 1), (1, 16, 1), (1, 0, 1)], ids=str)
def test_colour_matrices(nclx, tmp_path):
    """The conversion route and refusals per nclx (primaries, matrix,
    full range), on a 4:2:0 payload (identity refuses there)."""
    cp, mc, full = nclx
    _as_cv2(_rewrap(drop=(b"colr",), add=[(0, ac.colr_nclx(cp, 13, mc,
                                                           full))]),
            tmp_path, nclx)


@pytest.mark.parametrize("nclx", [(1, 0, 1), (1, 0, 0), (1, 8, 1),
                                  (1, 9, 0)], ids=str)
def test_colour_matrices_444(nclx, tmp_path):
    cp, mc, full = nclx
    base = _pil(CROP, quality=90, subsampling="4:4:4", advanced=NF)
    _as_cv2(_rewrap(base, drop=(b"colr",),
                    add=[(0, ac.colr_nclx(cp, 13, mc, full))]),
            tmp_path, nclx, refused=False)


@pytest.mark.parametrize("depth", [10, 12])
def test_deep_grey(depth, tmp_path):
    grey = BENCH[100:163, 200:327, 1].astype(np.uint16)
    data = _cv2_avif(grey * (1 << (depth - 8)) + 3, 80, depth)
    _as_cv2(ac.strip_filters(data, qm=True), tmp_path, depth, refused=False)


def _random_case(rng):
    h, w = int(rng.integers(1, 160)), int(rng.integers(1, 240))
    r, c = int(rng.integers(0, 512 - h)), int(rng.integers(0, 1024 - w))
    img = np.ascontiguousarray(BENCH[r:r + h, c:c + w, ::-1])
    if rng.random() < 0.3:
        pal = rng.integers(0, 256, (int(rng.integers(2, 9)), 3), np.uint8)
        img = pal[(img.astype(np.int64).sum(-1) * len(pal)) // 766]
    opts = [{}, {"tune-content": "screen"},
            {"tune-content": "screen", "enable-intrabc": "1"},
            {"sb-size": "128"}, {"deltaq-mode": "2"},
            {"reduced-tx-type-set": "1"}, {"enable-tx64": "0"},
            {"max-partition-size": "32"}]
    kw = dict(quality=int(rng.integers(0, 101)), speed=int(rng.integers(0, 11)),
              subsampling=str(rng.choice(["4:2:0", "4:4:4", "4:2:2",
                                          "4:0:0"])),
              advanced=dict(NF, **opts[int(rng.integers(0, len(opts)))]))
    return _pil(img, **kw), (h, w, kw)


@pytest.mark.parametrize("seed", range(6))
def test_random_encoder_cases(seed, tmp_path):
    rng = np.random.default_rng(seed)
    data, where = _random_case(rng)
    _as_cv2(data, tmp_path, where, refused=False)


@pytest.mark.slow
def test_random_encoder_cases_all(tmp_path):
    rng = np.random.default_rng(100)
    for _ in range(300):
        data, where = _random_case(rng)
        _as_cv2(data, tmp_path, where, refused=False)


# ------------------------------------------------------------- not yet

@pytest.mark.parametrize("case", ["cv2 q90", "cdef", "filters", "restoration"])
def test_later_tools_are_not_yet_read(case, tmp_path):
    """Frames whose output the in-loop filters or quantizer matrices
    would change raise "not yet read", naming the tools; cv2 reads them."""
    if case == "cv2 q90":
        data, names = _cv2_avif(BENCH[:64, :128], 90), (
            "quantizer matrices", "the deblocking filter")
    elif case == "cdef":
        data, names = ac.strip_filters(_cv2_avif(BENCH[128:256, 256:512], 50),
                                       cdef=False, qm=True), ("CDEF",)
    elif case == "filters":
        data, names = _pil(WIDE, quality=60), ("the deblocking filter",)
    else:
        data, names = _pil(WIDE, quality=30, speed=0, advanced={
            "enable-restoration": "1", "loopfilter-control": "0",
            "enable-cdef": "0"}), ()
    ref, got = _both(data, tmp_path)
    assert ref is not None
    if not isinstance(got, ValueError):  # the encoder chose no restoration
        np.testing.assert_array_equal(got, ref)
        return
    assert avif.NOT_YET in str(got)
    for n in names:
        assert n in str(got), (n, got)


# ------------------------------------------------------- corrupt files

CORRUPT = {
    "pillow": lambda: BASE,
    "cv2 lossless": lambda: _cv2_avif(BENCH[192:256, 384:512], 100),
    "screen": lambda: _pil(CROP, quality=80, advanced=dict(
        NF, **{"tune-content": "screen"})),
}


def _corruptions(data, rng, n):
    out = [data[:k] for k in sorted(set(rng.integers(0, len(data), n)))]
    for _ in range(n):
        d = bytearray(data)
        d[int(rng.integers(0, len(d)))] ^= 1 << int(rng.integers(0, 8))
        out.append(bytes(d))
    return out


@pytest.mark.parametrize("kind", sorted(CORRUPT))
def test_corrupt_files_as_cv2(kind, tmp_path):
    rng = np.random.default_rng(sorted(CORRUPT).index(kind))
    for k, data in enumerate(_corruptions(CORRUPT[kind](), rng, 12)):
        ref, got = _both(data, tmp_path)
        if ref is None:
            assert isinstance(got, ValueError), (kind, k)
        elif not (isinstance(got, ValueError) and avif.NOT_YET in str(got)):
            np.testing.assert_array_equal(got, ref, err_msg=str((kind, k)))


def test_header_bit_flips_as_cv2(tmp_path):
    """Every bit of the boxes and OBU headers of one file flipped in turn
    (a sample here; the slow twin flips them all): cv2 and the port
    refuse or read alike, bar the ispe sizes libavif rescales to."""
    rng = np.random.default_rng(7)
    for pos in sorted(rng.choice(330, 40, replace=False)):
        d = bytearray(BASE)
        d[pos] ^= 1 << int(rng.integers(0, 8))
        ref, got = _both(bytes(d), tmp_path)
        if ref is None:
            assert isinstance(got, ValueError), pos
        elif not isinstance(got, ValueError) or avif.NOT_YET not in str(got):
            np.testing.assert_array_equal(got, ref, err_msg=str(pos))


AVIS = os.path.join(FIX, "matrix", "avis.avif")


def _moov_flips(rng=None, n=None):
    with open(AVIS, "rb") as f:
        data = f.read()
    (a, b), = [(x - 8, y) for t, x, y in ac.boxes(data) if t == b"moov"]
    cells = [(p, bit) for p in range(a, b) for bit in range(8)]
    if rng is not None:
        cells = [cells[i] for i in rng.choice(len(cells), n, replace=False)]
    for p, bit in cells:
        d = bytearray(data)
        d[p] ^= 1 << bit
        yield (p, bit), bytes(d)


def _as_cv2_or_rescaled(data, tmp_path, where):
    """As _as_cv2, but where libavif rescales to the track's or ispe's
    size the port says "not yet read"."""
    ref, got = _both(data, tmp_path)
    if ref is None:
        assert isinstance(got, ValueError), where
    elif isinstance(got, ValueError):
        assert "rescales" in str(got) and avif.NOT_YET in str(got), where
    else:
        np.testing.assert_array_equal(got, ref, err_msg=str(where))


def test_avis_moov_bit_flips_as_cv2(tmp_path):
    """Bits of an avis file's moov flipped (a sample; the slow twin flips
    them all): libavif's track checks, held to cv2."""
    for where, data in _moov_flips(np.random.default_rng(5), 60):
        _as_cv2_or_rescaled(data, tmp_path, where)


@pytest.mark.slow
def test_avis_moov_bit_flips_as_cv2_all(tmp_path):
    for where, data in _moov_flips():
        _as_cv2_or_rescaled(data, tmp_path, where)


@pytest.mark.slow
def test_corrupt_files_as_cv2_all(tmp_path):
    for kind in sorted(CORRUPT):
        data = CORRUPT[kind]()
        rng = np.random.default_rng(99)
        variants = _corruptions(data, rng, 150)
        for pos in range(min(len(data), 330)):
            for bit in range(8):
                d = bytearray(data)
                d[pos] ^= 1 << bit
                variants.append(bytes(d))
        for k, v in enumerate(variants):
            ref, got = _both(v, tmp_path)
            if ref is None:
                assert isinstance(got, ValueError), (kind, k)
            elif not (isinstance(got, ValueError)
                      and avif.NOT_YET in str(got)):
                np.testing.assert_array_equal(got, ref, err_msg=str((kind, k)))


# ----------------------------------------------------------- constants

def _cv2_lib(stem):
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    found = sorted(glob.glob(os.path.join(libs, stem + "-*.so*")))
    if not found:
        pytest.skip("cv2's bundled %s is absent" % stem)
    return found[0]


def _tables():
    """[(name, C type, values, comment)] of avif.cc's generated block."""
    with open(avif.SRC) as f:
        src = f.read()
    block = src[src.index("// ---- tables"):src.index("// ---- end of tables")]
    out = []
    for m in re.finditer(r"// ([^\n]*)\nstatic const (\w+) (\w+)((?:\[\d+\])+)"
                         r" = \{([^}]*)\};", block):
        vals = [int(v) for v in m.group(5).replace("\n", " ").split(",")]
        out.append((m.group(3), m.group(2), vals, m.group(1)))
    return out


DT = {"uint16_t": "<u2", "int16_t": "<i2", "uint8_t": "u1", "int8_t": "i1",
      "int32_t": "<i4"}


def test_tables_found_in_cv2_libaom():
    """Every table avif.cc holds lies in cv2's libaom: the named ones
    byte for byte at the offset their comment gives, the small CDFs row
    by row (their inverted probabilities, whole or in pieces)."""
    aom = open(_cv2_lib("libaom"), "rb").read()
    tables = _tables()
    assert len(tables) > 80
    for name, ctype, vals, comment in tables:
        raw = np.array(vals, DT[ctype]).tobytes()
        m = re.search(r"@0x([0-9a-f]+) \((\d+) bytes\)", comment)
        if m:
            off = int(m.group(1), 16)
            assert aom[off:off + len(raw)] == raw, name
        elif name.startswith("kLibyuv"):
            continue
        else:
            assert "AV1 spec default CDF" in comment, name
            per = {"kTxSizeCdf": 4}.get(name)
            rows = np.array(vals).reshape(-1, per or _row_len(name))
            for r in rows:
                inv = [int(x) for x in r if x]
                assert _row_found(aom, inv), (name, inv)


def _row_len(name):
    return {"kSkipCdf": 3, "kIntrabcCdf": 3, "kDeltaQCdf": 5,
            "kDeltaLfCdf": 5, "kDeltaLfMultiCdf": 5, "kSpatialSegCdf": 9,
            "kFilterIntraCdf": 3, "kFilterIntraModeCdf": 6,
            "kCflSignCdf": 9, "kCflAlphaCdf": 17, "kTxfmSplitCdf": 3,
            "kPaletteYSizeCdf": 8, "kPaletteUvSizeCdf": 8,
            "kPaletteYModeCdf": 3, "kPaletteUvModeCdf": 3,
            "kAngleDeltaCdf": 8}[name]


def _row_found(binary, inv):
    def has(a, b):
        return binary.count(struct.pack("<%dH" % (b - a), *inv[a:b])) > 0
    ok = [True] + [False] * len(inv)
    for b in range(1, len(inv) + 1):
        ok[b] = any(ok[a] and (b - a >= 3 or (a, b) == (0, len(inv)))
                    and has(a, b) for a in range(b))
    return ok[-1]


def test_base_context_rule_equals_cv2_libaom():
    """avif.cc computes the coefficient base-context offsets by libaom's
    rule; the rule equals cv2's libaom arrays wherever they have a
    symbol."""
    import make_avif_tables as mt
    path = _cv2_lib("libaom")
    syms = mt.symbols(path)
    aom = open(path, "rb").read()
    seen = 0
    for s in mt.TX_SIZES:
        sym = "av1_nz_map_ctx_offset_" + s
        if sym in syms:
            w, h = map(int, s.split("x"))
            addr, size = syms[sym]
            assert list(np.frombuffer(aom[addr:addr + size], "i1")) == \
                mt.nz_map_offsets(w, h), s
            seen += 1
    assert seen >= 12


def test_libyuv_constants_equal_cv2_libavif():
    import make_avif_tables as mt
    path = _cv2_lib("libavif")
    table = dict((n, v) for n, _, v in mt.libyuv_constants(path))
    vals = dict((t[0], t[2]) for t in _tables())["kLibyuvConstants"]
    assert vals == [v for n in mt.LIBYUV for v in table[n]]


@pytest.mark.parametrize("fmt", ["444", "422", "420"])
def test_conversion_equals_libyuv(fmt):
    """The port's libyuv route against libyuv's own I4xxToRGB24Matrix
    (Filter, bilinear) in cv2's libavif, on random planes of odd size."""
    import ctypes
    lib = ctypes.CDLL(_cv2_lib("libavif"))
    rng = np.random.default_rng(3)
    w, h = 37, 23
    cw = w if fmt == "444" else (w + 1) // 2
    ch = (h + 1) // 2 if fmt == "420" else h
    planes = [rng.integers(0, 256, s, np.uint8) for s in
              ((h, w), (ch, cw), (ch, cw))]
    for k, name in enumerate(("kYuvJPEGConstants", "kYuvH709Constants",
                              "kYuv2020Constants")):
        out = np.zeros((h, w, 3), np.uint8)
        args = []
        for p in planes:
            args += [p.ctypes.data_as(ctypes.c_void_p),
                     ctypes.c_int(p.shape[1])]
        args += [out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(w * 3),
                 ctypes.c_void_p(ctypes.addressof(ctypes.c_char.in_dll(
                     lib, name))), ctypes.c_int(w), ctypes.c_int(h)]
        fn = {"444": "I444ToRGB24Matrix", "422": "I422ToRGB24MatrixFilter",
              "420": "I420ToRGB24MatrixFilter"}[fmt]
        if fmt != "444":
            args.append(ctypes.c_int(1))
        getattr(lib, fn)(*args)
        mc, full = ((6, 1), (1, 0), (9, 0))[k]
        info = {"width": w, "height": h, "depth": 8, "mono": 0,
                "ssx": int(fmt != "444"), "ssy": int(fmt == "420")}
        got = avif._to_rgb(info, [p.astype(np.uint16) for p in planes],
                           (1, 13, mc, full))
        np.testing.assert_array_equal(got, out[..., ::-1], err_msg=name)


# ------------------------------------------------------------ coverage

def test_coverage_over_the_fixtures():
    """The fixtures reach every tool but those PERF.md lists as unreached
    (no encoder at hand writes them)."""
    names = avif.counter_names()
    total = np.zeros(len(names), np.int64)
    for rel in DIGESTS:
        with open(os.path.join(FIX, rel), "rb") as f:
            data = f.read()
        counts = np.zeros(len(names), np.int64)
        try:
            avif.read_avif(data, counts)
        except Exception:
            pass
        total += counts
    unreached = {n for n, v in zip(names, total) if not v}
    assert unreached == {
        "block_64x128", "block_128x64", "block_16x64", "block_64x16",
        "segment_id_read", "tx_16x64", "tx_64x16",
        "txtype_flipadst_flipadst", "intra_only_frame"}, unreached


# ------------------------------------------------------------ dispatch

def test_dispatch_as_cv2(tmp_path):
    """An AVIF file read through imread_rgb whatever its name; a file
    cv2 does not take for AVIF (no avif/avis brand) raises."""
    for name in ("x.png", "x.avif", "x"):
        ref, got = _both(BASE, tmp_path, name)
        np.testing.assert_array_equal(got, ref)
    ref, got = _both(ac.write(ac.parse(BASE), ftyp_box=ac.ftyp(
        b"heic", 0, (b"mif1", b"heic"))), tmp_path)
    assert ref is None and isinstance(got, ValueError)


def test_avif_decoder_links_no_library():
    with open(avif.SRC) as f:
        src = f.read()
    includes = set(re.findall(r"#include <([^>]+)>", src))
    assert includes <= {"algorithm", "cstdarg", "cstdint", "cstdio",
                        "cstdlib", "cstring", "memory", "string", "vector"}
    assert "-l" not in " ".join(avif.CXX_FLAGS)
    out = subprocess.run(["nm", "-D", "--undefined-only", avif.build()],
                         capture_output=True, text=True).stdout
    assert not re.search(r"aom_|dav1d|avif[A-Z]|libyuv", out)
