"""The port's readers of the raster containers cv2.imread reads besides
PNG and JPEG (`mergenet_tpu_torch/data/{tiff,bmp,pxm,sunras,hdr,gif}.py`
and `native/codecs.cc`), against cv2, whose decoders the JAX package
reads images with: every array bit for bit equal to `cv2.cvtColor(
cv2.imread(path), cv2.COLOR_BGR2RGB)`, and a ValueError naming the file
wherever cv2 returns None.

- the committed files (`tests/fixtures/images/`, written by
  `tests/make_container_fixtures.py`) against their recorded cv2
  digests, and the digests against this cv2;
- files written by `container_craft` in the layouts cv2 does not write
  (TIFF tiles, planes, palettes, 1-16 bits, every photometric
  interpretation cv2 reads, extra samples, LZW old and new, PackBits,
  Deflate, predictor 2, II/MM/BigTIFF and the Orientation tag; BMP
  headers, depths, bitfields and RLE op sequences drawn from a seeded
  generator; PxM comments, separators and maxvals, PAM tuple types,
  PFM scales and non-finite values; Sun raster types and colour maps;
  HDR run lengths, header lines and size lines; GIF tables, interlace,
  transparency, frames smaller than the screen), and the same through
  cv2's own writers;
- the dispatch on the file's first bytes, and the containers the port
  does not read yet (AVIF, TIFF JPEG; WebP and JPEG 2000, read since,
  equal to cv2);
- the smoke's lossless split layouts (`container_craft.LAYOUTS`) read
  back as the PNG pixels;
- the JAX package's datasets, test set and grain records against the
  port's on a split written in those layouts, and on a split of PNGs
  turned by their eXIf chunks."""

import contextlib
import hashlib
import io as _io
import json
import os

import cv2
import numpy as np
import pytest

import container_craft as cc
from mergenet_tpu_torch.data import imgproc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "images")


def _both(data, tmp_path, ext):
    """(cv2's RGB or None, the port's RGB or its ValueError) of the file
    bytes `data`, written under the extension `ext`.  cv2.imread raising
    (it does for a PFM of height 0) counts as refusing."""
    path = str(tmp_path / ("c" + ext))
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = cv2.imread(path)
    except cv2.error:
        ref = None
    try:
        got = imgproc.imread_rgb(path)
    except ValueError as e:
        assert path in str(e), e
        got = e
    return (None if ref is None else ref[..., ::-1]), got


def _assert_as_cv2(data, tmp_path, ext, where=""):
    ref, got = _both(data, tmp_path, ext)
    if ref is None:
        assert isinstance(got, ValueError), (where, "cv2 refuses, port reads")
    else:
        assert not isinstance(got, ValueError), (where, got)
        assert got.dtype == np.uint8 and got.shape == ref.shape, where
        np.testing.assert_array_equal(got, ref, err_msg=str(where))


# ------------------------------------------------------------- the fixtures

with open(os.path.join(FIX, "cv2_digests.json")) as _f:
    DIGESTS = json.load(_f)


def _digest(img):
    return [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_committed_fixture_equals_cv2_digest(rel):
    path = os.path.join(FIX, rel)
    want = [DIGESTS[rel]["shape"], DIGESTS[rel]["sha256"]]
    assert _digest(cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)) \
        == want, "stale fixture: rerun tests/make_container_fixtures.py"
    assert _digest(imgproc.imread_rgb(path)) == want


# --------------------------------------------------------------------- TIFF

#: (bits, samples per pixel, photometric): every kind cv2 reads, and
#: the ones it refuses (2-, 4-bit grey, 12-, 32-bit, 1-bit RGB)
TIFF_KINDS = [(8, 1, 1), (8, 1, 0), (16, 1, 1), (16, 1, 0), (1, 1, 1),
              (1, 1, 0), (8, 3, 2), (16, 3, 2), (8, 4, 2), (16, 4, 2),
              (8, 2, 1), (8, 2, 0), (8, 4, 5), (8, 5, 5), (16, 4, 5),
              (2, 1, 1), (4, 1, 1), (12, 1, 1), (32, 3, 2), (1, 3, 2),
              (8, 2, 2), (8, 3, 1), (16, 2, 1)]
#: (compression, predictor, layout): strips, tiles with clipped edges,
#: byte orders and BigTIFF; 6005 is old-style LZW
TIFF_LAYOUTS = [(1, 1, {}), (5, 1, dict(rows_per_strip=4)),
                (5, 2, dict(tile=(16, 16))),
                (8, 2, dict(rows_per_strip=7)),
                (32773, 1, dict(tile=(16, 32))),
                (32946, 1, dict(big_endian=True, rows_per_strip=5)),
                (6005, 1, dict(bigtiff=True)),
                (32773, 2, dict(big_endian=True, bigtiff=True,
                                tile=(32, 16)))]


@pytest.mark.parametrize("bits,spp,photometric", TIFF_KINDS)
def test_tiff_kinds_and_layouts_as_cv2(bits, spp, photometric, tmp_path):
    rng = np.random.default_rng(bits * 100 + spp * 10 + photometric)
    s = rng.integers(0, 1 << bits, (19, 23, spp))
    for planar in (1, 2):
        for extra in (None, [0], [1], [2]):
            if extra is not None and spp < 2:
                continue
            for comp, pred, layout in TIFF_LAYOUTS:
                if pred == 2 and bits not in (8, 16):
                    continue
                where = (planar, extra, comp, pred, layout)
                _assert_as_cv2(cc.tiff_bytes(
                    s, bits=bits, photometric=photometric, planar=planar,
                    extra_samples=extra, compression=comp, predictor=pred,
                    **layout), tmp_path, ".tif", where)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_tiff_palette_as_cv2(bits, tmp_path):
    """8- and 16-bit colour maps (libtiff takes a map whose entries are
    all below 256 as 8-bit); 2- and 16-bit palettes cv2 refuses."""
    rng = np.random.default_rng(bits)
    s = rng.integers(0, 1 << bits, (19, 23, 1))
    for top in (256, 65536):
        cm = rng.integers(0, top, (1 << bits, 3))
        for comp, pred, layout in TIFF_LAYOUTS:
            _assert_as_cv2(cc.tiff_bytes(s, bits=bits, photometric=3,
                                         colormap=cm, compression=comp,
                                         **layout), tmp_path, ".tif",
                           (top, comp, layout))


@pytest.mark.parametrize("size", [(12, 10), (16, 16), (33, 33), (40, 50),
                                  (17, 33)])
def test_tiff_orientation_as_cv2(size, tmp_path):
    """Orientations 0-9 on strips and tiles: libtiff's block flips and
    cv2's placement (tiles mirrored in place), and orientations 5-8,
    which cv2 survives on square images only."""
    rng = np.random.default_rng(size[0] * size[1])
    for layout in ({}, dict(rows_per_strip=5), dict(tile=(16, 16)),
                   dict(tile=(16, 32))):
        for bits, spp, ph in ((8, 3, 2), (16, 1, 1), (8, 2, 1), (1, 1, 0)):
            s = rng.integers(0, 1 << bits, size + (spp,))
            for o in range(10):
                _assert_as_cv2(cc.tiff_bytes(s, bits=bits, photometric=ph,
                                             orientation=o, **layout),
                               tmp_path, ".tif", (layout, bits, spp, o))


def test_tiff_cv2_written_and_multipage_as_cv2(tmp_path):
    """cv2's own TIFFs (each compression it writes, predictor 2, 8- and
    16-bit), the first page of a multi-page file, and LZW long enough to
    fill and reset the code table."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (37, 53, 3), np.uint8)
    img[:, :20] = img[:1, :20]
    C = cv2.IMWRITE_TIFF_COMPRESSION
    for params in ([C, 1], [C, 5], [C, 8], [C, 32946], [C, 32773],
                   [C, 5, cv2.IMWRITE_TIFF_PREDICTOR, 2],
                   [C, 8, cv2.IMWRITE_TIFF_ROWSPERSTRIP, 3]):
        for a in (img, img[..., 0], img.astype(np.uint16) * 251):
            ok, enc = cv2.imencode(".tif", a, params)
            assert ok
            _assert_as_cv2(enc.tobytes(), tmp_path, ".tif", params)
    ok, enc = cv2.imencodemulti(".tif", [img, img[::-1]])
    assert ok
    _assert_as_cv2(enc.tobytes(), tmp_path, ".tif", "multi")
    _assert_as_cv2(cc.tiff_bytes(img, pages=3, compression=5), tmp_path,
                   ".tif", "pages")
    noise = rng.integers(0, 256, (160, 200, 3))
    for comp in (5, 6005):
        _assert_as_cv2(cc.tiff_bytes(noise, compression=comp), tmp_path,
                       ".tif", ("noise", comp))


def test_tiff_not_yet_read(tmp_path):
    """No TIFF cv2 reads raises as not yet read by the port any more:
    SGILog24 (34677), the last of them, reads as cv2 reads it; the codecs
    cv2's libtiff is built without
    (old-style JPEG, PixarLog, LZMA, ZSTD, WebP, JBIG, LERC) raise as cv2
    refuses them, and those libtiff has no decoder for (cv2 returns a
    black image) raise naming that.  JPEG (7) and CCITT (2, 3, 4) data
    that is not theirs raise as cv2 refuses it or returns what it could
    not decode."""
    img = np.zeros((16, 16, 3), np.uint8)

    def with_compression(comp, **kw):
        b = cc.tiff_bytes(img, compression=1, **kw)
        return b.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                         b"\x03\x01\x03\x00\x01\x00\x00\x00"
                         + comp.to_bytes(2, "little"))

    ref, got = _both(with_compression(34677, photometric=32845), tmp_path,
                     ".tif")
    np.testing.assert_array_equal(got, ref)
    for comp in (6, 32909, 34925, 50000, 50001, 34661, 34887):
        ref, got = _both(with_compression(comp), tmp_path, ".tif")
        assert ref is None and "cv2 does not read" in str(got), (comp, got)
    for comp in (34712, 32908, 32947, 9):
        ref, got = _both(with_compression(comp), tmp_path, ".tif")
        assert ref is not None and not ref.any(), comp
        assert "libtiff has no decoder" in str(got), (comp, got)
    for comp in (7, 3, 4, 34676):
        ref, got = _both(with_compression(comp), tmp_path, ".tif")
        assert isinstance(got, ValueError), comp
        assert ref is None or not ref.any(), comp


# ---------------------------------------------------------------------- BMP

@pytest.mark.parametrize("header", [12, 40, 64, 108, 124])
def test_bmp_headers_and_depths_as_cv2(header, tmp_path):
    """Every depth and compression cv2 reads under each header, bottom-up
    and top-down, short palettes, 16-bit masks cv2 takes or refuses,
    32-bit channel masks (read from V4/V5 headers only)."""
    rng = np.random.default_rng(header)
    for H, W in ((7, 9), (1, 1), (5, 33)):
        rgb = rng.integers(0, 256, (H, W, 3))
        for td in (False, True):
            _assert_as_cv2(cc.bmp_bytes(rgb[..., ::-1], 24, header=header,
                                        top_down=td), tmp_path, ".bmp")
            for bpp in (1, 4, 8):
                idx = rng.integers(0, 1 << bpp, (H, W))
                for n in (1 << bpp, (1 << bpp) // 2 + 1, 1):
                    _assert_as_cv2(cc.bmp_bytes(
                        idx, bpp, header=header, top_down=td,
                        palette=rng.integers(0, 256, (n, 3)),
                        colors_used=None if header == 12 else n),
                        tmp_path, ".bmp", (bpp, n, td))
            p16 = rng.integers(0, 65536, (H, W))
            p32 = rng.integers(0, 2 ** 32, (H, W), dtype=np.uint64)
            cases = [(p32, 32, 0, None)]
            if header != 12:
                cases += [(p16, 16, c, m) for c, m in (
                    (0, None), (3, (0x7C00, 0x3E0, 0x1F)),
                    (3, (0xF800, 0x7E0, 0x1F)), (3, (0x1F, 0x7E0, 0xF800)))]
                cases += [(p32, 32, 3, m) for m in (
                    (0xFF0000, 0xFF00, 0xFF, 0), (0xFF, 0xFF00, 0xFF0000, 0),
                    (0x3FF00000, 0xFFC00, 0x3FF, 0), (0xF00000, 0xF000,
                                                       0xF0, 0),
                    (0xFF0000, 0, 0xFF, 0), (0xFF00, 0xFF0000, 0xFF000000,
                                             0xFF))]
            for pix, bpp, comp, masks in cases:
                _assert_as_cv2(cc.bmp_bytes(pix, bpp, header=header,
                                            top_down=td, compression=comp,
                                            masks=masks),
                               tmp_path, ".bmp", (bpp, comp, masks, td))


def _rle_ops(rng, bpp, W):
    ops = []
    for _ in range(int(rng.integers(1, 25))):
        k = rng.random()
        if k < 0.35:
            v = int(rng.integers(0, 1 << bpp))
            if bpp == 4 and rng.random() < 0.5:
                v = (int(rng.integers(0, 16)), int(rng.integers(0, 16)))
            ops.append(("run", int(rng.integers(1, W + 2)), v))
        elif k < 0.6:
            ops.append(("abs", rng.integers(0, 1 << bpp, int(
                rng.integers(3, W + 3))).tolist()))
        elif k < 0.8:
            ops.append(("eol",))
        elif k < 0.92:
            ops.append(("delta", int(rng.integers(0, W + 1)),
                        int(rng.integers(0, 3))))
        else:
            ops.append(("eob",))
    if rng.random() < 0.8:
        ops.append(("eob",))
    return ops


@pytest.mark.parametrize("bpp", [4, 8])
@pytest.mark.parametrize("seed", range(4))
def test_bmp_rle_op_sequences_as_cv2(bpp, seed, tmp_path):
    """Seeded RLE8/RLE4 streams of runs, absolute runs, end-of-line,
    delta and end-of-bitmap, valid or not (runs past their row, data that
    ends early), and the writer's own RLE of images with runs."""
    rng = np.random.default_rng(seed * 10 + bpp)
    for _ in range(400):
        H, W = int(rng.integers(1, 9)), int(rng.integers(1, 20))
        n = int(rng.integers(1, 1 << bpp)) if rng.random() < 0.3 \
            else 1 << bpp
        ops = _rle_ops(rng, bpp, W)
        _assert_as_cv2(cc.bmp_bytes(
            np.zeros((H, W), np.uint8), bpp, compression=1 if bpp == 8
            else 2, palette=rng.integers(0, 256, (n, 3)), rle_ops=ops,
            top_down=rng.random() < 0.2), tmp_path, ".bmp", (H, W, ops))
    for _ in range(25):
        H, W = int(rng.integers(1, 12)), int(rng.integers(1, 40))
        idx = np.minimum(rng.integers(0, 3, (H, W)) + rng.integers(
            0, 1 << bpp) * (rng.random((H, W)) < 0.2), (1 << bpp) - 1)
        _assert_as_cv2(cc.bmp_bytes(idx, bpp, compression=1 if bpp == 8
                                    else 2, palette=rng.integers(
                                        0, 256, (1 << bpp, 3))),
                       tmp_path, ".bmp", (H, W))


# ---------------------------------------------------------- PBM/PGM/PPM/PAM

@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5, 6])
def test_pnm_as_cv2(kind, tmp_path):
    """Sizes, maxvals (scaled in ASCII, not in binary), comments after
    any header number and inside an ASCII raster, separators, values past
    maxval, cv2's own files, and the magic without whitespace after it
    (refused)."""
    rng = np.random.default_rng(kind)
    ch = 3 if kind in (3, 6) else 1
    for H, W in ((3, 4), (1, 1), (5, 9)):
        for maxval in ((1,) if kind in (1, 4)
                       else (255, 1, 2, 100, 256, 1000, 65535)):
            s = rng.integers(0, maxval + 1, (H, W, ch) if ch == 3
                             else (H, W))
            for comments in ((), (("magic", "hi"),),
                             (("width", "x y"), ("maxval", "z"))):
                for sep in (b"\n", b" ", b"\t\r\n"):
                    _assert_as_cv2(cc.pnm_bytes(s, kind, maxval,
                                                comments=comments, sep=sep),
                                   tmp_path, ".pnm",
                                   (H, W, maxval, comments, sep))
            if kind in (2, 3):
                b = cc.pnm_bytes(s, kind, maxval)
                _assert_as_cv2(b.replace(b"\n", b"\n# c\n", 3), tmp_path,
                               ".pnm", "raster comment")
                _assert_as_cv2(cc.pnm_bytes(s + maxval // 2 + 1, kind,
                                            maxval), tmp_path, ".pnm",
                               "past maxval")
    _assert_as_cv2(b"P%d#c\n2 1 255\n" % kind + bytes(6), tmp_path, ".pnm",
                   "no space after the magic")
    img = rng.integers(0, 256, (11, 13, 3), np.uint8)
    a = img if ch == 3 else img[..., 0] // 128 * 255 if kind in (1, 4) \
        else img[..., 0]
    ext = {1: ".pbm", 4: ".pbm", 2: ".pgm", 5: ".pgm"}.get(kind, ".ppm")
    ok, enc = cv2.imencode(ext, a, [cv2.IMWRITE_PXM_BINARY,
                                    int(kind >= 4)])
    assert ok
    _assert_as_cv2(enc.tobytes(), tmp_path, ext, "cv2's")


def test_pam_as_cv2(tmp_path):
    """Tuple types and depths, maxvals (1 reads bits), headers with
    comments, tabs, CR line breaks, unknown or lower-case keys, a
    repeated TUPLTYPE; cv2's own PAM."""
    rng = np.random.default_rng(7)
    for H, W in ((3, 4), (1, 1), (5, 9)):
        for depth, tupl in ((1, "GRAYSCALE"), (1, "BLACKANDWHITE"),
                            (3, "RGB"), (1, None), (3, None), (2, None),
                            (3, "GRAYSCALE")):
            for maxval in (255, 1, 2, 100, 256, 65535):
                s = rng.integers(0, maxval + 1, (H, W, depth))
                _assert_as_cv2(cc.pam_bytes(s, maxval, tupl), tmp_path,
                               ".pam", (H, W, depth, tupl, maxval))
    for head in (b"P7WIDTH 1\n", b"P7 \nWIDTH 1\n", b"P7\r\nWIDTH 1\r\n",
                 b"P7\n# hi\nWIDTH 1\n#x\n", b"P7\nwidth 1\n",
                 b"P7\nWIDTH\t1\n", b"P7\nWIDTH 1 \n",
                 b"P7\nFOO 3\nWIDTH 1\n"):
        for tail in (b"HEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n\x05",
                     b"HEIGHT 1\nDEPTH 1\nMAXVAL 255\nTUPLTYPE GRAYSCALE\n"
                     b"TUPLTYPE RGB\nENDHDR\n\x05",
                     b"HEIGHT 1\nMAXVAL 255\nENDHDR\n\x05"):
            _assert_as_cv2(head + tail, tmp_path, ".pam", head + tail)
    ok, enc = cv2.imencode(".pam", rng.integers(0, 256, (9, 7, 3),
                                                np.uint8))
    assert ok
    _assert_as_cv2(enc.tobytes(), tmp_path, ".pam", "cv2's")


def test_pam_with_alpha_refused_where_cv2_is_not_deterministic(tmp_path):
    """cv2's reads of GRAYSCALE_ALPHA and RGB_ALPHA return memory it never
    wrote (two reads of the same file in two processes differ): the port
    refuses them."""
    rng = np.random.default_rng(8)
    for depth, tupl in ((2, "GRAYSCALE_ALPHA"), (4, "RGB_ALPHA")):
        _, got = _both(cc.pam_bytes(rng.integers(0, 256, (5, 7, depth)),
                                    255, tupl), tmp_path, ".pam")
        assert isinstance(got, ValueError) and "run to run" in str(got)


def test_pfm_as_cv2(tmp_path):
    """Byte orders, scales (the values divided by |scale|), values past
    255, NaN and infinities, 2^31 and past, grey PFMs (refused), header
    separators; cv2's own PFM."""
    rng = np.random.default_rng(9)
    for H, W in ((3, 4), (1, 1), (5, 9)):
        for ch in (1, 3):
            f = (rng.random((H, W, ch) if ch == 3 else (H, W)) * 300
                 - 20).astype(np.float32)
            f.flat[0] = 2.5
            if f.size > 4:
                f.flat[1:5] = (np.nan, np.inf, -np.inf, 3e9)
            for scale in (-1.0, 1.0, -2.5, 3.0, -0.3):
                _assert_as_cv2(cc.pfm_bytes(f, scale), tmp_path, ".pfm",
                               (H, W, ch, scale))
    body = bytes(24)
    for head in (b"PF\n2 1\n-1\n", b"PF 2 1 -1\n", b"PF2 1\n-1\n",
                 b"PF\n2  1\n-1\n", b"PF\n2 1\n-1.0e0\n"):
        _assert_as_cv2(head + body, tmp_path, ".pfm", head)
    ok, enc = cv2.imencode(".pfm", rng.random((9, 7, 3)).astype(
        np.float32) * 300)
    assert ok
    _assert_as_cv2(enc.tobytes(), tmp_path, ".pfm", "cv2's")


# --------------------------------------------------------------- Sun raster

def test_sunras_as_cv2(tmp_path):
    """Depths 1, 8, 24, 32, types 0-3 (cv2 refuses the byte-encoded and
    RGB types), colour maps of every length and type, truncated data,
    odd widths (rows padded to 16 bits); cv2's own files."""
    rng = np.random.default_rng(10)
    for H, W in ((3, 5), (2, 8), (1, 1), (4, 17)):
        rgb = rng.integers(0, 256, (H, W, 3))
        for depth in (1, 8, 24, 32):
            pix = rgb if depth > 8 else rng.integers(0, 1 << depth, (H, W))
            for kind in (0, 1, 2, 3):
                for n in (None, 2, 10, 256):
                    if n is not None and depth <= 8 and n > 1 << depth:
                        continue
                    cmap = None if n is None else rng.integers(0, 256,
                                                               (n, 3))
                    for maptype in ((None, 2) if n else (None,)):
                        _assert_as_cv2(cc.sunras_bytes(
                            pix, depth, ras_type=kind, colormap=cmap,
                            maptype=maptype), tmp_path, ".ras",
                            (H, W, depth, kind, n, maptype))
            _assert_as_cv2(cc.sunras_bytes(pix, depth)[:-1], tmp_path,
                           ".ras", "truncated")
    for a in (rng.integers(0, 256, (9, 7, 3), np.uint8),
              rng.integers(0, 256, (9, 7), np.uint8)):
        ok, enc = cv2.imencode(".ras", a)
        assert ok
        _assert_as_cv2(enc.tobytes(), tmp_path, ".ras", "cv2's")


# --------------------------------------------------------------------- HDR

def test_hdr_as_cv2(tmp_path):
    """New-style runs, old-style runs (not run lengths to rgbe.cpp), flat
    RGBE; widths below 8; both magics and an unknown one; size lines cv2
    takes or refuses; header lines before and after FORMAT; exponents
    that underflow and overflow; cv2's own files."""
    rng = np.random.default_rng(11)
    for H, W in ((3, 5), (2, 8), (4, 40), (1, 1), (3, 300)):
        f = (rng.random((H, W, 3)) ** 3 * 4).astype(np.float32)
        f[0, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255]
        rgbe = cc.float_to_rgbe(f)
        rgbe[rng.random((H, W)) < 0.4] = rgbe[0, 0]
        if W > 3:
            rgbe[0, 1:4] = ((200, 100, 3, 255), (255, 255, 255, 1),
                            (9, 8, 7, 0))
        for magic in (b"#?RADIANCE", b"#?RGBE", b"#?FOO"):
            for enc in ("new", "old", "flat"):
                _assert_as_cv2(cc.hdr_bytes(rgbe, magic=magic, encoding=enc),
                               tmp_path, ".hdr", (H, W, magic, enc))
        for size in (b"+Y %d +X %d" % (H, W), b"-Y %d -X %d" % (H, W),
                     b"+X %d -Y %d" % (W, H), b"-Y  %d  +X %d" % (H, W),
                     b"-Y %d +X %d extra" % (H, W)):
            _assert_as_cv2(cc.hdr_bytes(rgbe, size_line=size), tmp_path,
                           ".hdr", size)
        for lines in ((b"FORMAT=32-bit_rle_xyze",),
                      (b"EXPOSURE=2", b"FORMAT=32-bit_rle_rgbe"),
                      (b"# c", b"", b"FORMAT=32-bit_rle_rgbe"),
                      (b"GAMMA=2.2", b"FORMAT=32-bit_rle_rgbe",
                       b"PRIMARIES=0 0 0 0 0 0 0 0")):
            _assert_as_cv2(cc.hdr_bytes(rgbe, header_lines=lines),
                           tmp_path, ".hdr", lines)
    img = (rng.random((9, 70, 3)) * 2).astype(np.float32)
    for c in (cv2.IMWRITE_HDR_COMPRESSION_RLE,
              cv2.IMWRITE_HDR_COMPRESSION_NONE):
        ok, enc = cv2.imencode(".hdr", img, [cv2.IMWRITE_HDR_COMPRESSION, c])
        assert ok
        _assert_as_cv2(enc.tobytes(), tmp_path, ".hdr", c)


# --------------------------------------------------------------------- GIF

@pytest.mark.parametrize("size", [(4, 6), (1, 1), (17, 33), (64, 100)])
def test_gif_as_cv2(size, tmp_path):
    """Table sizes, 87a/89a, interlace, clear codes, local tables (alone
    or over a global one), no table at all, frames smaller than the
    screen over each background entry, transparency, animations (the
    first frame), frames leaving the screen, LZW that fills its table,
    truncated data; cv2's own GIF."""
    H, W = size
    rng = np.random.default_rng(H * W)
    for ncol in (2, 4, 16, 256):
        gt = rng.integers(0, 256, (ncol, 3))
        lt = rng.integers(0, 256, (max(2, ncol // 2), 3))
        idx = rng.integers(0, ncol, (H, W))
        idx[rng.random((H, W)) < 0.5] = 1
        files = []
        for ver in (b"87a", b"89a"):
            for inter in (False, True):
                for clear in (None, 7):
                    files.append(cc.gif_bytes(
                        [dict(indices=idx, interlace=inter,
                              clear_every=clear)], screen=(W, H),
                        global_table=gt, version=ver))
        li = idx % len(lt)
        files += [cc.gif_bytes([dict(indices=li, table=lt)], screen=(W, H),
                               global_table=gt),
                  cc.gif_bytes([dict(indices=li, table=lt)], screen=(W, H)),
                  cc.gif_bytes([dict(indices=idx)], screen=(W, H))]
        for bg in (0, 1, ncol - 1):
            files += [
                cc.gif_bytes([dict(indices=idx, left=3, top=2)],
                             screen=(W + 5, H + 4), global_table=gt,
                             background=bg),
                cc.gif_bytes([dict(indices=idx, left=3, top=2,
                                   transparent=1)], screen=(W + 5, H + 4),
                             global_table=gt, background=bg),
                cc.gif_bytes([dict(indices=li, table=lt, left=1, top=1,
                                   transparent=0)], screen=(W + 2, H + 2),
                             background=bg)]
        files.append(cc.gif_bytes([dict(indices=idx, left=3, top=2)],
                                  screen=(W, H), global_table=gt))
        files.append(cc.gif_bytes(
            [dict(indices=idx, delay=5, transparent=0),
             dict(indices=rng.integers(0, ncol, (H, W)), delay=5,
                  disposal=2)], screen=(W, H), global_table=gt))
        big = rng.integers(0, ncol, (H * 4, W * 4)) if H * W < 1000 else idx
        files.append(cc.gif_bytes([dict(indices=big)], screen=big.shape[::-1],
                                  global_table=gt))
        whole = cc.gif_bytes([dict(indices=idx)], screen=(W, H),
                             global_table=gt)
        files.append(whole[:len(whole) - 6])
        for k, data in enumerate(files):
            _assert_as_cv2(data, tmp_path, ".gif", (ncol, k))
    ok, enc = cv2.imencode(".gif", rng.integers(0, 256, size + (3,),
                                                np.uint8))
    assert ok
    _assert_as_cv2(enc.tobytes(), tmp_path, ".gif", "cv2's")


# ------------------------------------------------------- dispatch, not yet

def test_not_yet_read_containers_raise(tmp_path):
    """An AVIF file whose frame uses a tool decoded after reconstruction
    (cv2's own quality-90 file: quantizer matrices, the deblocking
    filter), which cv2 reads, raises a ValueError naming the tools as not
    yet read by the port; cv2's lossless AVIF (quality 100), WebP and
    JPEG 2000, which raised so before the port read them, now read as
    cv2 reads them; bytes no decoder claims raise as cv2 returns None."""
    img = np.random.default_rng(12).integers(0, 256, (64, 64, 3), np.uint8)
    for ext, prm in ((".webp", []), (".jp2", []),
                     (".avif", [cv2.IMWRITE_AVIF_QUALITY, 100])):
        ok, enc = cv2.imencode(ext, img, prm)
        assert ok
        ref, got = _both(enc.tobytes(), tmp_path, ext)
        np.testing.assert_array_equal(got, ref)
    for ext, what in ((".avif", "AVIF with quantizer matrices, the "
                       "deblocking filter"),):
        ok, enc = cv2.imencode(ext, img, [cv2.IMWRITE_AVIF_QUALITY, 90])
        assert ok, ext
        ref, got = _both(enc.tobytes(), tmp_path, ext)
        assert ref is not None and isinstance(got, ValueError)
        assert "%s, not yet read by the port" % what in str(got)
    for junk in (b"", b"\x00" * 40, b"#?FOO\n", b"P8 1 1 1\n\x00",
                 b"v/1\x01" + bytes(40)):
        ref, got = _both(junk, tmp_path, ".bin")
        assert ref is None and isinstance(got, ValueError)


def test_split_layouts_read_as_png_pixels(tmp_path):
    """Each lossless layout `chip_smoke.py`'s containers phase writes the
    val images in reads back, through cv2 and through the port, as the
    pixels it was written from."""
    rng = np.random.default_rng(13)
    rgb = rng.integers(0, 256, (70, 130, 3), np.uint8)
    rgb[20:50, 30:90] = rgb[20, 30]
    assert len(cc.LAYOUTS) >= 8
    for layout, ext in cc.LAYOUTS:
        ref, got = _both(cc.layout_bytes(rgb, layout), tmp_path, ext)
        np.testing.assert_array_equal(ref, rgb, err_msg=layout)
        np.testing.assert_array_equal(got, rgb, err_msg=layout)


# ------------------------------------------------------- the JAX datasets

def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(_io.StringIO()):
        return fn(*a, **kw)


def _container_split(src, dst):
    """`src`'s splits with image k written in layout k mod len(LAYOUTS)
    and the jsons naming the new files."""
    os.makedirs(os.path.join(dst, "annotations"), exist_ok=True)
    k = 0
    for split in ("train", "val"):
        os.makedirs(os.path.join(dst, split), exist_ok=True)
        ann = os.path.join("annotations", "instancesonly_%s.json" % split)
        with open(os.path.join(src, ann)) as f:
            d = json.load(f)
        for im in d["images"]:
            rgb = cv2.imread(os.path.join(src, split, im["file_name"]))[
                ..., ::-1]
            layout, ext = cc.LAYOUTS[k % len(cc.LAYOUTS)]
            k += 1
            im["file_name"] = os.path.splitext(im["file_name"])[0] + ext
            cc.write_layout(os.path.join(dst, split, im["file_name"]), rgb,
                            layout)
        with open(os.path.join(dst, ann), "w") as f:
            json.dump(d, f)
    return dst


def _exif_split(d):
    """`d`'s PNGs rewritten with image k turned by eXIf orientation 1 +
    k mod 8 (II or MM; the chunk before IDAT for even k, after for
    odd)."""
    from png_craft import chunk, exif_tiff, write_png
    k = 0
    for split in ("train", "val"):
        with open(os.path.join(d, "annotations",
                               "instancesonly_%s.json" % split)) as f:
            images = json.load(f)["images"]
        for im in images:
            path = os.path.join(d, split, im["file_name"])
            c = [chunk(b"eXIf", exif_tiff([(0x0112, 3, 1 + k % 8)],
                                          big_endian=bool(k % 3)))]
            write_png(path, cv2.imread(path)[..., ::-1], 2, 8,
                      **{("before", "after")[k % 2]: c})
            k += 1
    return d


@pytest.fixture(scope="module", params=["layouts", "exif_png"])
def cdata(request, tmp_path_factory):
    """A synthetic split in the smoke's lossless layouts, or as square
    PNGs turned by their eXIf chunks (orientations 5-8 transpose)."""
    from mergenet_tpu_torch.data import synthetic
    src = str(tmp_path_factory.mktemp("png"))
    if request.param == "layouts":
        _quiet(synthetic.generate, src, 4, 3, 40, 72, 9, seed=4)
        return _container_split(src, str(tmp_path_factory.mktemp("c")))
    _quiet(synthetic.generate, src, 8, 2, 48, 48, 9, seed=5)
    return _exif_split(src)


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


@pytest.mark.parametrize("split", ["train", "val"])
def test_datasets_on_container_split_equal_reference(cdata, split):
    """The JAX package's AllDataset, OffsetDataset, ClassDataset,
    COCOTestset and grain records (cv2.imread) against the port's
    (imgproc.imread_rgb) on TIFF, BMP, PPM, PAM and Sun raster files,
    and on eXIf-turned PNGs."""
    from mergenet_tpu.data import dataset as jdataset
    from mergenet_tpu.data import grain_pipeline as jgrain
    from mergenet_tpu_torch.data import dataset as tdataset
    from mergenet_tpu_torch.data import pipeline as tpipe
    offsets = ((1, 0), (0, 2), (-2, -1), (5, 5))
    img = os.path.join(cdata, split)
    ann = os.path.join(cdata, "annotations", "instancesonly_%s.json" % split)
    kinds = {"all": lambda m, **kw: m.AllDataset(img, ann, 9, offsets, **kw),
             "offset": lambda m, **kw: m.OffsetDataset(img, ann, offsets,
                                                       **kw),
             "class": lambda m, **kw: m.ClassDataset(img, ann, **kw)}
    for name, make in kinds.items():
        for kw in ({}, dict(scale=2, crop=True, crop_size=16, seed=6)):
            ref, got = (_quiet(make, m, **kw) for m in (jdataset, tdataset))
            assert len(got) == len(ref) > 0
            for i in range(len(ref)):
                _assert_same(got[i], ref[i], "%s %s %d" % (name, kw, i))
    ref = _quiet(jdataset.COCOTestset, img, ann)
    got = _quiet(tdataset.COCOTestset, img, ann)
    for i in range(len(ref)):
        _assert_same(got[i], ref[i], "test set %d" % i)
    ref = jgrain.CocoInstanceSource(img, ann)
    got = tpipe.CocoInstanceSource(img, ann)
    for i in range(len(ref)):
        _assert_same(got[i], ref[i], "grain %d" % i)
