"""The TIFF codecs and interpretations of `mergenet_tpu_torch/data/tiff.py`
beyond none, LZW, Deflate and PackBits (those are in
`tests/test_torch_port_containers.py`), against `cv2.imread` (OpenCV
5.0, libtiff 4.7.1), whose decoders the JAX package reads images with:
every array bit for bit equal to `cv2.cvtColor(cv2.imread(path),
cv2.COLOR_BGR2RGB)`, and a ValueError naming the file wherever cv2
returns None.

- FillOrder 2: libtiff reverses the bits of each strip or tile before
  none, LZW, PackBits, Deflate and ThunderScan (and the predictor);
  files from container_craft and from Pillow's libtiff;
- CCITT (2, 3, 4, 32771): the port's Modified Huffman and 2-D mode
  tables against the codes libtiff's encoder writes for every run length
  and every mode, and files from tests/tiff_craft.py (T.4 1-D and 2-D,
  fill bits, T.6, libtiff's placement of 32771's rows, fill orders,
  strips and tiles, both photometrics, orientations) and from Pillow;
- JPEG (7): the whole stream or JPEGTables and abbreviated streams, in
  strips (the last one short or full height) and tiles, photometric 6
  (libjpeg's RGB conversion) with every subsampling, 2, 1, 0, 5 and
  planar 2, missing and mismatched YCbCrSubsampling tags, progressive,
  restart and arithmetic-coded streams, read as cv2 reads the JPEG;
- YCbCr without JPEG (1, 5, 8, 32773): tif_color.c's tables from
  YCbCrCoefficients and ReferenceBlackWhite over every code,
  subsamplings 1x1 to 4x4 with partial units, tiles (the 4x4 routine's
  skew), planar 1x1, predictor 2;
- CIELab: tif_color.c's float32 conversion over every L (every code
  with `-m slow`), 8 and 16 bits, WhitePoint;
- ThunderScan (4-bit palette images);
- SGILog: LogL, LogLuv and LogLuv24 in libtiff's 8-bit output (every
  LogLuv24 code with `-m slow`);
- refusals: what cv2's libtiff is built without (old-style JPEG,
  PixarLog, LZMA, ZSTD, WebP, JBIG, LERC), NeXT, unknown codecs;
  and seeded corruptions of every kind, in the directory and the data,
  each read as cv2 reads it or raising where libtiff hands back a
  half-written image."""

import io
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import container_craft as cc
import jpeg_craft as jc
import tiff_craft as tc
from mergenet_tpu_torch.data import imgproc, tiff


def _both(data, tmp_path):
    """(cv2.imread's RGB or None, the port's RGB or its ValueError) of
    the TIFF bytes `data`, written to a file.  cv2.imread raising (it does
    for a width of 0) counts as refusing."""
    path = str(tmp_path / "c.tif")
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


def _as_cv2(data, tmp_path, where="", refused=None):
    """The port reads `data` as cv2 does, or raises where cv2 returns
    None; `refused` pins which of the two cv2 does."""
    ref, got = _both(data, tmp_path)
    if refused is not None:
        assert (ref is None) == refused, (where, "cv2 refused: %s"
                                          % (ref is None))
    if ref is None:
        assert isinstance(got, ValueError), (where, "cv2 refuses, port reads")
        return None
    assert not isinstance(got, ValueError), (where, got)
    assert got.shape == ref.shape, where
    np.testing.assert_array_equal(got, ref, err_msg=str(where))
    return got


def _as_cv2_or_raises(data, tmp_path, where=""):
    """Corrupt data: the port reads it as cv2 does or raises (where
    libtiff hands cv2 back what it could decode).  True if it read."""
    ref, got = _both(data, tmp_path)
    if isinstance(got, ValueError):
        return False
    assert ref is not None, (where, "cv2 refuses, port reads")
    np.testing.assert_array_equal(got, ref, err_msg=str(where))
    return True


def _scene(rng, h, w):
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), np.uint8),
                           (5, 5), 1.5)
    img[h // 3:2 * h // 3, w // 4:w // 2] = rng.integers(0, 256, 3)
    return img


def _pil(img, **kw):
    b = io.BytesIO()
    img.save(b, "TIFF", **kw)
    return b.getvalue()


def _reset_offset(data, offset):
    """`data` (a one-strip little-endian TIFF) with its strip moved to
    file offset `offset` (odd or even) by a padding byte."""
    tags = tiff._ifd(data, "x")[0]
    off, cnt = tags[273][0], tags[279][0]
    b = bytearray(data[:off] + b"\0" * (offset - off) + data[off:])
    first = struct.unpack("<I", b[4:8])[0] + offset - off
    struct.pack_into("<I", b, 4, first)
    n = struct.unpack("<H", b[first:first + 2])[0]
    for k in range(n):
        e = first + 2 + 12 * k
        tag, typ, cnt_ = struct.unpack("<HHI", b[e:e + 8])
        if tag == 273:
            struct.pack_into("<I", b, e + 8, offset)
        elif cnt_ * {3: 2, 4: 4, 5: 8, 7: 1}.get(typ, 4) > 4:
            v = struct.unpack("<I", b[e + 8:e + 12])[0]
            struct.pack_into("<I", b, e + 8, v + offset - off)
    return bytes(b)


# -------------------------------------------------------------- FillOrder 2

#: (name, bits, samples per pixel, photometric)
FILL_KINDS = [("bilevel", 1, 1, 0), ("grey8", 8, 1, 1), ("grey16", 16, 1, 1),
              ("rgb8", 8, 3, 2), ("rgb16", 16, 3, 2)]
FILL_CASES = [(comp, kind, pred) for comp in (1, 5, 32773, 8)
              for kind in FILL_KINDS
              for pred in ((1, 2) if comp in (5, 8) and kind[1] >= 8
                           else (1,))]


@pytest.mark.parametrize("comp,kind,pred", FILL_CASES,
                         ids=["%d-%s-p%d" % (c, k[0], p)
                              for c, k, p in FILL_CASES])
def test_fill_order_2_as_cv2(comp, kind, pred, tmp_path):
    """FillOrder 2 (tag 266): the bits of every byte of each strip or
    tile reversed before decompressing, as libtiff's TIFFFillStrip does,
    in strips, tiles and both byte orders; the image cv2 reads is the
    one written.  Uncompressed tiles whose size is not a multiple of
    1024 bytes are refused (libtiff reads them into a buffer rounded up
    to 1 KiB and finds them short)."""
    name, bits, spp, photometric = kind
    rng = np.random.default_rng(bits * 10 + spp + comp + pred)
    s = rng.integers(0, 1 << bits, (21, 37, spp))
    s[:, :9] = s[:, :1]  # runs for PackBits and LZW
    for layout in ({}, dict(rows_per_strip=5), dict(tile=(16, 32)),
                   dict(tile=(32, 64)),
                   dict(big_endian=True, rows_per_strip=8)):
        data = cc.tiff_bytes(s, bits=bits, photometric=photometric,
                             compression=comp, predictor=pred, fill_order=2,
                             **layout)
        th, tw = layout.get("tile", (1, 0))
        refused = comp == 1 and th * (tw * spp * bits // 8) % 1024 != 0
        got = _as_cv2(data, tmp_path, layout, refused=refused)
        if refused:
            continue
        plain = _as_cv2(cc.tiff_bytes(
            s, bits=bits, photometric=photometric, compression=comp,
            predictor=pred, **layout), tmp_path, layout, refused=False)
        np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("mode", ["1", "L", "RGB"])
def test_fill_order_2_pillow_written_as_cv2(mode, tmp_path):
    """Pillow's libtiff writes FillOrder 2 files reversed (compressed)
    or as they are (its own uncompressed writer); cv2 reads each."""
    rng = np.random.default_rng(len(mode))
    arr = _scene(rng, 37, 53)
    img = Image.fromarray(arr if mode == "RGB" else arr[..., 0])
    if mode == "1":
        img = img.convert("1")
    for comp in ("raw", "tiff_lzw", "packbits", "tiff_adobe_deflate"):
        _as_cv2(_pil(img, compression=comp, tiffinfo={266: 2}), tmp_path,
                comp, refused=False)


# ------------------------------------------------------------------- CCITT

def _code_runs(full):
    """Run lengths whose codes cover every terminating and makeup code:
    0-63, and 64 m + (m mod 64) up to 2560 (all of 0-2560 when
    `full`)."""
    if full:
        return list(range(2561))
    return list(range(64)) + [64 * m + m % 64 for m in range(1, 41)]


def _single_row(run, black):
    """One row whose first run is `run` pixels of the colour, then one
    pixel of the other (a white run of 0 first when black)."""
    row = np.zeros((1, run + 1), np.uint8)
    if black:
        row[0, :run] = 1
    else:
        row[0, run] = 1
    return row


def _pillow_strip(rows, comp):
    """The strip Pillow's libtiff writes for `rows` (1 for the coder's
    black: Pillow's 0 pixels under photometric 1)."""
    data = _pil(Image.fromarray(rows.astype(bool)), compression=comp)
    tags = tiff._ifd(data, "x")[0]
    return data, data[tags[273][0]:tags[273][0] + tags[279][0]]


def _check_runs(runs, tmp_path):
    for run in runs:
        for black in (0, 1):
            row = _single_row(run, black)
            for comp, scheme in (("tiff_ccitt", 2), ("group3", 3),
                                 ("group4", 4)):
                data, strip = _pillow_strip(row, comp)
                # libtiff writes no RTC
                assert strip == tc.fax_strip(row, scheme, rtc=False), (
                    run, black, comp)
                if run % 7 == 0 or run < 70:
                    _as_cv2(data, tmp_path, (run, black, comp),
                            refused=False)


def test_ccitt_tables_against_libtiff(tmp_path):
    """The port's Modified Huffman tables (codecs.cc: terminating,
    makeup and extended makeup codes of both colours, as tiff_craft
    reads them from the source) give, run for run, the bits libtiff's
    encoder writes for a single-row image (group 3 1-D, group 4 and
    Modified Huffman), for runs covering every code; each file read as
    cv2 reads it."""
    _check_runs(_code_runs(False), tmp_path)


@pytest.mark.slow
def test_ccitt_tables_against_libtiff_every_run(tmp_path):
    _check_runs(_code_runs(True), tmp_path)


def _mode_rows():
    """Two-row images whose second row takes each 2-D mode against the
    first: V0, VR1-3, VL1-3 (a black run moved by -3..3), pass (a black
    run above that ends before the next change below) and horizontal
    (a run moved by more than 3)."""
    w = 48
    out = {}
    for d in range(-3, 4):
        r = np.zeros((2, w), np.uint8)
        r[0, 20:30] = 1
        r[1, 20 + d:30] = 1
        out["V%+d" % d] = r
    r = np.zeros((2, w), np.uint8)
    r[0, 10:14] = 1
    r[1, 30:40] = 1
    out["pass"] = r
    r = np.zeros((2, w), np.uint8)
    r[0, 5:9] = 1
    r[1, 20:25] = 1
    out["horizontal"] = r
    r = np.zeros((2, w), np.uint8)
    r[1, :] = 1
    out["black row"] = r
    return out


def test_ccitt_2d_modes_against_libtiff(tmp_path):
    """The 2-D mode codes (pass, horizontal, V0, VR1-3, VL1-3): tiff_craft's
    Fax3Encode2DRow with the port's tables gives the bits libtiff's group
    4 encoder writes for images that take each mode; each read as cv2."""
    modes = set()
    for name, rows in _mode_rows().items():
        data, strip = _pillow_strip(rows, "group4")
        assert strip == tc.fax_strip(rows, 4), name
        modes.update(c for c, _ in tc.row_2d(list(rows[1]), list(rows[0])))
        _as_cv2(data, tmp_path, name, refused=False)
    assert modes >= {tc.PASS, tc.HORIZ, *tc.VCODES.values()}


def _fax_images(rng):
    img = cv2.cvtColor(_scene(rng, 70, 177), cv2.COLOR_RGB2GRAY)
    long = np.zeros((5, 6000), np.uint8)
    long[1, 100:2900] = 1
    long[2, 2:5000] = 1
    long[3, :] = 1
    long[4, 1::3] = 1
    return {"scene": (img < 100).astype(np.uint8),
            "noise": (rng.random((23, 61)) < 0.4).astype(np.uint8),
            "long runs": long}


#: (scheme, T4Options 2-D bit, fill bits)
FAX_SCHEMES = [(2, 0, False), (32771, 0, False), (3, 0, False),
               (3, 0, True), (3, 1, False), (3, 1, True), (4, 0, False)]


@pytest.mark.parametrize("scheme,two_d,fill", FAX_SCHEMES)
def test_ccitt_as_cv2(scheme, two_d, fill, tmp_path):
    """tiff_craft's CCITT files: a scene, noise and runs past 2560, in
    one strip, strips of 7 rows and 16x32 tiles, fill orders 1 and 2,
    photometric 0 and 1, a K of 2 and 3 for T.4 2-D; and orientations."""
    rng = np.random.default_rng(scheme + two_d + fill)
    for pat, rows in _fax_images(rng).items():
        for layout in ({}, dict(rows_per_strip=7), dict(tile=(16, 32))):
            if "tile" in layout and rows.shape[1] > 1000:
                continue
            for fo in (1, 2):
                for ph in (0, 1):
                    _as_cv2(tc.fax_tiff(rows, scheme, options=two_d,
                                        fill=fill, fill_order=fo,
                                        photometric=ph, k=2 + ph, **layout),
                            tmp_path, (pat, layout, fo, ph), refused=False)
    rows = _fax_images(rng)["noise"][:20, :20]
    for o in (2, 3, 6, 8):
        _as_cv2(tc.fax_tiff(rows, scheme, options=two_d, fill=fill,
                            orientation=o, rows_per_strip=6), tmp_path, o)


def test_ccitt_pillow_written_as_cv2(tmp_path):
    """Pillow's libtiff: Modified Huffman, group 3 with T4Options 0, 1,
    4, 5 and group 4, fill orders 1 and 2.  Its word-aligned Modified
    Huffman (32771) rows are not where libtiff's own reader looks for
    them: cv2 gets what libtiff could decode, and the port raises."""
    rng = np.random.default_rng(7)
    arr = (cv2.cvtColor(_scene(rng, 40, 90), cv2.COLOR_RGB2GRAY) > 120)
    img = Image.fromarray(arr)
    for fo in (1, 2):
        for comp, info in (("tiff_ccitt", {}), ("group4", {}),
                           ("group3", {}), ("group3", {292: 1}),
                           ("group3", {292: 4}), ("group3", {292: 5})):
            _as_cv2(_pil(img, compression=comp, tiffinfo={266: fo, **info}),
                    tmp_path, (comp, info, fo), refused=False)
    ref, got = _both(_pil(img, compression="tiff_raw_16"), tmp_path)
    assert ref is not None and isinstance(got, ValueError)


def test_ccitt_rlew_alignment_follows_the_file_offset(tmp_path):
    """libtiff's 32771 reader aligns its rows by the strip's address in
    the memory-mapped file: the same strip at an odd and at an even file
    offset, each laid out for its offset, reads as cv2.imread reads it
    (cv2.imdecode reads from a buffer and aligns differently)."""
    rows = (np.random.default_rng(9).random((12, 77)) < 0.3).astype(np.uint8)
    for offset in (8, 9, 10, 11):
        strip = tc.fax_strip(rows, 32771, file_offset=offset)
        data = cc.tiff_bytes(rows[..., None], bits=1, photometric=0,
                             compression=32771, blocks=[strip])
        got = _as_cv2(_reset_offset(data, offset), tmp_path, offset,
                      refused=False)
        np.testing.assert_array_equal(got[..., 0] == 0, rows == 1)


def test_ccitt_options_and_refusals(tmp_path):
    """T4Options and T6Options with the uncompressed-mode bit set but no
    uncompressed data read as cv2; uncompressed-mode codes, a missing
    first EOL (libtiff skips to the next), 2- and 8-bit samples, 3
    samples raise where cv2 hands back rows it could not decode or
    refuses."""
    rows = (np.random.default_rng(2).random((23, 61)) < 0.4).astype(np.uint8)
    for scheme, opts in ((3, 2), (3, 3), (4, 2)):
        _as_cv2(tc.fax_tiff(rows, scheme, options=opts), tmp_path,
                (scheme, opts), refused=False)
    no_eol = cc.tiff_bytes(rows[..., None], bits=1, photometric=0,
                           compression=3, blocks=[tc.fax_strip(
                               rows, 3, first_eol=False)])
    ref, got = _both(no_eol, tmp_path)
    assert ref is not None and isinstance(got, ValueError)
    # an uncompressed-mode extension code in a 2-D row
    ext = tc._bits_to_bytes("0000001111" + "0" * 30)
    data = cc.tiff_bytes(rows[:1, :, None], bits=1, photometric=0,
                         compression=4, blocks=[ext])
    assert not _as_cv2_or_raises(data, tmp_path, "uncompressed mode")
    strip = tc.fax_strip(rows, 4)
    for bits, spp in ((2, 1), (8, 1), (1, 3)):
        data = cc.tiff_bytes(np.zeros((23, 61, spp), np.uint8), bits=bits,
                             photometric=1 if spp == 1 else 2,
                             compression=4, blocks=[strip])
        _as_cv2(data, tmp_path, (bits, spp), refused=True)


@pytest.mark.parametrize("scheme", [2, 3, 4])
def test_ccitt_corrupt_as_cv2_or_raises(scheme, tmp_path):
    """Seeded truncations and byte flips of CCITT strips: each reads as
    cv2 reads it, or raises (a bad code, a row of the wrong length, data
    that ends early: libtiff hands back what it decoded)."""
    rng = np.random.default_rng(scheme)
    rows = _fax_images(rng)["scene"]
    strip = tc.fax_strip(rows, scheme, options=1 if scheme == 3 else 0)
    for k in range(24):
        b = bytearray(strip)
        if k < 8:
            b = b[:int(rng.integers(1, len(b)))]
        else:
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        tags = [(292, 4, [1])] if scheme == 3 else []
        data = cc.tiff_bytes(rows[..., None], bits=1, photometric=0,
                             compression=scheme, blocks=[bytes(b)],
                             extra_tags=tags)
        _as_cv2_or_raises(data, tmp_path, (scheme, k))


# -------------------------------------------------------------------- JPEG

_SAMPLING = {(1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             (1, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             (2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             (4, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def _jpeg(rgb, sampling=(2, 2), quality=90, **params):
    extra = []
    for k, v in params.items():
        extra += [getattr(cv2, "IMWRITE_JPEG_" + k.upper()), v]
    a = rgb[..., ::-1] if rgb.ndim == 3 else rgb
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(a), [
        cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        _SAMPLING[sampling], *extra])
    assert ok
    return enc.tobytes()


def _cv2_jpeg(stream, tmp_path):
    path = str(tmp_path / "c.jpg")
    with open(path, "wb") as f:
        f.write(stream)
    return cv2.imread(path)[..., ::-1]


def _blocks(img, encode, rows_per_strip=None, tile=None, full_last=False):
    """The JPEG streams of `img`'s strips (the last one short, or padded
    to full height with its last row) or tiles (padded with zeros)."""
    h, w = img.shape[:2]
    out = []
    if tile is None:
        rps = rows_per_strip or h
        for y in range(0, h, rps):
            part = img[y:y + rps]
            if full_last and part.shape[0] < rps:
                part = np.concatenate([part, np.repeat(
                    part[-1:], rps - part.shape[0], 0)])
            out.append(encode(np.ascontiguousarray(part)))
        return out
    th, tw = tile
    for y in range(0, h, th):
        for x in range(0, w, tw):
            t = np.zeros((th, tw) + img.shape[2:], np.uint8)
            p = img[y:y + th, x:x + tw]
            t[:p.shape[0], :p.shape[1]] = p
            out.append(encode(t))
    return out


def test_jpeg_whole_stream_reads_as_the_jpeg(tmp_path):
    """A cv2 q90 JPEG wrapped as the one strip of a TIFF (YCbCr 2x2,
    whole stream or JPEGTables and an abbreviated stream) reads as cv2
    reads the JPEG itself: the smoke's "tiff" phase rests on it."""
    rng = np.random.default_rng(0)
    for size in ((37, 53), (64, 96), (130, 257)):
        img = _scene(rng, *size)
        stream = _jpeg(img)
        want = _cv2_jpeg(stream, tmp_path)
        for tables in (False, True):
            got = _as_cv2(tc.jpeg_tiff([stream], size, tables=tables),
                          tmp_path, (size, tables), refused=False)
            np.testing.assert_array_equal(got, want)


#: (sampling, layout): strips (the last short or full height), tiles
JPEG_LAYOUTS = [(s, l) for s in _SAMPLING
                for l in ("strip", "strips", "strips full", "tiles")]


@pytest.mark.parametrize("sampling,layout", JPEG_LAYOUTS)
def test_jpeg_ycbcr_as_cv2(sampling, layout, tmp_path):
    """Photometric 6: libjpeg's upsampling and RGB conversion, for each
    of cv2's samplings, in one strip, strips of 24 rows whose last
    stream is short or full height, and 32x48 tiles clipped at the edges;
    tables in the streams or in JPEGTables; orientations 1 and 3; the
    YCbCrSubsampling tag present or absent (libtiff reads the first
    stream's factors)."""
    rng = np.random.default_rng(sum(sampling))
    img = _scene(rng, 64, 100)
    kw = {"strip": {}, "strips": dict(rows_per_strip=24),
          "strips full": dict(rows_per_strip=24),
          "tiles": dict(tile=(32, 48))}[layout]
    streams = _blocks(img, lambda p: _jpeg(p, sampling),
                      full_last=layout == "strips full", **kw)
    for tables in (False, True):
        for tag in (sampling, None):
            for o in (None, 3):
                _as_cv2(tc.jpeg_tiff(streams, img.shape[:2], tables=tables,
                                     subsampling=tag, orientation=o, **kw),
                        tmp_path, (tables, tag, o), refused=False)


def test_jpeg_crafted_samplings_as_cv2(tmp_path):
    """jpeg_craft's streams with the first component at 4x2, 1x4, 4x4
    (libjpeg refuses its 18 blocks per MCU), 3x1 (no TIFF
    subsampling), with the tag matching, absent or wrong."""
    w, h = 40, 24
    rng = np.random.default_rng(3)
    for hv in ((4, 2), (1, 4), (2, 2), (4, 4), (3, 1)):
        comps = [(hv[0], hv[1], 0), (1, 1, 1), (1, 1, 1)]
        stream = _crafted(comps, w, h, rng)
        for tag in (hv, None, (2, 1)):
            _as_cv2(tc.jpeg_tiff([stream], (h, w), subsampling=tag),
                    tmp_path, (hv, tag))


def _crafted(comps, w, h, rng, **kw):
    coefs = []
    for ci in range(len(comps)):
        bh, bw = jc.blocks_shape(comps, ci, w, h)
        c = np.zeros((bh, bw, 8, 8), np.int64)
        c[..., 0, 0] = rng.integers(-60, 60, (bh, bw))
        c[..., 0, 1:4] = rng.integers(-20, 20, (bh, bw, 3))
        c[..., 1, :3] = rng.integers(-20, 20, (bh, bw, 3))
        coefs.append(c)
    return jc.write_jpeg(comps, w, h, coefs, {0: np.full(64, 4),
                                              1: np.full(64, 6)}, **kw)


def test_jpeg_other_photometrics_as_cv2(tmp_path):
    """Components as they are (libtiff suppresses libjpeg's colour
    conversion): RGB (a cv2 4:4:4 stream's YCbCr read as RGB), grey and
    min-is-white, CMYK with and without Adobe markers (libtiff's
    separated conversion), RGBA and grey with alpha, planar RGB and
    planar YCbCr 1x1 (libtiff's YCbCr conversion); subsampled RGB and
    planar YCbCr 2x2 refused as cv2 refuses them."""
    rng = np.random.default_rng(4)
    img = _scene(rng, 40, 56)
    size = img.shape[:2]
    _as_cv2(tc.jpeg_tiff([_jpeg(img, (1, 1))], size, photometric=2),
            tmp_path, "rgb", refused=False)
    _as_cv2(tc.jpeg_tiff([_jpeg(img, (2, 2))], size, photometric=2),
            tmp_path, "rgb 2x2", refused=True)
    for ph in (0, 1):
        _as_cv2(tc.jpeg_tiff([_jpeg(img[..., 1])], size, spp=1,
                             photometric=ph), tmp_path, ph, refused=False)
    w, h = 40, 24
    for nc, ph, extra, kw in ((4, 5, None, {}),
                              (4, 5, None, dict(adobe=0, jfif=False)),
                              (4, 5, None, dict(adobe=2, jfif=False)),
                              (4, 2, [2], {}), (4, 2, [1], {}),
                              (2, 1, [2], {}), (2, 1, [0], {}),
                              (3, 6, None, dict(jfif=False, adobe=0))):
        comps = [(1, 1, 0)] + [(1, 1, 1)] * (nc - 1)
        tags = [] if extra is None else [(338, 3, extra)]
        _as_cv2(tc.jpeg_tiff([_crafted(comps, w, h, rng, **kw)], (h, w),
                             spp=nc, photometric=ph, subsampling=(1, 1),
                             extra_tags=tags), tmp_path, (nc, ph, kw),
                refused=False)
    planes = [_jpeg(np.ascontiguousarray(img[..., c])) for c in range(3)]
    _as_cv2(tc.jpeg_tiff(planes, size, photometric=2, planar=2), tmp_path,
            "planar rgb", refused=False)
    _as_cv2(tc.jpeg_tiff(planes, size, photometric=6, planar=2,
                         subsampling=(1, 1)), tmp_path, "planar ycbcr",
            refused=False)
    _as_cv2(tc.jpeg_tiff(planes, size, photometric=6, planar=2,
                         subsampling=(2, 2)), tmp_path, "planar 2x2",
            refused=True)


def test_jpeg_streams_as_cv2(tmp_path):
    """Progressive, restart-interval, optimised-Huffman (its own tables
    in JPEGTables), arithmetic-coded and lossless streams; FillOrder 2
    (ignored: libtiff never reverses JPEG data); 12-bit samples
    refused; a stream smaller or larger than its strip, a tables-only
    stream holding a frame, corrupt streams."""
    rng = np.random.default_rng(5)
    img = _scene(rng, 48, 64)
    size = img.shape[:2]
    for params in (dict(progressive=1), dict(rst_interval=3),
                   dict(optimize=1)):
        _as_cv2(tc.jpeg_tiff([_jpeg(img, **params)], size,
                             tables="optimize" in params), tmp_path, params,
                refused=False)
    _as_cv2(tc.jpeg_tiff([_jpeg(img)], size, extra_tags=[(266, 3, [2])]),
            tmp_path, "fill order", refused=False)
    w, h = 40, 24
    comps = [(2, 2, 0), (1, 1, 1), (1, 1, 1)]
    coefs = []
    for ci in range(3):
        bh, bw = jc.blocks_shape(comps, ci, w, h)
        c = np.zeros((bh, bw, 8, 8), np.int64)
        c[..., 0, 0] = rng.integers(-60, 60, (bh, bw))
        c[..., 0, 1] = rng.integers(-20, 20, (bh, bw))
        coefs.append(c)
    q = {0: np.full(64, 4), 1: np.full(64, 6)}
    arith = jc.write_jpeg_arith(comps, w, h, coefs, q)
    _as_cv2(tc.jpeg_tiff([arith], (h, w)), tmp_path, "arith", refused=False)
    grey = rng.integers(0, 256, (h, w))
    lossless = jc.write_lossless([(1, 1, 0)], w, h, [grey])
    _as_cv2(tc.jpeg_tiff([lossless], (h, w), spp=1, photometric=1),
            tmp_path, "lossless", refused=False)
    twelve = _crafted([(1, 1, 0)], w, h, rng, sof=0xC1, precision=12)
    for bits in (8, 12):
        data = cc.tiff_bytes(np.zeros((h, w, 1), np.uint8), bits=bits,
                             photometric=1, compression=7, blocks=[twelve])
        _as_cv2(data, tmp_path, ("12-bit", bits), refused=True)
    stream = _jpeg(img)
    _as_cv2(tc.jpeg_tiff([stream], (40, 64)), tmp_path, "taller last strip",
            refused=False)
    small = tc.jpeg_tiff([_jpeg(img[:40, :60])], size)
    large = tc.jpeg_tiff([stream, _jpeg(img[24:40])], (40, 64),
                         rows_per_strip=24)
    for data in (small, large):
        assert not _as_cv2_or_raises(data, tmp_path, "sizes")
    bogus = cc.tiff_bytes(np.zeros(size + (3,), np.uint8), photometric=6,
                          compression=7, blocks=[stream], extra_tags=[
                              (347, 7, list(stream)), (530, 3, [2, 2])])
    _as_cv2(bogus, tmp_path, "bogus tables", refused=True)
    for k in range(16):
        b = bytearray(stream)
        if k < 6:
            b = b[:int(rng.integers(2, len(b)))]
        else:
            b[int(rng.integers(2, len(b)))] = int(rng.integers(0, 256))
        _as_cv2_or_raises(tc.jpeg_tiff([bytes(b)], size), tmp_path, k)


# ------------------------------------------------------------------- YCbCr

def test_ycbcr_tables_over_every_code_as_cv2(tmp_path):
    """tif_color.c's tables (float32, FIX's double rounding, Code2V's
    truncated black level) over all 256 x 256 (Cb, Cr) codes and random Y,
    for default, Rec. 709, full-range, odd and degenerate coefficients
    and ReferenceBlackWhite."""
    rng = np.random.default_rng(6)
    cbcr = np.stack(np.meshgrid(np.arange(256), np.arange(256),
                                indexing="ij"), -1).reshape(-1, 2)
    s = np.concatenate([rng.integers(0, 256, (len(cbcr), 1)), cbcr],
                       -1).reshape(256, 256, 3).astype(np.uint8)
    for luma, ref in (((299, 587, 114), (0, 255, 128, 255, 128, 255)),
                      ((2126, 7152, 722), (16, 235, 128, 240, 128, 240)),
                      ((299, 587, 114), (0, 255, 0, 255, 0, 255)),
                      ((5000, 2500, 2500), (10, 200, 100, 300, 0, 120)),
                      ((299, 587, 114), (0, 0, 128, 128, 255, 0)),
                      ((9000, 500, 3000), (255, 0, 128, 255, 128, 255))):
        tags = [(529, 5, [(v, 10000) for v in luma]),
                (532, 5, [(v, 1) for v in ref])]
        _as_cv2(cc.tiff_bytes(s, photometric=6, subsampling=(1, 1),
                              extra_tags=tags), tmp_path, (luma, ref),
                refused=False)
    _as_cv2(cc.tiff_bytes(s, photometric=6, subsampling=(1, 1), extra_tags=[
        (529, 5, [(299, 1000), (0, 1000), (114, 1000)])]), tmp_path,
        "zero green", refused=True)


YCBCR_SUBSAMPLINGS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2),
                      (4, 4)]


@pytest.mark.parametrize("sub", YCBCR_SUBSAMPLINGS)
def test_ycbcr_subsampled_as_cv2(sub, tmp_path):
    """YCbCr data units of each subsampling libtiff converts
    (putcontig8bitYCbCr{11,12,21,22,41,42,44}tile): none, LZW, Deflate
    and PackBits; strips of 12 and 5 rows (partial units at each strip's
    foot), clipped tiles of 16x32, 32x16 and 16x48 (the 4x4 routine
    skips 10 bytes, not 18, for each clipped unit), orientations;
    predictor 2 (libtiff's rows of 1 / v unit rows of 3-byte pixels,
    failing where they are not whole) at widths 53, 52 and 48."""
    rng = np.random.default_rng(sub[0] * 4 + sub[1])
    ycc = rng.integers(0, 256, (37, 53, 3), np.uint8)
    for comp in (1, 5, 8, 32773):
        for layout in (dict(rows_per_strip=12), dict(rows_per_strip=5),
                       dict(tile=(16, 32)), dict(tile=(32, 16)),
                       dict(tile=(16, 48), orientation=4)):
            _as_cv2(cc.tiff_bytes(ycc, photometric=6, subsampling=sub,
                                  compression=comp, **layout), tmp_path,
                    (comp, layout), refused=False)
    for w in (53, 52, 48):
        data = cc.tiff_bytes(ycc[:, :w], photometric=6, subsampling=sub,
                             compression=5, rows_per_strip=12,
                             extra_tags=[(317, 3, [2])])
        ref, got = _both(data, tmp_path)
        units = -(-w // sub[0]) * (sub[0] * sub[1] + 2)
        if units % sub[1] or units // sub[1] % 3:
            assert ref is not None and isinstance(got, ValueError), w
        else:
            np.testing.assert_array_equal(got, ref, err_msg=str(w))


def test_ycbcr_planar_and_refusals_as_cv2(tmp_path):
    """Planar YCbCr without subsampling (putseparate8bitYCbCr11tile),
    with predictor 2; refused as cv2 refuses them: planar with
    subsampling, subsamplings 3x3, 2x4, 1x4, 8x1, 16-bit and 4-sample
    YCbCr."""
    rng = np.random.default_rng(8)
    ycc = rng.integers(0, 256, (37, 53, 3), np.uint8)
    for comp, pred in ((1, 1), (5, 2), (8, 1)):
        for layout in ({}, dict(rows_per_strip=5), dict(tile=(16, 32))):
            _as_cv2(cc.tiff_bytes(ycc, photometric=6, planar=2,
                                  compression=comp, predictor=pred,
                                  extra_tags=[(530, 3, [1, 1])], **layout),
                    tmp_path, (comp, layout), refused=False)
    _as_cv2(cc.tiff_bytes(ycc, photometric=6, planar=2), tmp_path,
            "planar 2x2", refused=True)
    for sub in ((3, 3), (2, 4), (1, 4), (8, 1)):
        _as_cv2(cc.tiff_bytes(ycc, photometric=6, subsampling=sub),
                tmp_path, sub, refused=True)
    _as_cv2(cc.tiff_bytes(ycc.astype(np.uint16) * 257, bits=16,
                          photometric=6, extra_tags=[(530, 3, [1, 1])]),
            tmp_path, "16-bit", refused=True)
    _as_cv2(cc.tiff_bytes(np.dstack([ycc, ycc[..., :1]]), photometric=6,
                          extra_tags=[(530, 3, [1, 1])]), tmp_path,
            "4 samples", refused=True)


def test_ycbcr_corrupt_as_cv2_or_raises(tmp_path):
    """Seeded truncations and flips of LZW YCbCr strips."""
    rng = np.random.default_rng(10)
    ycc = rng.integers(0, 256, (37, 53, 3), np.uint8)
    good = cc.tiff_bytes(ycc, photometric=6, subsampling=(2, 2),
                         compression=5)
    tags = tiff._ifd(good, "x")[0]
    off, cnt = tags[273][0], tags[279][0]
    for k in range(12):
        b = bytearray(good)
        if k < 4:
            cut = int(rng.integers(1, cnt))
            b[off + cut:off + cnt] = b"\0" * (cnt - cut)
        else:
            b[off + int(rng.integers(0, cnt))] = int(rng.integers(0, 256))
        _as_cv2_or_raises(bytes(b), tmp_path, k)


# ------------------------------------------------------------------ CIELab

def _lab_samples(full):
    """Every (L, a, b) of 8-bit CIELab (4096 x 4096) when `full`, else
    every L against seeded a and b (256 x 256)."""
    if full:
        v = np.arange(1 << 24, dtype=np.int64)
        return np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).reshape(
            4096, 4096, 3)
    rng = np.random.default_rng(12)
    return np.concatenate([np.arange(256)[:, None, None].repeat(256, 1),
                           rng.integers(0, 256, (256, 256, 2))], -1)


def test_cielab_as_cv2(tmp_path):
    """CIELab (photometric 8) through TIFFCIELab16ToXYZ and TIFFXYZToRGB
    (float32, display_sRGB, the 1500-step gamma table): every L against
    seeded a, b at 8 bits; 16-bit samples in both byte orders, LZW tiles
    and an orientation; WhitePoint tags; Pillow's LAB files; refused as
    cv2 refuses them: a WhitePoint with y 0, planar, 1 or 4 samples,
    ICCLab (9) and ITULab (10)."""
    s = _lab_samples(False)
    _as_cv2(cc.tiff_bytes(s, photometric=8, rows_per_strip=64), tmp_path,
            "8-bit", refused=False)
    rng = np.random.default_rng(13)
    s16 = rng.integers(0, 65536, (60, 80, 3))
    for layout in ({}, dict(big_endian=True, rows_per_strip=7),
                   dict(tile=(32, 48), compression=5, orientation=3)):
        _as_cv2(cc.tiff_bytes(s16, bits=16, photometric=8, **layout),
                tmp_path, layout, refused=False)
    s8 = s[:37, :53]
    for wp in ([(3127, 10000), (3290, 10000)], [(1, 3), (1, 3)],
               [(5, 10), (2, 10)]):
        _as_cv2(cc.tiff_bytes(s8, photometric=8, extra_tags=[(318, 5, wp)]),
                tmp_path, wp, refused=False)
    img = Image.fromarray(s8.astype(np.uint8), "LAB")
    for comp in ("raw", "tiff_lzw"):
        _as_cv2(_pil(img, compression=comp), tmp_path, comp, refused=False)
    for data in (cc.tiff_bytes(s8, photometric=8, extra_tags=[
            (318, 5, [(3, 10), (0, 1)])]),
                 cc.tiff_bytes(s8, photometric=8, planar=2),
                 cc.tiff_bytes(s8[..., :1], photometric=8),
                 cc.tiff_bytes(np.dstack([s8, s8[..., :1]]), photometric=8,
                               extra_samples=[0]),
                 cc.tiff_bytes(s8, photometric=9),
                 cc.tiff_bytes(s8 * 257, bits=16, photometric=10)):
        _as_cv2(data, tmp_path, "refused", refused=True)


@pytest.mark.slow
def test_cielab_every_code_as_cv2(tmp_path):
    _as_cv2(cc.tiff_bytes(_lab_samples(True), photometric=8,
                          rows_per_strip=256), tmp_path, "all",
            refused=False)


# ------------------------------------------------------------- ThunderScan

def test_thunderscan_as_cv2(tmp_path):
    """ThunderScan 4-bit palette images (cv2 reads 4-bit samples only as
    palette indices): runs, 2- and 3-bit deltas, raw pixels, odd and
    even widths, fill orders 1 and 2, strips; rows that decode to more
    pixels than the width raise (libtiff stops there), as do tiles
    (libtiff has none: cv2 gets an undecoded image); grey is refused."""
    rng = np.random.default_rng(11)
    cmap = rng.integers(0, 65536, (16, 3))
    for w in (10, 11, 37, 64, 200):
        for fo in (1, 2):
            strips = [b"".join(tc.thunder_row(rng, w) for _ in range(3))
                      for _ in range(3)]
            data = cc.tiff_bytes(np.zeros((9, w, 1), np.uint8), bits=4,
                                 photometric=3, colormap=cmap,
                                 rows_per_strip=3, blocks=strips,
                                 fill_order=fo, extra_tags=[])
            data = data.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                                b"\x03\x01\x03\x00\x01\x00\x00\x00\x29\x80")
            _as_cv2(data, tmp_path, (w, fo), refused=False)
    over = cc.tiff_bytes(np.zeros((2, 10, 1), np.uint8), bits=4,
                         photometric=3, colormap=cmap,
                         blocks=[bytes([0xC1] * 9 + [5] + [0xC2] * 10)])
    over = over.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                        b"\x03\x01\x03\x00\x01\x00\x00\x00\x29\x80")
    assert not _as_cv2_or_raises(over, tmp_path, "too much")
    tiles = [tc.thunder_row(rng, 32) * 16 for _ in range(2)]
    tiled = cc.tiff_bytes(np.zeros((16, 40, 1), np.uint8), bits=4,
                          photometric=3, colormap=cmap, tile=(16, 32),
                          blocks=tiles)
    tiled = tiled.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                          b"\x03\x01\x03\x00\x01\x00\x00\x00\x29\x80")
    ref, got = _both(tiled, tmp_path)  # no tile decoder: an undecoded image
    assert ref is not None and (ref == ref[0, 0]).all()
    assert "no tile decoder" in str(got)
    grey = cc.tiff_bytes(np.zeros((2, 10, 1), np.uint8), bits=4,
                         photometric=1, blocks=[bytes([0xC1] * 20)])
    grey = grey.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                        b"\x03\x01\x03\x00\x01\x00\x00\x00\x29\x80")
    _as_cv2(grey, tmp_path, "grey", refused=True)


# ------------------------------------------------------------------ SGILog

def _with_compression(data, comp, big_endian=False):
    old = b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00"
    if big_endian:
        old = b"\x01\x03\x00\x03\x00\x00\x00\x01\x00\x01"
        return data.replace(old, old[:8] + comp.to_bytes(2, "big"))
    return data.replace(old, old[:8] + comp.to_bytes(2, "little"))


def test_sgilog_as_cv2(tmp_path):
    """SGILog (34676) in libtiff's 8-bit output: LogL (16-bit log
    luminance) as grey, LogLuv (32-bit L, u, v) as RGB through
    LogLuv32toXYZ and XYZtoRGB24, over luminances below, across and
    above 1 and both signs; 8- and 16-bit tags, strips and tiles, both
    byte orders, FillOrder 2 (ignored: libtiff never reverses SGILog),
    an orientation; refused as cv2 refuses them: other photometrics,
    32-bit and float tags, LogL or LogLuv under other compressions, a
    2-sample LogL; SGILog24 (34677: LogLuv24, its colour through
    uvcode.h's table) on seeded codes, FillOrder 2, truncated."""
    rng = np.random.default_rng(14)
    h, w = 24, 40
    le = rng.integers(11000, 17500, (h, w))
    le[:, :8] = le[:, :1]  # runs
    le[rng.random((h, w)) < 0.05] |= 0x8000
    logl = tc.sgilog_strip(le, 2)
    uv = (rng.integers(60, 130, (h, w)) << 8) | rng.integers(110, 200,
                                                             (h, w))
    logluv = tc.sgilog_strip(le << 16 | uv, 4)
    for bits in (8, 16):
        for fo in (1, 2):
            for be in (False, True):
                tags = [(266, 3, [2])] if fo == 2 else []
                for spp, ph, strip in ((1, 32844, logl), (3, 32845, logluv)):
                    data = cc.tiff_bytes(np.zeros((h, w, spp), np.uint8),
                                         bits=bits, photometric=ph,
                                         blocks=[strip], big_endian=be,
                                         orientation=3 if be else None,
                                         extra_tags=tags)
                    _as_cv2(_with_compression(data, 34676, be), tmp_path,
                            (bits, fo, be, ph), refused=False)
    t = tc.sgilog_strip(rng.integers(11000, 17500, (32, 32)), 2)
    data = cc.tiff_bytes(np.zeros((20, 40, 1), np.uint8), bits=16,
                         photometric=32844, tile=(32, 32), blocks=[t, t])
    _as_cv2(_with_compression(data, 34676), tmp_path, "tiles",
            refused=False)
    for spp, ph, bits, comp in ((1, 1, 16, 34676), (1, 32844, 32, 34676),
                                (1, 32844, 16, 1), (3, 32845, 16, 5),
                                (2, 32844, 16, 34676)):
        data = cc.tiff_bytes(np.zeros((h, w, spp), np.uint8), bits=bits,
                             photometric=ph, blocks=[logl])
        _as_cv2(_with_compression(data, comp), tmp_path, (ph, bits, comp),
                refused=True)
    raw24 = rng.integers(0, 256, h * w * 3, np.uint8).tobytes()
    for fo in (1, 2):
        data = cc.tiff_bytes(np.zeros((h, w, 3), np.uint8), bits=16,
                             photometric=32845, blocks=[raw24],
                             extra_tags=[(266, 3, [2])] if fo == 2 else [])
        _as_cv2(_with_compression(data, 34677), tmp_path, ("24", fo),
                refused=False)
    data = cc.tiff_bytes(np.zeros((h, w, 3), np.uint8), bits=16,
                         photometric=32845, blocks=[raw24[:-3]])
    assert not _as_cv2_or_raises(_with_compression(data, 34677), tmp_path,
                                 "24 truncated")
    cut = cc.tiff_bytes(np.zeros((h, w, 1), np.uint8), bits=16,
                        photometric=32844, blocks=[logl[:len(logl) // 2]])
    assert not _as_cv2_or_raises(_with_compression(cut, 34676), tmp_path,
                                 "truncated")


@pytest.mark.slow
def test_sgilog24_every_code_as_cv2(tmp_path):
    """LogLuv24: every 24-bit code (all 1024 log luminances against all
    16384 colour codes, the 95 past uvcode.h's table neutral)."""
    v = np.arange(1 << 24, dtype=np.int64)
    raw = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).tobytes()
    step = 256 * 4096 * 3
    data = cc.tiff_bytes(np.zeros((4096, 4096, 3), np.uint8), bits=16,
                         photometric=32845, rows_per_strip=256,
                         blocks=[raw[k:k + step]
                                 for k in range(0, len(raw), step)])
    _as_cv2(_with_compression(data, 34677), tmp_path, "all", refused=False)


# ------------------------------------------------------------ corruptions

def _corruption_bases(rng):
    """One file of each codec and interpretation this file covers, and of
    the containers file's (their directories go through the same
    checks)."""
    img = _scene(rng, 40, 56)
    bilevel = (img[..., 0] > 128).astype(np.uint8)
    words = rng.integers(11000, 17500, (40, 56))
    return {
        "lzw tiles": cc.tiff_bytes(img, compression=5, predictor=2,
                                   tile=(16, 32)),
        "palette": cc.tiff_bytes(img[..., :1] % 16, bits=4, photometric=3,
                                 compression=32773,
                                 colormap=rng.integers(0, 65536, (16, 3))),
        "bigtiff mm": cc.tiff_bytes(img.astype(np.int64) * 257, bits=16,
                                    big_endian=True, bigtiff=True,
                                    compression=32946, predictor=2),
        "bilevel strips": cc.tiff_bytes(bilevel, bits=1, photometric=0,
                                        rows_per_strip=7),
        "planar rgba": cc.tiff_bytes(np.dstack([img, img[..., :1]]),
                                     extra_samples=[2], compression=8,
                                     planar=2, rows_per_strip=9),
        "mh": tc.fax_tiff(bilevel, 2), "mhw": tc.fax_tiff(bilevel, 32771),
        "t4 2-D": tc.fax_tiff(bilevel, 3, options=1, fill=True),
        "t6 tiles": tc.fax_tiff(bilevel, 4, tile=(16, 32)),
        "jpeg": tc.jpeg_tiff([_jpeg(img)], (40, 56)),
        "jpeg tables": tc.jpeg_tiff([_jpeg(img)], (40, 56), tables=True),
        "ycbcr lzw": cc.tiff_bytes(img, photometric=6, subsampling=(2, 2),
                                   compression=5),
        "cielab": cc.tiff_bytes(img, photometric=8),
        "logl": _with_compression(cc.tiff_bytes(
            np.zeros((40, 56, 1), np.uint8), bits=16, photometric=32844,
            blocks=[tc.sgilog_strip(words, 2)]), 34676),
        "logluv24": _with_compression(cc.tiff_bytes(
            np.zeros((40, 56, 3), np.uint8), bits=16, photometric=32845,
            blocks=[rng.integers(0, 256, 40 * 56 * 3, np.uint8).tobytes()]),
            34677),
        "thunderscan": _with_compression(cc.tiff_bytes(
            np.zeros((4, 56, 1), np.uint8), bits=4, photometric=3,
            colormap=rng.integers(0, 65536, (16, 3)),
            blocks=[b"".join(tc.thunder_row(rng, 56) for _ in range(4))]),
            32809)}


def _corrupt(rng, data):
    b = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
    if rng.random() < 0.2:
        b = b[:int(rng.integers(8, len(b)))]
    return bytes(b)


def _check_corruptions(seed, per_base, tmp_path):
    rng = np.random.default_rng(seed)
    read = 0
    for kind, data in _corruption_bases(rng).items():
        for k in range(per_base):
            read += _as_cv2_or_raises(_corrupt(rng, data), tmp_path,
                                      (kind, k))
    return read


def test_corrupt_tiffs_as_cv2_or_raises(tmp_path):
    """Seeded byte flips and truncations of a file of each codec and
    interpretation, in the directory and the data alike: whatever the
    port reads, cv2 reads the same (libtiff's refusals of a field's
    type, count or range, its estimates of bad uncompressed strip byte
    counts, strips past the end of the file, grfmt_tiff.cpp's size
    limits); the rest raise."""
    assert _check_corruptions(15, 24, tmp_path) > 50


@pytest.mark.slow
def test_corrupt_tiffs_as_cv2_or_raises_all(tmp_path):
    for seed in range(4):
        _check_corruptions(100 + seed, 300, tmp_path)


# ---------------------------------------------------------------- refusals

def test_refused_compressions_raise_as_cv2(tmp_path):
    """Old-style JPEG, PixarLog, LZMA, ZSTD, WebP, JBIG and LERC (cv2's
    libtiff is built without them) and NeXT (2-bit only, which cv2
    refuses) raise as cv2 refuses them: "cv2 does not read"."""
    img = np.zeros((16, 16, 3), np.uint8)
    for comp in (6, 32909, 34925, 50000, 50001, 34661, 34887, 32766):
        data = cc.tiff_bytes(img).replace(
            b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
            b"\x03\x01\x03\x00\x01\x00\x00\x00" + comp.to_bytes(2, "little"))
        ref, got = _both(data, tmp_path)
        assert ref is None and "cv2 does not read" in str(got), (comp, got)
    two = cc.tiff_bytes(np.zeros((4, 8, 1), np.uint8), bits=2).replace(
        b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
        b"\x03\x01\x03\x00\x01\x00\x00\x00\xfe\x7f")
    ref, got = _both(two, tmp_path)
    assert ref is None and isinstance(got, ValueError)
