"""TIFF reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads a TIFF with OpenCV 5.0's
libtiff 4.7.

cv2 reads a TIFF into an 8-bit colour image through libtiff's
`TIFFReadRGBAStrip` / `TIFFReadRGBATile` (grfmt_tiff.cpp: its own
sample reader serves only IMREAD_ANYDEPTH), so what it returns is
libtiff's RGBA conversion (tif_getimage.c) of the first IFD, alpha
dropped:

- grey, interleaved: 1-bit and 8-bit samples as they are (min-is-white
  inverted), 16-bit ones by their high byte; extra samples ignored;
- grey, planar: the first plane as it is (no inversion), 16-bit samples
  rounded to 8 bits as (v + 128) // 257;
- RGB: 8-bit samples as they are, 16-bit ones as (v + 128) // 257; an
  unassociated alpha (ExtraSamples 2) premultiplies, (c * a + 127) //
  255 on the 8-bit values; any other fourth sample is associated alpha
  and leaves the colour as it is;
- palette (1, 4 or 8 bits): the ColorMap, its 16-bit entries by their
  high byte unless every entry is below 256 (libtiff then takes it as an
  8-bit map);
- separated (InkSet CMYK, 8-bit, 4 or more samples): (255 - K) * (255 -
  C) // 255 for R, and alike for G and B;
- YCbCr (8-bit, 3 samples, subsampling 1x1, 1x2, 2x1, 2x2, 4x1, 4x2,
  4x4, or planar without subsampling): tif_color.c's fixed-point tables
  from YCbCrCoefficients and ReferenceBlackWhite, built in float32 as
  libtiff builds them, each data unit's Cb and Cr replicated over its
  Y samples (putcontig8bitYCbCr*tile; the 4x4 routine skips 10 bytes,
  not 18, for each clipped unit of a tile);
- CIELab (3 interleaved samples of 8 or 16 bits): TIFFCIELab16ToXYZ
  against the WhitePoint (D50 by default), then TIFFXYZToRGB through
  display_sRGB and its 1500-step gamma table, in float32.

The codecs: none (1), LZW (5), Deflate (8, 32946), PackBits (32773),
ThunderScan (32809, 4-bit), each after libtiff's bit reversal of the
raw strip or tile under FillOrder 2; CCITT Modified Huffman (2), T.4
(3), T.6 (4) and word-aligned Modified Huffman (32771), which read
FillOrder themselves (`native/codecs.cc`: its 32771 rows are where
libtiff's reader looks for them, aligned by the file offset as
cv2.imread's mapped file gives it); JPEG (7): each strip's or tile's
stream after the JPEGTables stream (`native/jpeg.cc`), converted by
libjpeg from YCbCr to RGB for contiguous YCbCr (JPEGCOLORMODE_RGB, the
YCbCrSubsampling tag or, without it, the first frame's factors on the
first component, 1x1 on the others) and left as it is otherwise;
SGILog (34676, 34677) in libtiff's 8-bit output: LogL as grey, LogLuv
and LogLuv24 as RGB.
Predictor 2 is undone under LZW and Deflate only (libtiff ignores the
tag under other compressions), on YCbCr data units as libtiff does it.
Each strip or tile is converted and placed as cv2 places it under the
Orientation tag: libtiff flips the block to its bottom-up raster (top
and bottom orientations) and mirrors it (right orientations) inside the
block, and cv2 writes the raster bottom row first at the block's row,
counted from the bottom for orientations 3, 4, 7 and 8.  Orientations
1-4 of a striped file come out as the EXIF turns; a tiled file mirrors
each tile in place.  Orientations 5-8 then make cv2 transpose the image,
which only a square image survives: other shapes raise, as cv2 returns
None ("Internal imread issue").

The directory is read as libtiff reads it: a field of the wrong type,
count or range refuses the file where TIFFReadDirectory does (the image
and strip fields, BitsPerSample, SampleFormat, ExtraSamples) and is
dropped where it drops it (the others); an uncompressed image's bad
strip byte counts are replaced by libtiff's estimates; a strip past the
end of the file, and strips or tiles past grfmt_tiff.cpp's limits (2^24
a side, 1 GiB with their RGBA buffer), refuse it.

What cv2 refuses raises ValueError naming the file and the cause: 2-bit
samples, 4-bit ones that are not palette indices, 10- to 64-bit and
floating-point samples, RGB below 8 bits, palette planes, separated data
that is not 8-bit CMYK, sub-byte interleaved samples with extra
channels, ICCLab and ITULab, the codecs cv2's libtiff is built without
("cv2 does not read": old-style JPEG, PixarLog, LZMA, ZSTD, WebP, JBIG,
LERC) and NeXT (2-bit only).  Where libtiff hands cv2 back what it
could not decode, this raises too: codecs libtiff has no decoder for (a
black image), tiled ThunderScan (no tile decoder), corrupt or truncated
data (rows padded or left unwritten).  Nothing cv2 reads is left "not
yet read by the port".  `tests/test_torch_port_tiff_codecs.py` and
PERF.md hold the table of what cv2 does, probed."""

import struct
import zlib

import numpy as np

from . import codecs, jpeg
from .jp2 import MAX_PIXELS, MAX_SIDE
from .jpeg import orient

#: tag numbers
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
FILL_ORDER = 266
STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP = 273, 274, 277, 278
STRIP_COUNTS, PLANAR, T4_OPTIONS, PREDICTOR, COLORMAP = 279, 284, 292, 317, 320
TILE_WIDTH, TILE_HEIGHT, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
INKSET, EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES = 332, 338, 339, 347
YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING, REFERENCE_BW = 529, 530, 532
WHITE_POINT = 318

#: type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 4),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}
#: rationals count two values per entry
_PAIRS = (5, 10)
#: the types libtiff reads an integer field from
_INTEGER = (1, 3, 4, 6, 8, 9, 16, 17)
#: fields whose wrong type, count or range makes libtiff refuse the
#: directory (TIFFReadDirectory's "goto bad"), with their widths in bits;
#: BitsPerSample and SampleFormat may hold one value per sample, equal,
#: ExtraSamples one per extra sample (`_check` bounds them)
_ESSENTIAL = {256: 32, 257: 32, 258: 16, 259: 16, 277: 16, 278: 32,
              284: 16, 322: 32, 323: 32, 338: 16, 339: 16}
#: other integer fields the port reads, with their widths and counts
#: (None: any): libtiff drops one of the wrong type, count or range
#: (the default holds; a palette image without its ColorMap is refused)
_OPTIONAL = {262: (16, 1), 266: (16, 1), 274: (16, 1), 292: (32, 1),
             317: (16, 1), 320: (16, None), 332: (16, 1), 530: (16, 2)}
#: strip and tile offsets and byte counts: libtiff refuses them in other
#: types than these (LONG8 in BigTIFF only) or negative
_STRILE_TAGS, _STRILE_TYPES = (273, 279, 324, 325), (1, 3, 4, 6, 8, 9)

#: compressions the port reads whose data libtiff bit-reverses first
#: under FillOrder 2: none, LZW, Deflate, PackBits, ThunderScan
_REVERSED = (1, 5, 8, 32946, 32773, 32809)
#: CCITT: Modified Huffman, T.4, T.6, Modified Huffman word-aligned
_FAX = (2, 3, 4, 32771)
JPEG = 7
THUNDERSCAN = 32809
#: codecs libtiff has that cv2's build leaves out ("compression support
#: is not configured"): cv2 returns None
_NOT_CONFIGURED = {6: "old-style JPEG", 34925: "LZMA", 50000: "ZSTD",
                   50001: "WebP", 34661: "JBIG", 34887: "LERC",
                   32909: "PixarLog"}
SGILOG, SGILOG24 = 34676, 34677
#: names of some compressions libtiff has no decoder for: cv2 returns a
#: black image for them ("strip decoding is not implemented")
_NO_DECODER = {34712: "JPEG 2000", 32908: "Pixar film", 32947: "DCS"}
#: the photometric interpretations of SGILog data
LOGL, LOGLUV = 32844, 32845
#: YCbCr subsamplings libtiff's put routines take (h << 4 | v)
_SUBSAMPLINGS = (0x11, 0x12, 0x21, 0x22, 0x41, 0x42, 0x44)

#: each byte with its bits reversed (FillOrder 2)
_BITREV = np.array([int("{:08b}".format(i)[::-1], 2) for i in range(256)],
                   np.uint8)

#: libtiff's flips of a block for each orientation, against its
#: bottom-up raster: (vertical, horizontal)
_FLIPS = {1: (True, False), 5: (True, False), 2: (True, True),
          6: (True, True), 3: (False, True), 7: (False, True),
          4: (False, False), 8: (False, False)}
#: the turn cv2 then gives a square image of orientation 5-8, as an EXIF
#: orientation of `jpeg.orient`
_AFTER = {5: 5, 6: 7, 7: 5, 8: 7}


def is_tiff(head):
    return head[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+")


def _ifd(data, name):
    """(tags {tag: tuple of values}, byte order) of the first IFD."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or len(data) < 8:
        raise ValueError("%s: not a TIFF file" % name)
    (magic,) = struct.unpack(order + "H", data[2:4])
    big = magic == 43
    if big:
        if len(data) < 16:
            raise ValueError("%s: truncated BigTIFF header" % name)
        size, unused, first = struct.unpack(order + "HHQ", data[4:16])
        if size != 8 or unused:
            raise ValueError("%s: BigTIFF offset size %d, reserved %d"
                             % (name, size, unused))
    elif magic == 42:
        (first,) = struct.unpack(order + "I", data[4:8])
    else:
        raise ValueError("%s: not a TIFF file" % name)
    head, entry = (8, 20) if big else (2, 12)
    if first + head > len(data):
        raise ValueError("%s: first IFD past the end of the file" % name)
    (count,) = struct.unpack(order + ("Q" if big else "H"),
                             data[first:first + head])
    if first + head + count * entry > len(data):
        raise ValueError("%s: IFD runs past the end of the file" % name)
    tags = {}
    for k in range(count):
        e = first + head + k * entry
        tag, typ = struct.unpack(order + "HH", data[e:e + 4])
        if typ not in _TYPES:
            if tag in _ESSENTIAL or tag in _STRILE_TAGS:
                raise ValueError("%s: TIFF tag %d of unknown type %d"
                                 % (name, tag, typ))
            continue
        (n,) = struct.unpack(order + ("Q" if big else "I"),
                             data[e + 4:e + (12 if big else 8)])
        code, size = _TYPES[typ]
        n_vals = n * (2 if typ in _PAIRS else 1)
        nbytes = n_vals * size
        at = e + (12 if big else 8)
        if nbytes > (8 if big else 4):
            (at,) = struct.unpack(order + ("Q" if big else "I"),
                                  data[at:at + (8 if big else 4)])
        if at + nbytes > len(data):
            raise ValueError("%s: tag %d's values run past the end of the "
                             "file" % (name, tag))
        if tag in tags:
            continue
        vals = struct.unpack(order + code * n_vals, data[at:at + nbytes])
        if tag in _ESSENTIAL:
            if typ not in _INTEGER or (not vals and tag != 338) or (vals and (
                    min(vals) < 0 or max(vals) >> _ESSENTIAL[tag])) or (
                        len(vals) > 1 and tag != 338 and (
                            tag not in (258, 339) or len(set(vals)) > 1)):
                raise ValueError("%s: TIFF tag %d of type %d with %d values "
                                 "libtiff refuses" % (name, tag, typ, n))
        elif tag in _OPTIONAL:
            bits, want = _OPTIONAL[tag]
            if typ not in _INTEGER or not vals or min(vals) < 0 or max(
                    vals) >> bits or want not in (None, len(vals)):
                continue
        elif tag in _STRILE_TAGS:
            if typ not in _STRILE_TYPES + ((16,) if big else ()) or (
                    vals and min(vals) < 0):
                raise ValueError("%s: TIFF strip or tile offsets or byte "
                                 "counts of type %d" % (name, typ))
        tags[tag] = vals
    return tags, order


def _decompress(raw, size, compression, name):
    if compression == 1:
        if len(raw) < size:
            raise ValueError("%s: strip or tile shorter than its %d bytes"
                             % (name, size))
        return np.frombuffer(raw, np.uint8, size).copy()
    if compression == 5:
        return codecs.tiff_lzw(raw, size, name)
    if compression in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError("%s: Deflate data: %s" % (name, e))
        if len(out) < size:
            raise ValueError("%s: Deflate data ends after %d of %d bytes"
                             % (name, len(out), size))
        return np.frombuffer(out, np.uint8).copy()
    return codecs.packbits(raw, size, name)


def _unpack(buf, rows, cols, spp, bits, order):
    """(rows, cols, spp) samples of a block's bytes (rows padded to a
    byte): uint8 up to 8 bits, uint16 at 16."""
    if bits == 16:
        return buf.view(order + "u2").astype(np.uint16).reshape(
            rows, cols, spp)
    if bits == 8:
        return buf.reshape(rows, cols, spp)
    row_bytes = (cols * spp * bits + 7) // 8
    b = np.unpackbits(buf.reshape(rows, row_bytes), axis=1)
    b = b[:, :cols * spp * bits].reshape(rows, cols * spp, bits)
    v = (b * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(
        -1, dtype=np.uint8)
    return v.reshape(rows, cols, spp)


def _skewed(buf, rows, tw, rxs, spp, bits, order):
    """(rows, rxs, spp) samples of the clipped right edge of a tile as
    libtiff's grey and palette put routines read them (`put16bitbwtile`,
    `putgreytile`, `putagreytile`, `put8bitcmaptile`): after each row of
    rxs pixels they skip tw - rxs bytes, not pixels, of the tile's
    buffer (16-bit samples in the host's byte order)."""
    if bits == 16 and order == ">":
        buf = buf.view(">u2").astype("<u2").view(np.uint8)
    pb = spp * bits // 8
    step = rxs * pb + (tw - rxs)
    at = np.arange(rows)[:, None] * step + np.arange(rxs * pb)[None, :]
    px = np.ascontiguousarray(buf[at])
    if bits == 16:
        return px.view("<u2").astype(np.uint16).reshape(rows, rxs, spp)
    return px.reshape(rows, rxs, spp)


def _to8(v):
    """libtiff's Bitdepth16To8: (v + 128) // 257."""
    return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)


def _premultiply(rgb, a):
    """libtiff's UaToAa: (c * a + 127) // 255 on 8-bit values."""
    return ((rgb.astype(np.uint32) * a[..., None] + 127) // 255).astype(
        np.uint8)


def _rgb(s, photometric, planar, bits, alpha, cmap, white):
    """(h, w, 3) uint8 of a block's samples (h, w, spp), as libtiff's put
    routines convert them."""
    if photometric == 8:
        return _cielab_rgb(s, bits, white)
    if photometric in (0, 1):
        if planar == 2:  # as RGB: no inversion, 16 bits rounded
            g = _to8(s[..., :1]) if bits == 16 else s[..., :1]
            g = np.repeat(g, 3, -1)
            if alpha == 2:
                a = _to8(s[..., 1]) if bits == 16 else s[..., 1]
                return _premultiply(g, a)
            return g
        g = s[..., 0]
        if bits == 16:
            g = (g >> 8).astype(np.uint8)
        elif bits == 1:
            g = g * np.uint8(255)
        if photometric == 0:
            g = 255 - g
        return np.repeat(g[..., None], 3, -1)
    if photometric == 2:
        c = _to8(s[..., :3]) if bits == 16 else s[..., :3]
        if alpha == 2:
            a = _to8(s[..., 3]) if bits == 16 else s[..., 3]
            return _premultiply(c, a)
        return np.ascontiguousarray(c)
    if photometric == 3:
        return cmap[s[..., 0]]
    k = 255 - s[..., 3:4].astype(np.uint32)  # separated: CMYK
    return (k * (255 - s[..., :3].astype(np.uint32)) // 255).astype(
        np.uint8)


def _floats(tags, tag, default):
    """A RATIONAL tag's values as libtiff's float32 (num / den, 0 for a
    zero denominator), or `default`."""
    v = tags.get(tag)
    if not v or len(v) < 2 * len(default):
        return [np.float32(d) for d in default]
    return [np.float32(v[2 * i] / v[2 * i + 1] if v[2 * i + 1] else 0.0)
            for i in range(len(default))]


def _ycbcr_tables(luma, refbw):
    """tif_color.c's TIFFYCbCrToRGBInit: (Cr_r, Cb_b, Cr_g, Cb_g, Y) int64
    tables over 0..255 from YCbCrCoefficients and ReferenceBlackWhite,
    in float32 as libtiff computes them (FIX adds its 0.5 in double)."""
    f32 = np.float32

    def clamp(f, lo, hi):  # !(f >= lo) first: NaN gives lo
        return lo if not f >= lo else (hi if f > hi else f)

    def fix(x):
        return int(np.float64(f32(x) * f32(65536)) + 0.5)

    def code2v(c, rb, rw, cr):  # rb truncated to int32 first
        d = f32(rw - rb)
        return f32(f32(f32(c - int(rb)) * f32(cr)) / (d if d != 0 else f32(1)))

    lr, lg, lb = luma
    f1 = f32(2) - f32(2) * lr
    d1 = fix(clamp(f1, f32(0), f32(2)))
    d2 = -fix(clamp(f32(f32(lr * f1) / lg), f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clamp(f3, f32(0), f32(2)))
    d4 = -fix(clamp(f32(f32(lb * f3) / lg), f32(0), f32(2)))
    lo, hi = f32(-128 * 32), f32(128 * 32)
    tabs = [[] for _ in range(5)]
    for i in range(256):
        x = i - 128
        cr = int(clamp(code2v(x, refbw[4] - f32(128), refbw[5] - f32(128),
                              127), lo, hi))
        cb = int(clamp(code2v(x, refbw[2] - f32(128), refbw[3] - f32(128),
                              127), lo, hi))
        tabs[0].append((d1 * cr + 32768) >> 16)
        tabs[1].append((d3 * cb + 32768) >> 16)
        tabs[2].append(d2 * cr)
        tabs[3].append(d4 * cb + 32768)
        tabs[4].append(int(clamp(code2v(x + 128, refbw[0], refbw[1], 255),
                                 lo, hi)))
    return [np.asarray(t, np.int64) for t in tabs]


def _ycbcr_rgb(buf, rows, cols, bw, hs, vs, tables):
    """(rows, cols, 3) uint8 of the top-left rows x cols pixels of a
    block bw pixels wide of YCbCr data units (hs * vs Y samples, then Cb
    and Cr), as tif_getimage.c's putcontig8bitYCbCr*tile and
    TIFFYCbCrtoRGB convert them.  Past each row of units they skip the
    clipped units of a tile, (bw - cols) // hs of them; the 4x4 routine
    counts 10 bytes, not 18, for each."""
    unit = hs * vs + 2
    uh, uw = -(-rows // vs), -(-cols // hs)
    stride = uw * unit + (bw - cols) // hs * (10 if hs == vs == 4 else unit)
    at = np.arange(uh)[:, None] * stride + np.arange(uw * unit)[None, :]
    if at.size and at[-1, -1] >= buf.size:
        raise ValueError("YCbCr block shorter than its data units")
    u = buf[at].reshape(uh, uw, unit)
    y = u[..., :hs * vs].reshape(uh, uw, vs, hs).transpose(0, 2, 1, 3)
    y = y.reshape(uh * vs, uw * hs)[:rows, :cols].astype(np.int64)
    cb = np.repeat(np.repeat(u[..., -2], vs, 0), hs, 1)[:rows, :cols]
    cr = np.repeat(np.repeat(u[..., -1], vs, 0), hs, 1)[:rows, :cols]
    cr_r, cb_b, cr_g, cb_g, yt = tables
    y = yt[y]
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


#: tif_color.c's display_sRGB: the XYZ -> RGB matrix (float32)
_SRGB = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                  [0.0556, -0.2040, 1.0570]], np.float32)
#: TIFFCIELabToRGBInit's Yr2r table (1500 steps of gamma 2.4, float32;
#: the three guns share it) and its step
_LAB_STEPS = 1500
_LAB_STEP = np.float32(np.float32(99.0) / np.float32(_LAB_STEPS))
_LAB_TABLE = (np.float32(255) * np.power(
    np.arange(_LAB_STEPS + 1) / _LAB_STEPS,
    1.0 / np.float64(np.float32(2.4))).astype(np.float32)).astype(np.float32)


def _cielab_rgb(s, bits, white):
    """(h, w, 3) uint8 of CIELab samples (h, w, 3) as tif_getimage.c's
    putcontig8bitCIELab8/16 convert them: TIFFCIELab16ToXYZ (L * 257 and
    a, b * 256 at 8 bits) against the WhitePoint's reference white, then
    TIFFXYZToRGB through display_sRGB, every step in float32 in C's
    order."""
    f32 = np.float32
    L = s[..., 0].astype(np.float32)
    if bits == 8:
        L = L * f32(257)
        a = (s[..., 1].astype(np.int64) ^ 128) - 128
        b = (s[..., 2].astype(np.int64) ^ 128) - 128
        a, b = (a * 256).astype(np.float32), (b * 256).astype(np.float32)
    else:
        a = ((s[..., 1].astype(np.int64) ^ 0x8000) - 0x8000).astype(
            np.float32)
        b = ((s[..., 2].astype(np.int64) ^ 0x8000) - 0x8000).astype(
            np.float32)
    wx, wy = white
    x0 = f32(f32(wx / wy) * f32(100))
    y0 = f32(100)
    z0 = f32(f32(f32(f32(1) - wx) - wy) / wy * f32(100))
    L = (L * f32(100)) / f32(65535)
    small = L < f32(8.856)
    y_small = (L * y0) / f32(903.292)
    cby = np.where(small, f32(7.787) * (y_small / y0) + f32(16.0 / 116.0),
                   (L + f32(16)) / f32(116)).astype(np.float32)
    Y = np.where(small, y_small, ((y0 * cby) * cby) * cby).astype(np.float32)

    def cube(t, w0):
        return np.where(t < f32(0.2069), (w0 * (t - f32(0.13793)))
                        / f32(7.787), ((w0 * t) * t) * t).astype(np.float32)

    X = cube((a / f32(256) / f32(500) + cby).astype(np.float32), x0)
    Z = cube((cby - b / f32(256) / f32(200)).astype(np.float32), z0)
    out = np.empty(s.shape[:2] + (3,), np.uint8)
    for k in range(3):
        m = _SRGB[k]
        lum = np.clip(((m[0] * X + m[1] * Y) + m[2] * Z).astype(np.float32),
                      f32(1), f32(100))
        i = np.minimum(((lum - f32(1)) / _LAB_STEP).astype(np.int64),
                       _LAB_STEPS)
        out[..., k] = np.minimum(np.floor(_LAB_TABLE[i].astype(np.float64)
                                          + 0.5), 255)
    return out


def _estimated_counts(tags, offsets, counts, nstrips, file_size):
    """An uncompressed image's strip byte counts as TIFFReadDirectory
    leaves them: a single strip whose count looks bad (none, past the
    file, short of the image) gets the image's size; more than two
    interleaved strips whose first two counts differ get, each, a
    scanline times the image's height over the number of strips
    (rounded down, so that the last rows of each strip may then be
    missing)."""
    def one(tag, default):
        return tags.get(tag, (default,))[0]

    W, H = one(WIDTH, 0), one(HEIGHT, 0)
    bits, spp = one(BITS, 1), one(SPP, 1)
    sub = tags.get(YCBCR_SUBSAMPLING, (2, 2))
    if one(PHOTOMETRIC, 0) == 6 and one(PLANAR, 1) == 1:
        units = -(-W // sub[0]) * (sub[0] * sub[1] + 2)
        scanline = -(-units * bits // 8) // sub[1]
    else:
        per = spp if one(PLANAR, 1) == 1 else 1
        scanline = -(-W * per * bits // 8)
    counts = list(counts[:nstrips])
    if nstrips == 1:
        if (counts[0] == 0 and offsets[0] != 0) or (
                offsets[0] <= file_size and counts[0] > file_size -
                offsets[0]) or counts[0] < scanline * H:
            counts[0] = scanline * H
    elif nstrips > 2 and (one(PLANAR, 1) == 1 or spp == 1) and \
            counts[0] != counts[1] and counts[0] and counts[1]:
        counts = [scanline * (H // nstrips)] * nstrips
    return counts


def _check(tags, name, file_size):
    """The reading parameters, or ValueError where cv2 (its header checks
    or libtiff's TIFFRGBAImageOK) refuses the file."""
    def one(tag, default=None):
        v = tags.get(tag)
        if v and not isinstance(v[0], int):  # libtiff reads them as ints
            raise ValueError("%s: TIFF tag %d of a floating-point type"
                             % (name, tag))
        return default if not v else v[0]

    if WIDTH not in tags or HEIGHT not in tags or PHOTOMETRIC not in tags:
        raise ValueError("%s: TIFF without ImageWidth, ImageLength or "
                         "PhotometricInterpretation" % name)
    W, H, photometric = one(WIDTH), one(HEIGHT), one(PHOTOMETRIC)
    if W is None or H is None or photometric is None:
        raise ValueError("%s: TIFF with an empty ImageWidth, ImageLength or "
                         "PhotometricInterpretation" % name)
    bits, spp = one(BITS, 1), one(SPP, 1)
    compression = one(COMPRESSION, 1)
    planar = one(PLANAR, 1)
    fmt = one(SAMPLE_FORMAT, 1)
    if W == 0 or H == 0:
        raise ValueError("%s: empty TIFF image" % name)
    if W > MAX_SIDE or H > MAX_SIDE or W * H > MAX_PIXELS:
        raise ValueError("%s: %dx%d TIFF past cv2's image size limits"
                         % (name, W, H))
    if not 1 <= spp <= 4:
        raise ValueError("%s: cv2 reads 1 to 4 samples per pixel, not %d"
                         % (name, spp))
    if planar not in (1, 2):
        raise ValueError("%s: TIFF PlanarConfiguration %d" % (name, planar))
    if spp == 1:
        planar = 1  # one sample: both configurations lay it out alike
    if compression in _NOT_CONFIGURED:
        raise ValueError("%s: TIFF compression %d (%s): cv2 does not read "
                         "it (its libtiff is built without it)"
                         % (name, compression, _NOT_CONFIGURED[compression]))
    if compression == 32766:
        raise ValueError("%s: TIFF compression 32766 (NeXT): cv2 does not "
                         "read it (libtiff's NeXT decoder takes only 2-bit "
                         "samples, which cv2 refuses)" % name)
    sgilog = None
    if photometric in (LOGL, LOGLUV) or compression in (SGILOG, SGILOG24):
        # libtiff's RGBA route reads SGILog in its 8-bit format: LogL as
        # 8-bit grey, LogLuv as 8-bit RGB
        if photometric not in (LOGL, LOGLUV) or compression not in (
                SGILOG, SGILOG24) or (photometric == LOGL and compression !=
                                      SGILOG):
            raise ValueError("%s: libtiff reads LogL only as SGILog and "
                             "LogLuv only as SGILog or SGILog24, and SGILog "
                             "only as those" % name)
        if not ((photometric == LOGL and spp == 1) or
                (photometric == LOGLUV and spp == 3 and planar == 1)):
            raise ValueError("%s: SGILog with %d samples per pixel"
                             % (name, spp))
    if compression not in _REVERSED + _FAX + (JPEG, SGILOG, SGILOG24):
        raise ValueError("%s: TIFF compression %d (%s): libtiff has no "
                         "decoder for it (cv2 returns a black image)"
                         % (name, compression,
                            _NO_DECODER.get(compression, "unknown")))
    if bits == 4 and photometric != 3:
        raise ValueError("%s: cv2 reads 4-bit TIFF samples only as palette "
                         "indices" % name)
    if bits not in (1, 4, 8, 16):
        raise ValueError("%s: cv2 does not read %d-bit TIFF samples"
                         % (name, bits))
    if fmt not in (1, 2):
        raise ValueError("%s: cv2 does not read TIFF sample format %d at %d "
                         "bits" % (name, fmt, bits))
    if compression in (SGILOG, SGILOG24):
        # 0 LogL, 1 LogLuv, 2 LogLuv24: 8-bit grey or RGB
        sgilog = 0 if photometric == LOGL else 1 + (compression == SGILOG24)
        photometric, bits = (2 if sgilog else 1), 8
    if compression in _FAX and bits != 1:
        raise ValueError("%s: libtiff decodes CCITT data only at 1 bit per "
                         "sample" % name)
    if compression == THUNDERSCAN and bits != 4:
        raise ValueError("%s: libtiff decodes ThunderScan data only at 4 "
                         "bits per sample" % name)
    if compression == JPEG and bits != 8:
        raise ValueError("%s: JPEG-compressed TIFF with %d-bit samples"
                         % (name, bits))
    extra = tags.get(EXTRA_SAMPLES, ())
    if len(extra) > spp or (extra and max(extra) > 2):
        raise ValueError("%s: ExtraSamples %s for %d samples per pixel"
                         % (name, extra, spp))
    colors = spp - len(extra)
    alpha = 0
    if extra:
        alpha = extra[0] if extra[0] in (1, 2) else (1 if spp > 3 else 0)
    elif photometric == 2 and spp == 4:
        alpha = 1
    if photometric in (0, 1, 3) and planar == 1 and spp != 1 and bits < 8:
        raise ValueError("%s: libtiff does not convert interleaved %d-bit "
                         "samples with %d per pixel" % (name, bits, spp))
    ycbcr = None
    if photometric == 6:
        if compression == JPEG and planar == 1:  # libjpeg makes it RGB
            photometric = 2
        else:
            sub = tags.get(YCBCR_SUBSAMPLING, (2, 2))
            if bits != 8 or spp != 3 or len(sub) < 2 or \
                    (sub[0] << 4 | sub[1]) not in _SUBSAMPLINGS:
                raise ValueError("%s: libtiff converts only 8-bit YCbCr with "
                                 "3 samples and subsampling 1, 2 or 4 (v <= "
                                 "h)" % name)
            if planar == 2 and tuple(sub[:2]) != (1, 1):
                raise ValueError("%s: libtiff converts planar YCbCr only "
                                 "without subsampling" % name)
            luma = _floats(tags, YCBCR_COEFFICIENTS, (0.299, 0.587, 0.114))
            refbw = _floats(tags, REFERENCE_BW, (0, 255, 128, 255, 128, 255))
            if any(np.isnan(v) for v in luma) or luma[1] == 0 or not all(
                    -2147483519.0 < v < 2147483647.0 for v in refbw):
                raise ValueError("%s: bad YCbCrCoefficients or "
                                 "ReferenceBlackWhite" % name)
            ycbcr = (sub[0], sub[1], _ycbcr_tables(luma, refbw))
    if photometric == 2:
        if colors < 3:
            raise ValueError("%s: RGB TIFF with %d colour samples"
                             % (name, colors))
        if bits not in (8, 16):
            raise ValueError("%s: libtiff does not convert %d-bit RGB"
                             % (name, bits))
    elif photometric == 3:
        if planar != 1:
            raise ValueError("%s: libtiff does not convert planar palette "
                             "images" % name)
        if bits == 16:
            raise ValueError("%s: libtiff does not convert 16-bit palette "
                             "images" % name)
        if COLORMAP not in tags or len(tags[COLORMAP]) != 3 << bits:
            raise ValueError("%s: palette TIFF without its ColorMap" % name)
    elif photometric == 5:
        if one(INKSET, 1) != 1 or spp < 4 or bits != 8:
            raise ValueError("%s: libtiff converts separated images only as "
                             "8-bit CMYK" % name)
    elif photometric == 8:
        if spp != 3 or extra or bits not in (8, 16) or planar != 1:
            raise ValueError("%s: libtiff converts CIELab only as 3 "
                             "interleaved samples of 8 or 16 bits" % name)
    elif photometric not in (0, 1, 6):
        raise ValueError("%s: cv2 does not read TIFF photometric "
                         "interpretation %d" % (name, photometric))
    # libtiff knows the Predictor tag only under LZW and Deflate: under
    # other compressions it is an unknown field, ignored
    predictor = one(PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise ValueError("%s: predictor %d with %d-bit samples"
                         % (name, predictor, bits))
    tiled = TILE_WIDTH in tags or TILE_HEIGHT in tags  # either: libtiff
    if tiled:
        if TILE_WIDTH not in tags or TILE_HEIGHT not in tags or \
                TILE_OFFSETS not in tags:
            raise ValueError("%s: tiled TIFF without TileWidth, TileLength "
                             "or TileOffsets" % name)
        bh, bw = one(TILE_HEIGHT), one(TILE_WIDTH)
        th0, tw0 = bh, bw
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_COUNTS)
        if compression == THUNDERSCAN:
            raise ValueError("%s: tiled ThunderScan TIFF: libtiff has no "
                             "tile decoder for it (cv2 returns an undecoded "
                             "image)" % name)
    else:
        if STRIP_OFFSETS not in tags:
            raise ValueError("%s: TIFF without StripOffsets" % name)
        rps = one(ROWS_PER_STRIP, 0xFFFFFFFF)
        bh, bw = min(rps, H), W
        th0, tw0 = (H if rps == 0xFFFFFFFF else rps), W
        offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_COUNTS)
    if bh == 0 or bw == 0:
        raise ValueError("%s: zero rows per strip or tile size" % name)
    # grfmt_tiff.cpp's limits, on the strip's rows as the tag gives them:
    # the strip or tile and its RGBA buffer under 1 GiB
    if not (0 < tw0 <= 1 << 24 and 0 < th0 <= 1 << 24) or tw0 * th0 * max(
            spp * max(1, one(BITS, 1) // 8), 4) >= 1 << 30:
        raise ValueError("%s: %dx%d strips or tiles past cv2's limits "
                         "(2^24 a side, 1 GiB)" % (name, tw0, th0))
    tile_bytes = bh * ((bw * (spp if planar == 1 else 1) * bits + 7) // 8)
    if tiled and compression == 1 and one(FILL_ORDER, 1) == 2 and \
            tile_bytes % 1024:
        # libtiff reads such a tile into its buffer, rounded up to 1 KiB,
        # and then finds the tile's size short of the buffer's
        raise ValueError("%s: uncompressed FillOrder 2 tiles of %d bytes: "
                         "libtiff reads only multiples of 1024"
                         % (name, tile_bytes))
    blocks = -(-H // bh) * -(-W // bw)
    planes = spp if planar == 2 else 1
    if counts is None or len(offsets) < blocks * planes or \
            len(counts) < blocks * planes:
        raise ValueError("%s: %d strip or tile offsets and byte counts for "
                         "%d" % (name, min(len(offsets), len(counts or ())),
                                 blocks * planes))
    if compression == 1 and not tiled:
        counts = _estimated_counts(tags, offsets, counts, blocks * planes,
                                   file_size)
    if photometric == 3:
        cm = np.asarray(tags[COLORMAP][:3 << bits], np.uint32).reshape(
            3, 1 << bits).T
        cmap = (cm >> 8 if cm.max() >= 256 else cm).astype(np.uint8)
    else:
        cmap = None
    orientation = one(ORIENTATION, 1)
    if orientation not in _FLIPS:
        orientation = 1
    jpeg = None
    if compression == JPEG:
        # libjpeg converts contiguous YCbCr to RGB; the first component
        # must have the YCbCrSubsampling factors (when the tag is absent,
        # libtiff takes them from the first strip's frame), the others 1x1
        sub = None
        if one(PHOTOMETRIC) == 6:
            sub = tags.get(YCBCR_SUBSAMPLING)
            if sub and len(sub) >= 2 and not (sub[0] in (1, 2, 4)
                                              and sub[1] in (1, 2, 4)):
                raise ValueError("%s: YCbCrSubsampling %d, %d (libtiff takes "
                                 "1, 2 or 4)" % (name, sub[0], sub[1]))
            sub = sub[0] << 4 | sub[1] if sub and len(sub) >= 2 else "frame"
        jpeg = dict(tables=bytes(tags.get(JPEG_TABLES, ())),
                    ycbcr=one(PHOTOMETRIC) == 6, sampling=sub or 0x11)
    white = None
    if photometric == 8:
        d50 = (np.float32(96.4250), np.float32(100.0), np.float32(82.4680))
        total = d50[0] + d50[1] + d50[2]
        white = _floats(tags, WHITE_POINT, (d50[0] / total, d50[1] / total))
        if white[1] == 0:
            raise ValueError("%s: WhitePoint with y 0" % name)
    return dict(W=W, H=H, photometric=photometric, bits=bits, spp=spp,
                planar=planar, compression=compression, alpha=alpha,
                predictor=predictor, tiled=tiled, bh=bh, bw=bw,
                offsets=offsets, counts=counts, cmap=cmap,
                orientation=orientation, ycbcr=ycbcr, jpeg=jpeg, white=white,
                sgilog=sgilog,
                fill_order=one(FILL_ORDER, 1),
                t4_options=one(T4_OPTIONS, 0))


def _jpeg_block(raw, p, seg_h, seg_w, last_strip, name):
    """The bytes of one strip or tile (seg_h rows of seg_w pixels) of a
    JPEG-compressed TIFF, checked as tif_jpeg.c's JPEGPreDecode checks
    its frame.  A frame smaller than the strip or tile raises (libtiff
    leaves the rest of it unwritten), as does one larger (libtiff
    refuses it, but for a last strip of the image's width that is
    taller)."""
    j = p["jpeg"]
    img, (nc, sampling, others_1x1, precision) = jpeg.decode_tiff_block(
        j["tables"], raw, j["ycbcr"] and p["planar"] == 1, name)
    sh, sw = img.shape[:2]
    if sw < seg_w or sh < seg_h:
        raise ValueError("%s: JPEG strip or tile of %dx%d, smaller than its "
                         "%dx%d" % (name, sw, sh, seg_w, seg_h))
    if sw > seg_w or (sh > seg_h and not last_strip):
        raise ValueError("%s: JPEG strip or tile of %dx%d, larger than its "
                         "%dx%d" % (name, sw, sh, seg_w, seg_h))
    if nc != (p["spp"] if p["planar"] == 1 else 1):
        raise ValueError("%s: JPEG data with %d components for %d samples"
                         % (name, nc, p["spp"]))
    if precision != p["bits"]:
        raise ValueError("%s: %d-bit JPEG data for %d-bit samples"
                         % (name, precision, p["bits"]))
    if j["sampling"] == "frame":  # JPEGFixupTagsSubsampling
        j["sampling"] = sampling if others_1x1 and sampling >> 4 in (
            1, 2, 4) and sampling & 15 in (1, 2, 4) else 0x22
    want = j["sampling"] if p["planar"] == 1 else 0x11
    if sampling != want or not others_1x1:
        raise ValueError("%s: JPEG sampling factors %dx%d, libtiff expects "
                         "%dx%d and 1x1" % (name, sampling >> 4,
                                            sampling & 15, want >> 4,
                                            want & 15))
    return np.ascontiguousarray(img[:seg_h]).reshape(-1)


def _block(data, p, k, rows, last_strip, name, order):
    """The decoded bytes of strip or tile k: `rows` rows of the block's
    width (rows padded to a byte), or its YCbCr data units, predictor 2
    undone.  libtiff undoes it on YCbCr data units as on rows of
    3-sample pixels, each of 1 / v of a row of units: where that is
    not a whole number of pixels it fails, and the block raises."""
    off, cnt = p["offsets"][k], p["counts"][k]
    if off + cnt > len(data):  # TIFFFillStrip: "Read error on strip"
        raise ValueError("%s: strip or tile %d runs past the end of the "
                         "file" % (name, k))
    raw = data[off:off + cnt]
    comp, bw = p["compression"], p["bw"]
    if comp == JPEG:
        return _jpeg_block(raw, p, rows, bw, last_strip, name)
    if comp in _FAX:
        return codecs.tiff_fax(raw, off, comp, p["t4_options"],
                               p["fill_order"], bw, rows, name)
    if p["fill_order"] == 2:
        raw = _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
    if comp == THUNDERSCAN:
        return codecs.tiff_thunder(raw, bw, rows, name)
    if comp in (SGILOG, SGILOG24):
        return codecs.tiff_sgilog(raw, bw, rows, p["sgilog"], name)
    per_plane = p["spp"] if p["planar"] == 1 else 1
    if p["ycbcr"] is not None and p["planar"] == 1:
        hs, vs = p["ycbcr"][:2]
        units = -(-bw // hs) * (hs * vs + 2)
        size = -(-rows // vs) * units
        row = units // vs
    else:
        row = (bw * per_plane * p["bits"] + 7) // 8
        size = rows * row
    buf = _decompress(raw, size, comp, name)
    if p["predictor"] == 2:
        if row % per_plane or size % row:
            raise ValueError("%s: predictor 2 on YCbCr rows of %d bytes "
                             "(libtiff fails on them)" % (name, row))
        codecs.tiff_unpredict(buf, size // row, row // (p["bits"] // 8),
                              per_plane, p["bits"] // 8, order == ">")
    return buf


def decode_tiff(data, name="TIFF data"):
    """(H, W, 3) uint8 RGB of the first image of the TIFF file held in
    `data` (bytes), as `cv2.imread` returns it.  Raises ValueError naming
    `name` and the cause where cv2 returns None, and where libtiff hands
    cv2 back an image it did not decode."""
    tags, order = _ifd(data, name)
    p = _check(tags, name, len(data))
    W, H, bh, bw = p["W"], p["H"], p["bh"], p["bw"]
    spp, bits, planar = p["spp"], p["bits"], p["planar"]
    planes = spp if planar == 2 else 1
    per_plane = spp if planar == 1 else 1
    across = -(-W // bw)
    blocks = -(-H // bh) * across
    out = np.empty((H, W, 3), np.uint8)
    # libtiff's grey and palette put routines step over the clipped part
    # of a tile's row in pixels where they should in bytes
    skews = p["tiled"] and planar == 1 and p["photometric"] in (
        0, 1, 3) and (spp > 1 or bits == 16)
    flip_v, flip_h = _FLIPS[p["orientation"]]
    from_bottom = p["orientation"] in (3, 4, 7, 8)
    for b in range(blocks):
        y, x = (b // across) * bh, (b % across) * bw
        rows = min(bh, H - y) if not p["tiled"] else bh
        rys, rxs = min(bh, H - y), min(bw, W - x)
        last = not p["tiled"] and b == blocks - 1
        if p["ycbcr"] is not None:
            hs, vs, tables = p["ycbcr"]
            if planar == 1:
                buf = _block(data, p, b, rows, last, name, order)
            else:  # Y, Cb and Cr planes: units of one pixel
                buf = np.stack([_block(data, p, pl * blocks + b, rows, last,
                                       name, order)[:rows * bw]
                                for pl in range(3)], -1).reshape(-1)
            rgb = _ycbcr_rgb(buf, rys, rxs, bw, hs, vs, tables)
        else:
            samples = []
            for pl in range(planes):
                buf = _block(data, p, pl * blocks + b, rows, last, name,
                             order)
                samples.append(_unpack(buf, rows, bw, per_plane, bits,
                                       order))
            s = samples[0] if planes == 1 else np.concatenate(samples, -1)
            if skews and rxs < bw:
                s = _skewed(buf, rys, bw, rxs, spp, bits, order)
            rgb = _rgb(s[:rys, :rxs], p["photometric"], planar, bits,
                       p["alpha"], p["cmap"], p["white"])
        if not flip_v:
            rgb = rgb[::-1]
        if flip_h:
            rgb = rgb[:, ::-1]
        top = H - y - rys if from_bottom else y
        out[top:top + rys, x:x + rxs] = rgb
    if p["orientation"] >= 5:
        if H != W:
            raise ValueError("%s: TIFF orientation %d on a %dx%d image: cv2 "
                             "cannot turn it (imread returns None)"
                             % (name, p["orientation"], W, H))
        out = orient(out, _AFTER[p["orientation"]])
    return out
