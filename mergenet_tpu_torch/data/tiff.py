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
  C) // 255 for R, and alike for G and B.

Predictor 2 is undone under LZW and Deflate only (libtiff ignores the
tag under other compressions).  Each strip or tile is converted and
placed as cv2 places it under the
Orientation tag: libtiff flips the block to its bottom-up raster (top
and bottom orientations) and mirrors it (right orientations) inside the
block, and cv2 writes the raster bottom row first at the block's row,
counted from the bottom for orientations 3, 4, 7 and 8.  Orientations
1-4 of a striped file come out as the EXIF turns; a tiled file mirrors
each tile in place.  Orientations 5-8 then make cv2 transpose the image,
which only a square image survives: other shapes raise, as cv2 returns
None ("Internal imread issue").

What cv2 refuses raises ValueError naming the file and the cause: 2-bit
samples, 4-bit ones that are not palette indices, 10- to 64-bit and
floating-point samples, RGB below 8 bits, palette planes, separated data
that is not 8-bit CMYK, sub-byte interleaved samples with extra
channels.  Read but not yet by the port (ValueError "not yet read by
the port"): the compressions besides none (1), LZW (5), Deflate (8,
32946) and PackBits (32773) -- JPEG (6, 7), CCITT (2, 3, 4) and the
others libtiff has -- and the YCbCr, CIELab, ICCLab, ITULab and LogLuv
interpretations."""

import struct
import zlib

import numpy as np

from . import codecs
from .jpeg import orient

#: tag numbers
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, ORIENTATION, SPP, ROWS_PER_STRIP = 273, 274, 277, 278
STRIP_COUNTS, PLANAR, PREDICTOR, COLORMAP = 279, 284, 317, 320
TILE_WIDTH, TILE_HEIGHT, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
INKSET, EXTRA_SAMPLES, SAMPLE_FORMAT = 332, 338, 339

#: type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 4),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}
#: rationals count two values per entry
_PAIRS = (5, 10)

#: compressions the port reads
_COMPRESSIONS = (1, 5, 8, 32946, 32773)
#: libtiff's names of the ones it does not yet
_NOT_YET = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
            6: "old-style JPEG", 7: "JPEG", 32809: "ThunderScan",
            32766: "NeXT", 32771: "CCITT RLEW", 34676: "SGILog",
            34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD", 50001: "WebP",
            34712: "JPEG 2000", 34887: "LERC", 32908: "Pixar film",
            32909: "Pixar log", 32947: "DCS"}
#: photometric interpretations libtiff converts that the port does not yet
_PHOTOMETRIC_NOT_YET = {6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab",
                        32844: "LogL", 32845: "LogLuv"}

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
        size, _, first = struct.unpack(order + "HHQ", data[4:16])
        if size != 8:
            raise ValueError("%s: BigTIFF offset size %d" % (name, size))
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
        tags.setdefault(tag, struct.unpack(
            order + code * n_vals, data[at:at + nbytes]))
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


def _rgb(s, photometric, planar, bits, alpha, cmap, name):
    """(h, w, 3) uint8 of a block's samples (h, w, spp), as libtiff's put
    routines convert them."""
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


def _check(tags, name):
    """The reading parameters, or ValueError where cv2 (its header checks
    or libtiff's TIFFRGBAImageOK) refuses the file."""
    def one(tag, default=None):
        v = tags.get(tag)
        return default if not v else v[0]

    if WIDTH not in tags or HEIGHT not in tags or PHOTOMETRIC not in tags:
        raise ValueError("%s: TIFF without ImageWidth, ImageLength or "
                         "PhotometricInterpretation" % name)
    W, H, photometric = one(WIDTH), one(HEIGHT), one(PHOTOMETRIC)
    bits, spp = one(BITS, 1), one(SPP, 1)
    compression = one(COMPRESSION, 1)
    planar = one(PLANAR, 1)
    fmt = one(SAMPLE_FORMAT, 1)
    if W == 0 or H == 0:
        raise ValueError("%s: empty TIFF image" % name)
    if not 1 <= spp <= 4:
        raise ValueError("%s: cv2 reads 1 to 4 samples per pixel, not %d"
                         % (name, spp))
    if spp == 1:
        planar = 1  # one sample: both configurations lay it out alike
    if photometric in _PHOTOMETRIC_NOT_YET:
        raise ValueError("%s: TIFF photometric interpretation %s, not yet "
                         "read by the port" % (name,
                                               _PHOTOMETRIC_NOT_YET[
                                                   photometric]))
    if compression not in _COMPRESSIONS:
        raise ValueError("%s: TIFF compression %d (%s), not yet read by the "
                         "port" % (name, compression,
                                   _NOT_YET.get(compression, "unknown")))
    if bits == 4 and photometric != 3:
        raise ValueError("%s: cv2 reads 4-bit TIFF samples only as palette "
                         "indices" % name)
    if bits not in (1, 4, 8, 16):
        raise ValueError("%s: cv2 does not read %d-bit TIFF samples"
                         % (name, bits))
    if fmt not in (1, 2):
        raise ValueError("%s: cv2 does not read TIFF sample format %d at %d "
                         "bits" % (name, fmt, bits))
    extra = tags.get(EXTRA_SAMPLES, ())
    colors = spp - len(extra)
    alpha = 0
    if extra:
        alpha = extra[0] if extra[0] in (1, 2) else (1 if spp > 3 else 0)
    elif photometric == 2 and spp == 4:
        alpha = 1
    if photometric in (0, 1, 3) and planar == 1 and spp != 1 and bits < 8:
        raise ValueError("%s: libtiff does not convert interleaved %d-bit "
                         "samples with %d per pixel" % (name, bits, spp))
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
        if COLORMAP not in tags or len(tags[COLORMAP]) < 3 << bits:
            raise ValueError("%s: palette TIFF without its ColorMap" % name)
    elif photometric == 5:
        if one(INKSET, 1) != 1 or spp < 4 or bits != 8:
            raise ValueError("%s: libtiff converts separated images only as "
                             "8-bit CMYK" % name)
    elif photometric not in (0, 1):
        raise ValueError("%s: cv2 does not read TIFF photometric "
                         "interpretation %d" % (name, photometric))
    # libtiff knows the Predictor tag only under LZW and Deflate: under
    # other compressions it is an unknown field, ignored
    predictor = one(PREDICTOR, 1) if compression in (5, 8, 32946) else 1
    if predictor not in (1, 2) or (predictor == 2 and bits not in (8, 16)):
        raise ValueError("%s: predictor %d with %d-bit samples"
                         % (name, predictor, bits))
    tiled = TILE_WIDTH in tags
    if tiled:
        if TILE_HEIGHT not in tags or TILE_OFFSETS not in tags:
            raise ValueError("%s: tiled TIFF without TileLength or "
                             "TileOffsets" % name)
        bh, bw = one(TILE_HEIGHT), one(TILE_WIDTH)
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_COUNTS)
    else:
        if STRIP_OFFSETS not in tags:
            raise ValueError("%s: TIFF without StripOffsets" % name)
        bh, bw = min(one(ROWS_PER_STRIP, 0xFFFFFFFF), H), W
        offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_COUNTS)
    if bh == 0 or bw == 0:
        raise ValueError("%s: zero rows per strip or tile size" % name)
    blocks = -(-H // bh) * -(-W // bw)
    planes = spp if planar == 2 else 1
    if counts is None or len(offsets) < blocks * planes or \
            len(counts) < blocks * planes:
        raise ValueError("%s: %d strip or tile offsets and byte counts for "
                         "%d" % (name, min(len(offsets), len(counts or ())),
                                 blocks * planes))
    if photometric == 3:
        cm = np.asarray(tags[COLORMAP][:3 << bits], np.uint32).reshape(
            3, 1 << bits).T
        cmap = (cm >> 8 if cm.max() >= 256 else cm).astype(np.uint8)
    else:
        cmap = None
    orientation = one(ORIENTATION, 1)
    if orientation not in _FLIPS:
        orientation = 1
    return dict(W=W, H=H, photometric=photometric, bits=bits, spp=spp,
                planar=planar, compression=compression, alpha=alpha,
                predictor=predictor, tiled=tiled, bh=bh, bw=bw,
                offsets=offsets, counts=counts, cmap=cmap,
                orientation=orientation)


def decode_tiff(data, name="TIFF data"):
    """(H, W, 3) uint8 RGB of the first image of the TIFF file held in
    `data` (bytes), as `cv2.imread` returns it.  Raises ValueError naming
    `name` and the cause where cv2 returns None, and on what the port does
    not yet read."""
    tags, order = _ifd(data, name)
    p = _check(tags, name)
    W, H, bh, bw = p["W"], p["H"], p["bh"], p["bw"]
    spp, bits, planar = p["spp"], p["bits"], p["planar"]
    planes = spp if planar == 2 else 1
    per_plane = spp if planar == 1 else 1
    row_bytes = (bw * per_plane * bits + 7) // 8
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
        samples = []
        for pl in range(planes):
            k = pl * blocks + b
            off, cnt = p["offsets"][k], p["counts"][k]
            raw = data[off:off + cnt]
            buf = _decompress(raw, rows * row_bytes, p["compression"], name)
            if p["predictor"] == 2:
                codecs.tiff_unpredict(buf, rows, bw * per_plane, per_plane,
                                      bits // 8, order == ">")
            samples.append(_unpack(buf, rows, bw, per_plane, bits, order))
        s = samples[0] if planes == 1 else np.concatenate(samples, -1)
        rys, rxs = min(bh, H - y), min(bw, W - x)
        if skews and rxs < bw:
            s = _skewed(buf, rys, bw, rxs, spp, bits, order)
        rgb = _rgb(s[:rys, :rxs], p["photometric"], planar, bits,
                   p["alpha"], p["cmap"], name)
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
