"""Readers for the committed fixtures: the Flax-tree npz checkpoint,
PNGs (every colour type and bit depth, non-interlaced or Adam7, read as
cv2 reads them, eXIf orientation applied, and grayscale unchanged, as
Cityscapes' instance-id maps are stored), and the certification
probability maps; and a PNG writer (8-bit grayscale or RGB, 16-bit
grayscale) for the training samples, the synthetic dataset and
instance-id maps.

Standard library and numpy only: the GPU machine has no cv2 or PIL."""

import os
import struct
import zlib

import numpy as np

#: npz key separator of the exported checkpoint tree
_SEP = "|"


def _unflatten_tree(npz, prefix):
    """Nested dict of arrays from the `prefix|a|b|leaf` npz keys."""
    tree = {}
    for key in npz.files:
        if not key.startswith(prefix + _SEP):
            continue
        parts = key[len(prefix) + 1:].split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return tree


def load_bench_checkpoint(path):
    """(params, batch_stats) Flax trees of numpy arrays from a
    bench_ckpt.npz (keys `p|...` and `b|...`)."""
    with np.load(path) as npz:
        return _unflatten_tree(npz, "p"), _unflatten_tree(npz, "b")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter_row(ftype, row, prev, bpp):
    """Undo one scanline's PNG filter (types 0-4); row/prev uint8."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: running sum mod 256 per channel
        r = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(r, axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return ((row.astype(np.int64) + prev) % 256).astype(np.uint8)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    n = len(out)
    if ftype == 3:  # Average
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 255
    elif ftype == 4:  # Paeth
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            ul = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, up[i], ul)) & 255
    else:
        raise ValueError("bad PNG filter type %d" % ftype)
    return np.frombuffer(bytes(out), np.uint8)


#: samples per pixel of each PNG colour type
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

#: Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter_image(raw, H, W, ch, depth):
    """Samples (H, W, ch) of one image's filtered scanlines `raw` (a
    whole non-interlaced image or one Adam7 pass): 8- and 16-bit
    samples as uint8 and big-endian uint16, 1-, 2- and 4-bit ones
    unpacked to uint8 (unscaled)."""
    row_bytes = (W * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    raw = raw.reshape(H, row_bytes + 1)
    rows = np.empty((H, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for i in range(H):
        prev = rows[i] = _unfilter_row(int(raw[i, 0]), raw[i, 1:], prev, bpp)
    if depth == 16:  # big-endian samples
        samples = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = rows
    else:
        bits = np.unpackbits(rows, axis=1).reshape(H, -1, depth)[:, :W]
        samples = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(
            -1).astype(np.uint8)
    return samples.reshape(H, W, ch)


def exif_orientation(t):
    """The EXIF orientation (1-8, 0 for none) of a TIFF-structured Exif
    block `t` (bytes), as OpenCV's ExifReader finds it: byte order II or
    MM and 42, then IFD0's entries one by one until the count or the
    data ends (an entry needs its tag inside the data, an Orientation
    entry its value too), the first 0x0112 entry's 16-bit value.
    (`data/native/jpeg.cc` walks a JPEG's Exif APP1 alike.)"""
    if len(t) < 8 or t[:2] not in (b"II", b"MM"):
        return 0
    e = "<" if t[:2] == b"II" else ">"
    if struct.unpack(e + "H", t[2:4])[0] != 42:
        return 0
    (ifd,) = struct.unpack(e + "I", t[4:8])
    if ifd + 2 > len(t):
        return 0
    for i in range(struct.unpack(e + "H", t[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        if at + 2 > len(t):
            break
        if t[at:at + 2] == struct.pack(e + "H", 0x0112):
            if at + 10 > len(t):
                break
            found = struct.unpack(e + "H", t[at + 8:at + 10])[0]
            return found if 1 <= found <= 8 else 0
    return 0


def _read_png(path):
    """(samples (H, W, ch), colour type, bit depth, PLTE, eXIf
    orientation) of a PNG:
    8- and 16-bit samples as uint8 and big-endian uint16, 1-, 2- and
    4-bit ones unpacked to uint8 (unscaled).  An Adam7-interlaced file's
    seven passes are unfiltered each on its own (empty passes have no
    scanlines) and their pixels put back in place.  Unknown types and
    interlace methods raise ValueError naming the file, as does image
    data shorter than its scanlines.  The orientation is that of the
    first eXIf chunk libpng keeps (before or after IDAT: at least 4
    bytes starting `II*\\0` or `MM\\0*`, with a good CRC; later ones
    are duplicates), 0 without one."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("%s is not a PNG file" % path)
    pos, idat, hdr, plte, exif = 8, [], None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf" and exif is None and body[:4] in (
                b"II*\0", b"MM\0*") and data[pos + 8 + length:
                                           pos + 12 + length] == struct.pack(
                    ">I", zlib.crc32(ctype + body) & 0xFFFFFFFF):
            exif = exif_orientation(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError("%s has no IHDR chunk" % path)
    W, H, depth, color, _, _, interlace = hdr
    if interlace not in (0, 1):
        raise ValueError("%s: unknown PNG interlace method %d"
                         % (path, interlace))
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or (
            depth < 8 and color not in (0, 3)) or (depth == 16
                                                    and color == 3):
        raise ValueError("%s: unsupported PNG colour type %d at bit depth %d"
                         % (path, color, depth))
    if color == 3 and plte is None:
        raise ValueError("%s: palette PNG without a PLTE chunk" % path)
    ch = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = [(x0, y0, dx, dy, -(-(W - x0) // dx), -(-(H - y0) // dy))
              for x0, y0, dx, dy in _ADAM7] if interlace else [
                  (0, 0, 1, 1, W, H)]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    sizes = [ph * ((pw * ch * depth + 7) // 8 + 1)
             for _, _, _, _, pw, ph in passes]
    if raw.size < sum(sizes):
        raise ValueError("%s: decompressed size %d < %d%s"
                         % (path, raw.size, sum(sizes),
                            " (Adam7-interlaced)" if interlace else ""))
    samples = np.empty((H, W, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for (x0, y0, dx, dy, pw, ph), n in zip(passes, sizes):
        samples[y0::dy, x0::dx] = _unfilter_image(raw[at:at + n], ph, pw, ch,
                                                  depth)
        at += n
    return samples, color, depth, plte, exif or 0


def read_png_rgb(path):
    """(H, W, 3) uint8 RGB of a PNG, non-interlaced or Adam7, as
    `cv2.imread` (then BGR -> RGB) gives it: RGB as stored; grey
    replicated to three channels (1, 2 and 4-bit grey scaled to 0-255);
    palette indices looked up in PLTE; alpha dropped; 16-bit samples
    keep their high byte; turned by the eXIf chunk's orientation as cv2
    turns it (`data.jpeg.orient`).  Unknown types raise ValueError
    naming them."""
    from .data.jpeg import orient
    samples, color, depth, plte, orientation = _read_png(path)
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    elif depth < 8 and color == 0:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if color == 3:
        idx = samples[..., 0]
        if int(idx.max(initial=0)) >= len(plte):
            raise ValueError("%s: palette index past PLTE" % path)
        rgb = plte[idx]
    elif samples.shape[2] <= 2:  # grey (+ alpha)
        rgb = np.repeat(samples[..., :1], 3, axis=2)
    else:
        rgb = samples[..., :3]
    return orient(rgb, orientation)


def read_png_gray(path):
    """(H, W) array of a grayscale PNG (colour type 0, non-interlaced or
    Adam7), as `cv2.imread(path, cv2.IMREAD_UNCHANGED)` gives it: uint16
    with the full big-endian value at 16 bits (a Cityscapes
    `*_instanceIds.png`), uint8 at 8 bits, and 1, 2 and 4-bit samples
    scaled to 0-255 as libpng expands them.  Other colour types (which
    cv2 reads with 3 or 4 channels) raise ValueError naming them.  An
    eXIf orientation is not applied: IMREAD_UNCHANGED ignores it."""
    samples, color, depth, _, _ = _read_png(path)
    if color != 0:
        raise ValueError("%s: read_png_gray reads grayscale PNGs only, got "
                         "colour type %d at bit depth %d"
                         % (path, color, depth))
    if depth < 8:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    return np.ascontiguousarray(samples[..., 0])


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path, img):
    """Write an (H, W) grayscale or (H, W, 3) RGB image as a
    non-interlaced PNG (every scanline unfiltered): 16-bit grayscale for
    a 2-D uint16 array, 8-bit (the values cast to uint8) otherwise."""
    img = np.asarray(img)
    depth = 16 if img.ndim == 2 and img.dtype == np.uint16 else 8
    img = np.ascontiguousarray(img, dtype=">u2" if depth == 16 else np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError("write_png takes (H, W) or (H, W, 3), got %s"
                         % (img.shape,))
    H, W = img.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           img.reshape(H, -1).view(np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth,
                                              color, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


def load_offsets(fixture_dir):
    """The fixture's offset tuple ((di, dj), ...) from offsets.npy."""
    return tuple(tuple(int(x) for x in o)
                 for o in np.load(os.path.join(fixture_dir, "offsets.npy")))


def load_probs(fixture_dir, index):
    """(cp (H, W, C), sp (H, W, O)) float32 probability maps of
    `probs_<index>.npz`."""
    with np.load(os.path.join(fixture_dir, "probs_%d.npz" % index)) as d:
        return d["cp"].astype(np.float32), d["sp"].astype(np.float32)
