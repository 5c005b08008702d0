"""Readers for the committed fixtures: the Flax-tree npz checkpoint,
PNGs (every non-interlaced colour type, read as cv2 reads them), and
the certification probability maps; and an 8-bit PNG writer (grayscale
or RGB) for the training samples and the synthetic dataset.

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


def read_png_rgb(path):
    """(H, W, 3) uint8 RGB of a non-interlaced PNG, as `cv2.imread` (then
    BGR -> RGB) gives it: RGB as stored; grey replicated to three
    channels (1, 2 and 4-bit grey scaled to 0-255); palette indices
    looked up in PLTE; alpha dropped; 16-bit samples keep their high
    byte.  Interlaced files and unknown types raise ValueError naming
    them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("%s is not a PNG file" % path)
    pos, idat, hdr, plte = 8, [], None, None
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
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError("%s has no IHDR chunk" % path)
    W, H, depth, color, _, _, interlace = hdr
    if interlace != 0:
        raise ValueError("%s: interlaced (Adam7) PNGs are not supported"
                         % path)
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or (
            depth < 8 and color not in (0, 3)) or (depth == 16
                                                    and color == 3):
        raise ValueError("%s: unsupported PNG colour type %d at bit depth %d"
                         % (path, color, depth))
    if color == 3 and plte is None:
        raise ValueError("%s: palette PNG without a PLTE chunk" % path)
    ch = _PNG_CHANNELS[color]
    row_bytes = (W * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = row_bytes + 1
    if raw.size < H * stride:
        raise ValueError("%s: decompressed size %d < %d"
                         % (path, raw.size, H * stride))
    raw = raw[:H * stride].reshape(H, stride)
    rows = np.empty((H, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for i in range(H):
        prev = rows[i] = _unfilter_row(int(raw[i, 0]), raw[i, 1:], prev, bpp)
    if depth == 16:  # big-endian samples: keep the high byte
        samples = rows.reshape(H, W * ch, 2)[..., 0]
    elif depth == 8:
        samples = rows
    else:
        bits = np.unpackbits(rows, axis=1).reshape(H, -1, depth)[:, :W]
        samples = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(
            -1).astype(np.uint8)
        if color == 0:
            samples = samples * np.uint8(255 // ((1 << depth) - 1))
    samples = samples.reshape(H, W, ch)
    if color == 3:
        idx = samples[..., 0]
        if int(idx.max(initial=0)) >= len(plte):
            raise ValueError("%s: palette index past PLTE" % path)
        return plte[idx]
    if ch <= 2:  # grey (+ alpha)
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path, img):
    """Write an (H, W) grayscale or (H, W, 3) RGB uint8 image as an 8-bit
    non-interlaced PNG (every scanline unfiltered)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color = 2
    else:
        raise ValueError("write_png takes (H, W) or (H, W, 3), got %s"
                         % (img.shape,))
    H, W = img.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8),
                           img.reshape(H, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color,
                                              0, 0, 0))
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
