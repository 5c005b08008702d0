"""Readers for the committed fixtures: the Flax-tree npz checkpoint,
8-bit RGB PNGs, and the certification probability maps; and an 8-bit
PNG writer (grayscale or RGB) for the training samples.

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


def read_png_rgb(path):
    """(H, W, 3) uint8 from an 8-bit RGB, non-interlaced PNG (colour
    type 2) — the format of the committed bench_img*.png files."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("%s is not a PNG file" % path)
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        raise ValueError("%s has no IHDR chunk" % path)
    W, H, depth, color, _, _, interlace = hdr
    if depth != 8 or color != 2 or interlace != 0:
        raise ValueError("only 8-bit RGB non-interlaced PNGs are supported "
                         "(got depth=%d color=%d interlace=%d)"
                         % (depth, color, interlace))
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = W * 3 + 1
    if raw.size != H * stride:
        raise ValueError("%s: decompressed size %d != %d"
                         % (path, raw.size, H * stride))
    raw = raw.reshape(H, stride)
    img = np.empty((H, W * 3), np.uint8)
    prev = np.zeros(W * 3, np.uint8)
    for i in range(H):
        prev = img[i] = _unfilter_row(int(raw[i, 0]), raw[i, 1:], prev, 3)
    return img.reshape(H, W, 3)


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
