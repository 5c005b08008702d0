"""GIF reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads a GIF with OpenCV 5.0's own
decoder (grfmt_gif.cpp), which returns the first frame:

- GIF87a and GIF89a; the logical screen is the image's size, filled
  with the global colour table's background entry (black without a
  global table);
- the first image descriptor's pixels (LZW as `codecs.gif_lzw` decodes
  it, rows in the interlaced order when flagged) are looked up in its
  local colour table, else the global one (else a table of 0 black, 1
  white and every other index its own grey; entries past a table are
  black), and drawn at its place on the screen, which it must not
  leave; the transparent index of a graphic control extension before
  it leaves the background showing;
- extensions are skipped; later frames are not read.

What cv2 refuses raises ValueError naming the file and the cause."""

import struct

import numpy as np

from . import codecs

SIGNATURES = (b"GIF87a", b"GIF89a")

#: cv2's table for an image without a global or local one: 0 black, 1
#: white, every other index its own grey
_DEFAULT_TABLE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
_DEFAULT_TABLE[:2] = ((0, 0, 0), (255, 255, 255))


def _table(data, pos, flags, name):
    """(colour table (n, 3) uint8 or None, position after it)."""
    if not flags & 0x80:
        return None, pos
    n = 3 << ((flags & 7) + 1)
    if pos + n > len(data):
        raise ValueError("%s: GIF colour table past the end of the file"
                         % name)
    return np.frombuffer(data, np.uint8, n, pos).reshape(-1, 3), pos + n


def _sub_blocks(data, pos, name):
    """(joined sub-block bytes, position after the terminator)."""
    parts = []
    while True:
        if pos >= len(data):
            raise ValueError("%s: GIF data ends inside a block" % name)
        n = data[pos]
        if n == 0:
            return b"".join(parts), pos + 1
        parts.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _interlaced_rows(h):
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                           np.arange(2, h, 4), np.arange(1, h, 2)])


def decode_gif(data, name="GIF data"):
    """(H, W, 3) uint8 RGB of the first frame of the GIF file held in
    `data`."""
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise ValueError("%s: not a GIF file" % name)
    W, H, flags, bg, _ = struct.unpack("<HHBBB", data[6:13])
    if W == 0 or H == 0:
        raise ValueError("%s: GIF screen %dx%d" % (name, W, H))
    gtab, pos = _table(data, 13, flags, name)
    canvas = np.zeros((H, W, 3), np.uint8)
    if gtab is not None:
        canvas[:] = gtab[bg] if bg < len(gtab) else 0
    transparent = None
    while True:
        if pos >= len(data):
            raise ValueError("%s: GIF without an image" % name)
        kind = data[pos]
        if kind == 0x3B:
            raise ValueError("%s: GIF without an image" % name)
        if kind == 0x21:
            if pos + 2 > len(data):
                raise ValueError("%s: truncated GIF extension" % name)
            label = data[pos + 1]
            body, pos = _sub_blocks(data, pos + 2, name)
            if label == 0xF9 and len(body) >= 4:
                transparent = body[3] if body[0] & 1 else None
            continue
        if kind != 0x2C:
            raise ValueError("%s: unknown GIF block 0x%02x" % (name, kind))
        if pos + 10 > len(data):
            raise ValueError("%s: truncated GIF image descriptor" % name)
        left, top, w, h, iflags = struct.unpack("<HHHHB",
                                                data[pos + 1:pos + 10])
        table, pos = _table(data, pos + 10, iflags, name)
        table = gtab if table is None else table
        if table is None:
            table = _DEFAULT_TABLE
        if pos >= len(data):
            raise ValueError("%s: GIF image data missing" % name)
        min_bits = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1, name)
        if left + w > W or top + h > H:
            raise ValueError("%s: GIF frame %dx%d at (%d, %d) outside the "
                             "%dx%d screen" % (name, w, h, left, top, W, H))
        idx, n = codecs.gif_lzw(lzw, min_bits, w * h, name)
        if n < w * h:
            raise ValueError("%s: GIF image data ends after %d of %d pixels"
                             % (name, n, w * h))
        idx = idx.reshape(h, w)
        if iflags & 0x40:
            rows = np.empty_like(idx)
            rows[_interlaced_rows(h)] = idx
            idx = rows
        full = np.zeros((256, 3), np.uint8)
        full[:len(table)] = table
        frame = canvas[top:top + h, left:left + w]
        draw = np.ones((h, w), bool) if transparent is None else \
            idx != transparent
        frame[draw] = full[idx[draw]]
        return canvas
