"""Sun raster reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads a Sun raster with OpenCV
5.0 (grfmt_sunras.cpp):

- the 32-byte big-endian header (magic 59 a6 6a 95, width, height,
  depth, length, type, map type, map length); depths 1, 8, 24 and 32;
- types 0 (old) and 1 (standard) only: cv2's header check compares its
  own image type, not the file's, with the byte-encoded (2) and RGB (3)
  types, so it refuses both, and the port does too;
- no colour map (map type 0, length 0), or an RGB one (map type 1) of
  at most 2^depth entries at depth 1 or 8, stored as a red, a green and
  a blue plane of length / 3 entries each; the entries past it black;
  without a map, 1-bit pixels are 0 black and 1 white, 8-bit ones grey;
- rows padded to 16 bits; 24-bit pixels BGR, 32-bit ones XBGR.

What cv2 refuses raises ValueError naming the file and the cause."""

import struct

import numpy as np

MAGIC = b"\x59\xa6\x6a\x95"


def decode_sunras(data, name="Sun raster data"):
    """(H, W, 3) uint8 RGB of the Sun raster file held in `data`."""
    if len(data) < 32 or data[:4] != MAGIC:
        raise ValueError("%s: not a Sun raster file" % name)
    _, W, H, depth, _, kind, maptype, maplen = struct.unpack(">8I",
                                                             data[:32])
    pal_size = (1 << depth) * 3 if 0 < depth <= 8 else 0
    if not (W > 0 and H > 0 and depth in (1, 8, 24, 32)):
        raise ValueError("%s: Sun raster %dx%d at depth %d"
                         % (name, W, H, depth))
    if kind not in (0, 1):
        raise ValueError("%s: Sun raster type %d: cv2 reads types 0 and 1 "
                         "only" % (name, kind))
    if not ((maptype == 0 and maplen == 0) or (
            maptype == 1 and 0 < maplen <= pal_size and depth <= 8)):
        raise ValueError("%s: Sun raster colour map type %d of %d bytes"
                         % (name, maptype, maplen))
    if 32 + maplen > len(data):
        raise ValueError("%s: Sun raster colour map past the end of the "
                         "file" % name)
    pal = np.zeros((256, 3), np.uint8)
    if maplen:
        n = maplen // 3
        planes = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        pal[:n] = planes.T
    elif depth <= 8:
        levels = 1 << depth
        pal[:levels] = (np.arange(levels) * 255 // (levels - 1))[:, None]
    pitch = ((W * depth + 7) // 8 + 1) & ~1
    at = 32 + maplen
    if at + H * pitch > len(data):
        raise ValueError("%s: Sun raster data ends early (%d of %d bytes)"
                         % (name, len(data) - at, H * pitch))
    rows = np.frombuffer(data, np.uint8, H * pitch, at).reshape(H, pitch)
    if depth == 1:
        return pal[np.unpackbits(rows, axis=1)[:, :W]]
    if depth == 8:
        return pal[rows[:, :W]]
    px = rows[:, :W * depth // 8].reshape(H, W, depth // 8)
    return np.ascontiguousarray(px[..., :-4:-1] if depth == 24
                                else px[..., 3:0:-1])
