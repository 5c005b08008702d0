"""BMP reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads a BMP with OpenCV 5.0's own
decoder (grfmt_bmp.cpp):

- headers: core (12 bytes: 16-bit unsigned width and height, 3-byte
  palette entries), and every header of 36 bytes or more (info 40, OS/2
  2.x 64, V2-V5 up to 124: 4-byte palette entries, a negative height for
  top-down rows); other sizes are refused;
- 1-, 4- and 8-bit palette images (BI_RGB; RLE8 at 8 bits, RLE4 at 4),
  with the palette read right after the header, `biClrUsed` entries (2^bpp
  when 0), the entries past it black;
- 16 bits: BI_RGB is 5-5-5; BI_BITFIELDS reads three masks from the 12
  bytes after the header, whatever the header's size (inside a V4/V5
  header they are not), and takes only 5-5-5 and 5-6-5; channels are
  widened by shifting (r = (t >> 7) & 0xF8 at 5-5-5);
- 24 bits BGR; 32 bits BGRX, but for BI_BITFIELDS with a header of 108
  bytes or more and three non-zero colour masks, each channel then being
  ((v & m) >> shift) * 255 // (m >> shift);
- RLE as `codecs.bmp_rle` decodes it (the pixels that end-of-line, delta
  and end-of-bitmap pass are palette entry 0).

Pixel data starts at `bfOffBits`; rows are padded to 4 bytes.  What cv2
refuses (zero sizes, other depth/compression pairs, other 16-bit masks,
data that ends early, RLE runs past their row) raises ValueError naming
the file and the cause."""

import struct

import numpy as np

from . import codecs


def _palette(data, at, count, entry, name):
    """(256, 3) uint8 RGB: `count` entries of `entry` bytes (BGR first)
    from `at`, the rest black."""
    if at + count * entry > len(data):
        raise ValueError("%s: BMP palette runs past the end of the file"
                         % name)
    pal = np.zeros((256, 3), np.uint8)
    raw = np.frombuffer(data, np.uint8, count * entry, at).reshape(
        count, entry)
    pal[:count] = raw[:, 2::-1]
    return pal


def _rows(data, offset, height, pitch, name):
    if offset + height * pitch > len(data):
        raise ValueError("%s: BMP pixel data ends early (%d of %d bytes)"
                         % (name, max(0, len(data) - offset),
                            height * pitch))
    return np.frombuffer(data, np.uint8, height * pitch, offset).reshape(
        height, pitch)


def _unpack(rows, width, bpp):
    bits = np.unpackbits(rows, axis=1)[:, :width * bpp].reshape(
        rows.shape[0], width, bpp)
    return (bits * (1 << np.arange(bpp - 1, -1, -1, dtype=np.uint8))).sum(
        -1, dtype=np.uint8)


def decode_bmp(data, name="BMP data"):
    """(H, W, 3) uint8 RGB of the BMP file held in `data` (bytes), as
    `cv2.imread` returns it.  Raises ValueError naming `name` and the
    cause where cv2 returns None."""
    if len(data) < 18 or data[:2] != b"BM":
        raise ValueError("%s: not a BMP file" % name)
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    masks = None
    if size >= 36:
        if len(data) < 14 + 36:
            raise ValueError("%s: truncated BMP header" % name)
        width, height, _, bpp, comp = struct.unpack("<iiHHI", data[18:34])
        (clrused,) = struct.unpack("<I", data[46:50])
        after = 14 + size
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and comp == 0)
            or (bpp in (16, 32) and comp in (0, 3))
            or (bpp == 4 and comp == 2) or (bpp == 8 and comp == 1))
        if not ok:
            raise ValueError("%s: cv2 does not read BMPs of %d bits with "
                             "compression %d (or size %dx%d)"
                             % (name, bpp, comp, width, height))
        pal = None
        if bpp <= 8:
            if clrused > 256:
                raise ValueError("%s: %d palette entries" % (name, clrused))
            pal = _palette(data, after, clrused or 1 << bpp, 4, name)
        elif bpp == 16:
            if comp == 3:
                if after + 12 > len(data):
                    raise ValueError("%s: truncated BMP masks" % name)
                r, g, b = struct.unpack("<III", data[after:after + 12])
                if (r, g, b) == (0x7C00, 0x3E0, 0x1F):
                    bpp = 15
                elif (r, g, b) != (0xF800, 0x7E0, 0x1F):
                    raise ValueError("%s: cv2 reads 16-bit BMP bitfields "
                                     "only as 5-5-5 or 5-6-5" % name)
            else:
                bpp = 15
        elif bpp == 32 and comp == 3 and size >= 108:
            m = struct.unpack("<III", data[54:66])
            if all(m):
                masks = m
    elif size == 12:
        if len(data) < 26:
            raise ValueError("%s: truncated BMP header" % name)
        width, height, _, bpp = struct.unpack("<HHHH", data[18:26])
        comp = 0
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            raise ValueError("%s: cv2 does not read core BMPs of %d bits "
                             "(or size %dx%d)" % (name, bpp, width, height))
        pal = _palette(data, 26, 1 << bpp, 3, name) if bpp <= 8 else None
    else:
        raise ValueError("%s: BMP header of %d bytes" % (name, size))
    top_down = height < 0
    height = abs(height)

    if comp in (1, 2):
        idx = codecs.bmp_rle(data[offset:], bpp, width, height, name)
        rgb = pal[idx]
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 31) // 32) * 4
        rows = _rows(data, offset, height, pitch, name)
        if bpp <= 8:
            rgb = pal[rows[:, :width] if bpp == 8 else _unpack(rows, width,
                                                               bpp)]
        elif bpp in (15, 16):
            t = rows[:, :width * 2].view("<u2").astype(np.uint32)
            b = (t << 3) & 0xF8
            if bpp == 15:
                g, r = (t >> 2) & 0xF8, (t >> 7) & 0xF8
            else:
                g, r = (t >> 3) & 0xFC, (t >> 8) & 0xF8
            rgb = np.stack([r, g, b], -1).astype(np.uint8)
        elif bpp == 24:
            rgb = rows[:, :width * 3].reshape(height, width, 3)[..., ::-1]
        elif masks is None:
            rgb = rows[:, :width * 4].reshape(height, width, 4)[..., 2::-1]
        else:
            v = rows[:, :width * 4].view("<u4").astype(np.uint64)
            chans = []
            for m in masks:
                shift = (m & -m).bit_length() - 1
                top = m >> shift
                chans.append(((v & m) >> shift) * 255 // top)
            rgb = np.stack(chans, -1).astype(np.uint8)
    if not top_down:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)
