"""Writers for the raster containers `cv2.imread` reads besides PNG and
JPEG: TIFF, BMP, PBM/PGM/PPM, PAM, PFM, Sun raster, Radiance HDR and
GIF, each with the layouts the tests hold the port's readers
(`mergenet_tpu_torch/data/{tiff,bmp,pxm,sunras,hdr,gif}.py`) to cv2
with, cv2's own writers among them or not: TIFF strips and tiles,
planar configurations, 1- to 16-bit samples, every photometric
interpretation, LZW (new and old style), Deflate and PackBits with the
horizontal predictor, II, MM and BigTIFF; BMP core, info, OS/2 and
V4/V5 headers, RLE8/RLE4 with deltas, bitfields, top-down rows; PxM
comments and odd maxvals; Sun raster's types and colour maps; HDR's
run-length encodings; GIF's local tables, interlace and transparency.

Numpy and the standard library only: `chip_smoke.py` writes its
"containers" split with `write_layout` on the GPU machine, which has no
cv2.  The port itself writes none of these formats, as the JAX package
writes none."""

import struct
import zlib

import numpy as np


# ------------------------------------------------------------ entropy coders

class _BitsMSB:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, width):
        self.acc = (self.acc << width) | code
        self.n += width
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 255)
        self.acc &= (1 << self.n) - 1

    def done(self):
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 255)
        return bytes(self.out)


class _BitsLSB:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, width):
        self.acc |= code << self.n
        self.n += width
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def done(self):
        if self.n:
            self.out.append(self.acc & 255)
        return bytes(self.out)


def _lzw(symbols, min_bits, bits, early, clear_every=None):
    """LZW codes of `symbols` (a sequence of ints below 2**min_bits):
    a clear code first, the code width growing from min_bits + 1 to 12
    once the decoder's next free code reaches 2**width (2**width - 1
    when `early`, as TIFF's new-style LZW has it), a clear code whenever
    the table fills (or after `clear_every` codes), the end code last.
    The encoder's table runs one entry ahead of the decoder's."""
    clear = 1 << min_bits
    first = clear + 2
    width, free, table = min_bits + 1, first, {}
    limit = (1 << 12) - (2 if early else 1)
    bits.put(clear, width)
    symbols = list(symbols)
    if not symbols:
        bits.put(clear + 1, width)
        return bits.done()
    prefix, emitted = symbols[0], 0
    for s in symbols[1:]:
        key = (prefix << 8) | s if min_bits <= 8 else (prefix, s)
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        bits.put(prefix, width)
        emitted += 1
        table[key] = free
        free += 1
        if free >= limit or (clear_every and emitted % clear_every == 0):
            bits.put(clear, width)
            width, free, table = min_bits + 1, first, {}
        elif free > (1 << width) - early and width < 12:
            width += 1
        prefix = s
    bits.put(prefix, width)
    free += 1
    if free > (1 << width) - early and width < 12:
        width += 1
    bits.put(clear + 1, width)
    return bits.done()


def lzw_tiff(data, old_style=False):
    """TIFF LZW (compression 5) of `data`: new style, MSB-first codes with
    the early width change; `old_style`, the LSB-first codes of TIFF 5.0
    without it, which libtiff still reads."""
    data = bytes(data)
    if old_style:
        return _lzw(data, 8, _BitsLSB(), early=False)
    return _lzw(data, 8, _BitsMSB(), early=True)


def lzw_gif(indices, min_bits, clear_every=None):
    """GIF image data: the LZW minimum code size, then the LSB-first
    codes in sub-blocks of at most 255 bytes, then a zero block."""
    data = _lzw(np.asarray(indices, np.int64).ravel().tolist(), min_bits,
                _BitsLSB(), early=False, clear_every=clear_every)
    return bytes([min_bits]) + sub_blocks(data)


def sub_blocks(data):
    out = bytearray()
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    return bytes(out + b"\x00")


def _runs(row):
    """(start, length) of the runs of equal bytes of a uint8 row."""
    row = np.asarray(row, np.uint8)
    if row.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    edge = np.flatnonzero(row[1:] != row[:-1]) + 1
    start = np.concatenate([[0], edge])
    return start, np.diff(np.concatenate([start, [row.size]]))


def packbits(row):
    """PackBits of one row: runs of 3 and more as -(n - 1), literals of up
    to 128 bytes as n - 1."""
    row = bytes(row)
    out, lit = bytearray(), bytearray()

    def flush():
        for i in range(0, len(lit), 128):
            part = lit[i:i + 128]
            out.append(len(part) - 1)
            out.extend(part)
        lit.clear()

    start, length = _runs(np.frombuffer(row, np.uint8))
    for s, n in zip(start.tolist(), length.tolist()):
        if n < 3:
            lit.extend(row[s:s + n])
            continue
        flush()
        while n > 0:
            k = min(n, 128)
            if k < 3:
                lit.extend(row[s:s + k])
            else:
                out.append(257 - k)
                out.append(row[s])
            n -= k
    flush()
    return bytes(out)


# --------------------------------------------------------------------- TIFF

_TYPE_FMT = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 7: "B", 11: "f", 12: "d",
             16: "Q"}


#: each byte with its bits in reverse order (FillOrder 2)
_REVERSED = np.array([int("{:08b}".format(i)[::-1], 2) for i in range(256)],
                     np.uint8)


def _pack_rows(samples, bits, order):
    """Bytes of rows of samples (h, w, spp), each row padded to a byte:
    MSB-first below 8 bits, `order`-endian at 16 and 32."""
    h = samples.shape[0]
    if samples.dtype.kind == "f":
        return samples.astype(order + "f%d" % (bits // 8)).reshape(
            h, -1).view(np.uint8)
    if bits >= 8:
        return samples.astype(order + "u%d" % (bits // 8)).reshape(
            h, -1).view(np.uint8)
    flat = samples.reshape(h, -1).astype(np.uint8)
    b = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(h, -1)
    return np.packbits(b, axis=1)


def _pack_units(samples, hs, vs):
    """Bytes of (h, w, 3) uint8 YCbCr samples in TIFF's subsampled data
    units, left to right and top to bottom."""
    h, w = samples.shape[:2]
    uh, uw = -(-h // vs), -(-w // hs)
    rows = np.minimum(np.arange(uh * vs), h - 1)
    cols = np.minimum(np.arange(uw * hs), w - 1)
    full = samples[rows][:, cols]
    y = full[..., 0].reshape(uh, vs, uw, hs).transpose(0, 2, 1, 3).reshape(
        uh, uw, vs * hs)
    c = samples[::vs, ::hs, 1:]
    return np.concatenate([y, c], -1).astype(np.uint8).tobytes()


def _predict(samples, bits):
    """Horizontal differencing (predictor 2) of (h, w, spp) samples."""
    s = samples.astype(np.int64)
    d = s.copy()
    d[:, 1:] -= s[:, :-1]
    return (d % (1 << bits)).astype(samples.dtype)


def _compress(raw, rows, compression):
    if compression == 1:
        return raw
    if compression == 5:
        return lzw_tiff(raw)
    if compression == 6005:  # LZW old style (written as 5)
        return lzw_tiff(raw, old_style=True)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        n = len(raw) // rows
        return b"".join(packbits(raw[i * n:(i + 1) * n])
                        for i in range(rows))
    raise ValueError(compression)


def tiff_bytes(samples, *, bits=8, photometric=None, planar=1,
               compression=1, predictor=1, rows_per_strip=None, tile=None,
               big_endian=False, bigtiff=False, orientation=None,
               extra_samples=None, colormap=None, sample_format=None,
               pages=1, extra_tags=(), fill_order=1, blocks=None,
               subsampling=None):
    """A TIFF file of `samples` (H, W, samples per pixel; ints below
    2**bits, or floats with sample_format 3): strips of
    `rows_per_strip` rows (the whole image by default) or tiles of
    `tile` (th, tw) (multiples of 16; edge tiles padded with zeros);
    planar 1 (interleaved) or 2 (a strip or tile per sample); the
    compression code (1, 5, 8, 32946, 32773; 6005 writes old-style LZW
    under code 5) and predictor 2 applied before it; `pages` copies of
    the IFD, each of the image turned upside down (the first is the
    image).  extra_tags: (tag, type, values) added to each IFD.
    fill_order 2 writes FillOrder 2 and reverses the bits of every byte
    of each strip or tile.  `blocks`, when given, are the strips or
    tiles as they go in the file (a codec's own output), in place of
    those of `samples`, which then gives only the image's size and
    samples per pixel.  `subsampling` (h, v) packs 8-bit YCbCr samples
    into TIFF's data units (h * v Y samples, then Cb and Cr: those of
    the unit's top-left pixel; Y past the image's edge repeats its
    last row and column) and writes the YCbCrSubsampling tag."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    H, W, spp = samples.shape
    if photometric is None:
        photometric = 2 if spp >= 3 else 1
    order = ">" if big_endian else "<"
    off_t = 16 if bigtiff else 4
    out = bytearray(b"MM" if big_endian else b"II")
    out += struct.pack(order + "HHHQ", 43, 8, 0, 0) if bigtiff else \
        struct.pack(order + "HI", 42, 0)
    ifd_ptr_at = 8 if bigtiff else 4
    for page in range(pages):
        img = samples if page == 0 else samples[::-1]
        planes = [img] if planar == 1 else [img[..., k:k + 1]
                                            for k in range(spp)]
        if blocks is not None:
            planes, page_blocks = [], list(blocks)
        else:
            page_blocks = []
        for plane in planes:
            if predictor == 2:
                plane = _predict(plane, bits)
            if tile is None:
                rps = rows_per_strip or H
                for y in range(0, H, rps):
                    part = plane[y:y + rps]
                    if subsampling:
                        raw = _pack_units(part, *subsampling)
                        rows = -(-part.shape[0] // subsampling[1])
                    else:
                        raw = _pack_rows(part, bits, order).tobytes()
                        rows = part.shape[0]
                    page_blocks.append(_compress(raw, rows, compression))
            else:
                th, tw = tile
                for y in range(0, H, th):
                    for x in range(0, W, tw):
                        t = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                        part = plane[y:y + th, x:x + tw]
                        t[:part.shape[0], :part.shape[1]] = part
                        if subsampling:
                            raw = _pack_units(t, *subsampling)
                            rows = th // subsampling[1]
                        else:
                            raw = _pack_rows(t, bits, order).tobytes()
                            rows = th
                        page_blocks.append(_compress(raw, rows, compression))
        if fill_order == 2:
            page_blocks = [_REVERSED[np.frombuffer(b, np.uint8)].tobytes()
                           for b in page_blocks]
        offsets = []
        for b in page_blocks:
            offsets.append(len(out))
            out += b
            if len(out) % 2:
                out += b"\0"
        code = 5 if compression == 6005 else compression
        tags = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bits] * spp),
                (259, 3, [code]), (262, 3, [photometric]),
                (277, 3, [spp]), (284, 3, [planar])]
        if tile is None:
            tags += [(273, off_t, offsets), (278, 4, [rows_per_strip or H]),
                     (279, off_t, [len(b) for b in page_blocks])]
        else:
            tags += [(322, 4, [tile[1]]), (323, 4, [tile[0]]),
                     (324, off_t, offsets),
                     (325, off_t, [len(b) for b in page_blocks])]
        if predictor != 1:
            tags.append((317, 3, [predictor]))
        if fill_order != 1:
            tags.append((266, 3, [fill_order]))
        if subsampling:
            tags.append((530, 3, list(subsampling)))
        if orientation is not None:
            tags.append((274, 3, [orientation]))
        if extra_samples is not None:
            tags.append((338, 3, list(extra_samples)))
        if colormap is not None:
            cm = np.asarray(colormap, np.int64)  # (2**bits, 3) 16-bit
            tags.append((320, 3, cm.T.ravel().tolist()))
        if sample_format is not None:
            tags.append((339, 3, [sample_format] * spp))
        tags += list(extra_tags)
        tags.sort(key=lambda t: t[0])
        inline = 8 if bigtiff else 4
        entries, values = [], bytearray()
        ifd_at = len(out) + (len(out) % 2)
        out += b"\0" * (ifd_at - len(out))
        n_entry = 20 if bigtiff else 12
        data_at = ifd_at + (8 if bigtiff else 2) + n_entry * len(tags) + (
            8 if bigtiff else 4)
        for tag, typ, vals in tags:
            if typ == 2:
                body = bytes(vals)
                count = len(body)
            else:
                fmt = _TYPE_FMT[typ]
                if typ in (5,):
                    body = b"".join(struct.pack(order + "II", *v)
                                    for v in vals)
                else:
                    body = struct.pack(order + fmt * len(vals), *vals)
                count = len(vals)
            if len(body) <= inline:
                field = body + b"\0" * (inline - len(body))
            else:
                field = struct.pack(order + ("Q" if bigtiff else "I"),
                                    data_at + len(values))
                values += body + (b"\0" if len(body) % 2 else b"")
            entries.append(struct.pack(order + ("HHQ" if bigtiff else "HHI"),
                                       tag, typ, count) + field)
        struct.pack_into(order + ("Q" if bigtiff else "I"), out, ifd_ptr_at,
                         ifd_at)
        out += struct.pack(order + ("Q" if bigtiff else "H"), len(tags))
        out += b"".join(entries)
        ifd_ptr_at = len(out)
        out += b"\0" * (8 if bigtiff else 4)
        out += values
    return bytes(out)


# ---------------------------------------------------------------------- BMP

def _bmp_rows(pix, bpp):
    """Row bytes (h, stride) of pixels at `bpp` (indices below 8 bits,
    (h, w, 3) BGR at 24, (h, w) uint16 at 16, (h, w) uint32 at 32), each
    row padded to 4 bytes."""
    h = pix.shape[0]
    if bpp < 8:
        b = ((pix.astype(np.uint8)[..., None] >> np.arange(bpp - 1, -1, -1))
             & 1).reshape(h, -1)
        rows = np.packbits(b, axis=1)
    elif bpp == 8:
        rows = pix.astype(np.uint8).reshape(h, -1)
    elif bpp == 16:
        rows = pix.astype("<u2").reshape(h, -1).view(np.uint8)
    elif bpp == 24:
        rows = pix.astype(np.uint8).reshape(h, -1)
    else:
        rows = pix.astype("<u4").reshape(h, -1).view(np.uint8)
    pad = (-rows.shape[1]) % 4
    return np.pad(rows, ((0, 0), (0, pad)))


def rle_bmp(indices, bpp, ops=None):
    """BI_RLE8 (bpp 8) or BI_RLE4 (bpp 4) of index rows (bottom row
    first, as stored): encoded runs and absolute runs per row, an
    end-of-line after each and an end-of-bitmap last.  `ops`, if given,
    replaces that: a list of ("run", n, value), ("abs", values),
    ("eol",), ("delta", dx, dy), ("eob",) written as they are."""
    if ops is None:
        ops = []
        for row in indices:
            row = np.asarray(row).tolist()
            i = 0
            while i < len(row):
                j = i
                while j < len(row) and row[j] == row[i] and j - i < 255:
                    j += 1
                if j - i >= 3 or len(row) - i < 3:
                    ops.append(("run", j - i, row[i]))
                    i = j
                else:
                    k = min(len(row), i + 255)
                    j = i + 3
                    while j < k and not (j + 2 < len(row) and row[j]
                                         == row[j + 1] == row[j + 2]):
                        j += 1
                    ops.append(("abs", row[i:j]))
                    i = j
            ops.append(("eol",))
        ops[-1] = ("eob",)
    out = bytearray()
    for op in ops:
        if op[0] == "run":
            n, v = op[1], op[2]
            if bpp == 4 and np.ndim(v):  # two alternating indices
                v = (v[0] << 4) | v[1]
            elif bpp == 4:
                v = (v << 4) | v
            out += bytes([n, v])
        elif op[0] == "abs":
            vals = list(op[1])
            out += bytes([0, len(vals)])
            if bpp == 8:
                body = bytes(vals)
            else:
                vals = vals + [0] * (len(vals) % 2)
                body = bytes((vals[i] << 4) | vals[i + 1]
                             for i in range(0, len(vals), 2))
            out += body + (b"\0" if len(body) % 2 else b"")
        elif op[0] == "eol":
            out += b"\0\0"
        elif op[0] == "delta":
            out += bytes([0, 2, op[1], op[2]])
        elif op[0] == "eob":
            out += b"\0\1"
    return bytes(out)


def bmp_bytes(pix, bpp, *, header=40, palette=None, compression=0,
              top_down=False, masks=None, rle_ops=None, colors_used=None):
    """A BMP file: `pix` as `_bmp_rows` takes it, rows given top first;
    header 12 (core), 40 (info), 64 (OS/2 2.x), 108 (V4) or 124 (V5);
    `palette` (n, 3) RGB; compression 0 (BI_RGB), 1 (RLE8), 2 (RLE4) or
    3 (BI_BITFIELDS, with `masks` (r, g, b[, a])); negative height when
    `top_down`.  rle_ops: `rle_bmp`'s explicit operations."""
    pix = np.asarray(pix)
    h, w = pix.shape[:2]
    stored = pix if top_down else pix[::-1]
    if compression in (1, 2):
        data = rle_bmp(stored, bpp, rle_ops)
    else:
        data = _bmp_rows(stored, bpp).tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]  # BGR
        if header == 12:
            pal = p.tobytes()
        else:
            pal = np.concatenate([p, np.zeros((len(p), 1), np.uint8)],
                                 1).tobytes()
    hh = -h if top_down else h
    if header == 12:
        hdr = struct.pack("<IHHHH", 12, w, hh & 0xFFFF, 1, bpp)
    else:
        n_colors = (len(palette) if palette is not None else 0) \
            if colors_used is None else colors_used
        hdr = struct.pack("<IiiHHIIiiII", header, w, hh, 1, bpp,
                          compression, len(data), 2835, 2835, n_colors, 0)
        if header in (108, 124):
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            hdr += struct.pack("<IIII", *m[:4]) + b"sRGB"[::-1] + \
                b"\0" * 36 + b"\0" * 12
            if header == 124:
                hdr += b"\0" * 16
        elif header == 64:
            hdr += b"\0" * 24
        elif compression == 3:
            hdr += struct.pack("<III", *masks[:3])
    off = 14 + len(hdr) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + hdr
            + pal + data)


# ---------------------------------------------------------- PBM/PGM/PPM/PAM

def pnm_bytes(samples, kind, maxval=255, *, comments=(), sep=b"\n",
              row_breaks=True):
    """P1-P6 of `samples` ((h, w) or (h, w, 3) ints <= maxval; for P1 and
    P4, 1 is black).  comments: (where, text) with where in "magic",
    "width", "height", "maxval" (after that token)."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    at = {k: b"" for k in ("magic", "width", "height", "maxval")}
    for where, text in comments:
        at[where] += b"\n#" + text.encode() + b"\n"
    head = b"P%d" % kind + at["magic"] + sep + b"%d" % w + at["width"] + \
        b" " + b"%d" % h + at["height"]
    if kind not in (1, 4):
        head += sep + b"%d" % maxval + at["maxval"]
    head += b"\n"
    if kind in (1, 2, 3):
        rows = samples.reshape(h, -1)
        fmt = b"%d" if kind != 1 else b"%d"
        body = b"".join(b" ".join(fmt % v for v in r) + (
            b"\n" if row_breaks else b" ") for r in rows.tolist())
        return head + body
    if kind == 4:
        return head + np.packbits(samples.astype(np.uint8), axis=1).tobytes()
    dt = ">u2" if maxval > 255 else np.uint8
    return head + samples.astype(dt).tobytes()


def pam_bytes(samples, maxval=255, tupltype=None, *, extra_header=b""):
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, d = samples.shape
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, d,
                                                                maxval)
    if tupltype:
        head += b"TUPLTYPE " + tupltype.encode() + b"\n"
    head += extra_header + b"ENDHDR\n"
    dt = ">u2" if maxval > 255 else np.uint8
    return head + samples.astype(dt).tobytes()


def pfm_bytes(values, scale=-1.0):
    """PFM: (h, w) ("Pf") or (h, w, 3) ("PF") float32, rows bottom first,
    little-endian when `scale` < 0."""
    values = np.asarray(values, np.float32)
    h, w = values.shape[:2]
    kind = b"PF" if values.ndim == 3 else b"Pf"
    order = "<" if scale < 0 else ">"
    return (kind + b"\n%d %d\n" % (w, h) + (b"%g\n" % scale)
            + values[::-1].astype(order + "f4").tobytes())


# --------------------------------------------------------------- Sun raster

def rle_sun(data):
    """Sun raster byte encoding: a run of n > 2 bytes (or any run of
    0x80) as 0x80, n - 1, byte; a single 0x80 as 0x80 0x00."""
    data = np.frombuffer(bytes(data), np.uint8)
    out = bytearray()
    start, length = _runs(data)
    for s, n in zip(start.tolist(), length.tolist()):
        v = int(data[s])
        while n > 0:
            k = min(n, 256)
            if k > 2 or v == 0x80:
                if v == 0x80 and k == 1:
                    out += b"\x80\x00"
                else:
                    out += bytes([0x80, k - 1, v])
            else:
                out += bytes([v]) * k
            n -= k
    return bytes(out)


def sunras_bytes(pix, depth, *, ras_type=1, colormap=None, maptype=None,
                 length=None):
    """A Sun raster file: `pix` (h, w) indices or bits at depth 1 and 8,
    (h, w, 3) RGB at 24 and 32 (stored BGR, or RGB for type 3; 32 with
    a pad byte first); rows padded to 16 bits; type 0 (old), 1
    (standard), 2 (byte-encoded) or 3 (RGB); `colormap` (n, 3) RGB."""
    pix = np.asarray(pix)
    h, w = pix.shape[:2]
    if depth == 1:
        rows = np.packbits(pix.astype(np.uint8), axis=1)
    elif depth == 8:
        rows = pix.astype(np.uint8).reshape(h, -1)
    else:
        px = pix.astype(np.uint8)
        if ras_type != 3:
            px = px[..., ::-1]
        if depth == 32:
            px = np.concatenate([np.zeros((h, w, 1), np.uint8), px], -1)
        rows = px.reshape(h, -1)
    rows = np.pad(rows, ((0, 0), (0, rows.shape[1] % 2)))
    data = rows.tobytes()
    if ras_type == 2:
        data = rle_sun(data)
    cmap = b""
    if colormap is not None:
        cm = np.asarray(colormap, np.uint8)
        cmap = cm.T.tobytes()
    if maptype is None:
        maptype = 1 if colormap is not None else 0
    n = len(data) if length is None else length
    if ras_type == 0 and length is None:
        n = 0
    return struct.pack(">8I", 0x59A66A95, w, h, depth, n, ras_type, maptype,
                       len(cmap)) + cmap + data


# -------------------------------------------------------------- Radiance HDR

def float_to_rgbe(rgb):
    """RGBE bytes (h, w, 4) of float RGB as Ward's float2rgbe: frexp of
    the largest component v, mantissa m, each component * m * 256 / v."""
    rgb = np.asarray(rgb, np.float32)
    v = rgb.max(-1).astype(np.float64)
    m, e = np.frexp(v)
    scale = np.where(v < 1e-32, 0.0, m * 256.0 / np.where(v == 0, 1, v))
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.int64).clip(0, 255)
    out[..., 3] = np.where(v < 1e-32, 0, e + 128)
    return out


def _rle_hdr_component(vals):
    out, i, n = bytearray(), 0, len(vals)
    while i < n:
        j = i
        while j < n and vals[j] == vals[i] and j - i < 127:
            j += 1
        if j - i >= 4:
            out += bytes([128 + j - i, vals[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128:
            r = k
            while r < n and vals[r] == vals[k] and r - k < 4:
                r += 1
            if r - k >= 4:
                break
            k += 1
        out += bytes([k - i]) + bytes(vals[i:k])
        i = k
    return bytes(out)


def hdr_bytes(rgbe, *, magic=b"#?RADIANCE", encoding="new",
              size_line=None, header_lines=(b"FORMAT=32-bit_rle_rgbe",)):
    """A Radiance HDR file of RGBE bytes (h, w, 4): encoding "new" (each
    scanline 2 2 w and its four components run-length encoded), "old"
    (a repeat of the previous pixel as 1 1 1 n, n shifted by 8 for
    each repeat in a row) or "flat"."""
    rgbe = np.asarray(rgbe, np.uint8)
    h, w = rgbe.shape[:2]
    head = magic + b"\n" + b"".join(line + b"\n" for line in header_lines)
    head += b"\n" + (size_line or b"-Y %d +X %d" % (h, w)) + b"\n"
    if encoding == "flat":
        return head + rgbe.tobytes()
    out = bytearray()
    for row in rgbe:
        if encoding == "new":
            out += bytes([2, 2, w >> 8, w & 255])
            for c in range(4):
                out += _rle_hdr_component(row[:, c].tolist())
            continue
        px = [bytes(p) for p in row]
        i = 0
        while i < w:
            out += px[i]
            j = i + 1
            while j < w and px[j] == px[i] and j - i < 256:
                j += 1
            n = j - i - 1
            if n >= 2 and i > 0:
                shift = 0
                while n:
                    out += bytes([1, 1, 1, n & 255])
                    n >>= 8
                    shift += 8
                i = j
            else:
                i += 1
    return head + bytes(out)


# ---------------------------------------------------------------------- GIF

def gif_bytes(frames, *, screen, global_table=None, background=0,
              version=b"89a", loop=True):
    """A GIF file.  screen: (w, h).  frames: dicts with `indices` (h, w),
    `left`, `top`, optional `table` (local colour table, RGB), `interlace`,
    `transparent` (index), `disposal`, `delay`.  Tables are padded to a
    power of two."""
    def table_bytes(t):
        t = np.asarray(t, np.uint8)
        size = max(1, int(np.ceil(np.log2(max(len(t), 2)))))
        full = np.zeros((1 << size, 3), np.uint8)
        full[:len(t)] = t
        return size - 1, full.tobytes()

    out = bytearray(b"GIF" + version)
    flags, gtab = 0, b""
    if global_table is not None:
        s, gtab = table_bytes(global_table)
        flags = 0x80 | (7 << 4) | s
    out += struct.pack("<HHBBB", screen[0], screen[1], flags, background, 0)
    out += gtab
    if loop and len(frames) > 1 and version == b"89a":
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = np.asarray(f["indices"])
        h, w = idx.shape
        if version == b"89a" and ("transparent" in f or "disposal" in f
                                  or "delay" in f):
            t = f.get("transparent")
            packed = (f.get("disposal", 0) << 2) | (t is not None)
            out += struct.pack("<BBBBHBB", 0x21, 0xF9, 4, packed,
                               f.get("delay", 0), t or 0, 0)
        lflags, ltab = 0, b""
        if f.get("table") is not None:
            s, ltab = table_bytes(f["table"])
            lflags = 0x80 | s
        if f.get("interlace"):
            lflags |= 0x40
            rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                                   np.arange(2, h, 4), np.arange(1, h, 2)])
            idx = idx[rows]
        out += struct.pack("<BHHHHB", 0x2C, f.get("left", 0), f.get("top", 0),
                           w, h, lflags) + ltab
        size = len(ltab) // 3 or len(gtab) // 3
        min_bits = max(2, int(np.ceil(np.log2(max(size, 2)))))
        out += lzw_gif(idx, min_bits, f.get("clear_every"))
    return bytes(out + b"\x3b")


# ------------------------------------------------ the smoke's lossless split

#: the lossless layouts of `write_layout`, in the order the split rotates
#: through them: (name, file extension)
LAYOUTS = (("tiff_none", ".tif"), ("tiff_lzw_pred2", ".tif"),
           ("tiff_deflate", ".tif"), ("tiff_packbits", ".tif"),
           ("tiff_tiled", ".tif"), ("tiff_mm", ".tif"),
           ("tiff_planar", ".tif"), ("bmp24", ".bmp"),
           ("bmp32_topdown", ".bmp"), ("ppm", ".ppm"), ("pam", ".pam"),
           ("sunras", ".ras"))


def layout_bytes(rgb, layout):
    """The file bytes of (H, W, 3) uint8 RGB in one of LAYOUTS, each read
    back by `cv2.imread` (and the port) to exactly `rgb`."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h = rgb.shape[0]
    if layout == "tiff_none":
        return tiff_bytes(rgb, rows_per_strip=32)
    if layout == "tiff_lzw_pred2":
        return tiff_bytes(rgb, compression=5, predictor=2, rows_per_strip=64)
    if layout == "tiff_deflate":
        return tiff_bytes(rgb, compression=8, rows_per_strip=h)
    if layout == "tiff_packbits":
        return tiff_bytes(rgb, compression=32773, rows_per_strip=16)
    if layout == "tiff_tiled":
        return tiff_bytes(rgb, compression=32946, tile=(128, 256))
    if layout == "tiff_planar":
        return tiff_bytes(rgb, planar=2, compression=8, predictor=2,
                          rows_per_strip=40)
    if layout == "tiff_mm":
        return tiff_bytes(rgb, big_endian=True, compression=5,
                          rows_per_strip=48)
    if layout == "bmp24":
        return bmp_bytes(rgb[..., ::-1], 24)
    if layout == "bmp32_topdown":
        bgrx = np.concatenate([rgb[..., ::-1], np.full(rgb.shape[:2] + (1,),
                                                       255, np.uint8)], -1)
        return bmp_bytes(bgrx.view("<u4")[..., 0], 32, top_down=True)
    if layout == "ppm":
        return pnm_bytes(rgb, 6)
    if layout == "pam":  # cv2 reads a PAM's RGB tuples as BGR
        return pam_bytes(rgb[..., ::-1], 255, "RGB")
    if layout == "sunras":  # cv2 refuses byte-encoded (RLE) Sun rasters
        return sunras_bytes(rgb, 24)
    raise ValueError("unknown layout %r" % layout)


def write_layout(path, rgb, layout):
    with open(path, "wb") as f:
        f.write(layout_bytes(rgb, layout))
