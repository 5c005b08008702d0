"""A PNG writer for every colour type, bit depth, filter and interlace
method the PNG specification has, for the tests that hold the port's
reader (`mergenet_tpu_torch/io.py`) to cv2's libpng.

cv2 writes non-interlaced files only and chooses its filters itself;
`write_png` writes what a test asks for: Adam7 or not, each scanline
with the filter type a generator draws (0-4), 1-, 2-, 4-, 8- and 16-bit
samples, a PLTE and a tRNS chunk, the image data split over several
IDAT chunks.

Used by `tests/test_torch_port_png.py` and
`tests/make_jpeg_fixtures.py`."""

import struct
import zlib

import numpy as np

#: samples per pixel of each colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

#: Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def _pack(samples, depth):
    """Rows of packed bytes of samples (h, w, ch), big-endian at 16."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
        h, -1)
    return np.packbits(bits, axis=1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows, bpp, rng):
    """Each row (uint8) filtered with a type drawn from `rng` (0 when
    None), its type byte first."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for row in rows.astype(np.int64):
        t = 0 if rng is None else int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) >> 1,
                4: _paeth(left, prev, upleft)}[t]
        out.append(bytes([t]) + ((row - pred) & 255).astype(np.uint8)
                   .tobytes())
        prev = row
    return b"".join(out)


def write_png(path, samples, color, depth, *, interlace=False, palette=None,
              trns=None, rng=None, idat_chunks=1):
    """Write `samples` (H, W, channels of `color`), values below
    2**depth, as a PNG of colour type `color` at `depth` bits, Adam7
    interlaced when `interlace`, each scanline's filter drawn from `rng`
    (None: no filter).  palette: (N, 3) uint8 for colour type 3; trns:
    the tRNS chunk's body."""
    samples = np.asarray(samples)
    H, W, ch = samples.shape
    assert ch == CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter(_pack(sub, depth), bpp, rng)
    else:
        raw = _filter(_pack(samples, depth), bpp, rng)
    z = zlib.compress(raw)
    cut = np.linspace(0, len(z), idat_chunks + 1).astype(int)
    body = chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0,
                                      int(interlace)))
    if palette is not None:
        body += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    body += b"".join(chunk(b"IDAT", z[a:b]) for a, b in zip(cut, cut[1:]))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b""))
