"""Radiance HDR reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads an HDR file with OpenCV 5.0
(grfmt_hdr.cpp and Greg Ward's rgbe.cpp):

- the file starts `#?RADIANCE` or `#?RGBE`; header lines (each as fgets
  reads it, up to 127 bytes) run to the first empty one, one of them
  exactly `FORMAT=32-bit_rle_rgbe\\n` (else the file is refused); the
  line after the empty one must be `-Y <h> +X <w>` (as sscanf matches
  it: other orientations are refused);
- scanlines as `codecs.hdr_rle` decodes them (new-style run lengths,
  flat RGBE; old-style runs are not run lengths to rgbe.cpp, so their
  `1 1 1 n` pixels are read as the pixels they look like);
- each RGBE pixel is float32 c * ldexp(1, e - 136) (0 when e is 0),
  then, as cv2's convertTo(CV_8U, 255), rounded half to even from the
  float32 product with 255 and saturated; NaN, infinity and |x| >= 2^31
  convert to 0.

What cv2 refuses raises ValueError naming the file and the cause.
Scanline data that rgbe.cpp reports as an error, or that ends early,
raises too: cv2 then returns the float image it never finished
writing, which differs from run to run."""

import re

import numpy as np

from . import codecs

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")


def _lines(data, pos):
    """fgets over `data` from `pos`: (line bytes with its newline, next
    position), lines cut at 127 bytes."""
    if pos >= len(data):
        return None, pos
    end = data.find(b"\n", pos, pos + 127)
    end = min(pos + 127, len(data)) if end < 0 else end + 1
    return data[pos:end], end


def decode_hdr(data, name="HDR data"):
    """(H, W, 3) uint8 RGB of the Radiance HDR file held in `data`."""
    if not data.startswith(SIGNATURES):
        raise ValueError("%s: not a Radiance HDR file" % name)
    pos, has_format = 0, False
    while True:
        line, pos = _lines(data, pos)
        if line is None:
            raise ValueError("%s: HDR header ends early" % name)
        if line in (b"", b"\n") or line[:1] == b"\0":
            if has_format:
                break
            raise ValueError("%s: no FORMAT specifier in the HDR header"
                             % name)
        if line == b"FORMAT=32-bit_rle_rgbe\n":
            has_format = True
    line, pos = _lines(data, pos)
    m = re.match(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)", line or b"")
    if m is None:
        raise ValueError("%s: HDR size line %r: cv2 reads -Y <h> +X <w> only"
                         % (name, line))
    H, W = int(m.group(1)), int(m.group(2))
    if H <= 0 or W <= 0:
        raise ValueError("%s: HDR size %dx%d" % (name, W, H))
    rgbe = codecs.hdr_rle(data[pos:], W, H, name)
    e = rgbe[..., 3].astype(np.int32)
    f = np.ldexp(np.float64(1.0), e - 136).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        v = rgbe[..., :3].astype(np.float32) * f[..., None]
        v = np.where(e[..., None] == 0, np.float32(0), v)
        y = v * np.float32(255)
    y = np.where(np.abs(y) < np.float32(2 ** 31), y, np.float32(0))
    return np.clip(np.rint(y), 0, 255).astype(np.uint8)
