"""PBM/PGM/PPM (P1-P6), PAM (P7) and PFM reading for the port's
`imgproc.imread_rgb`, bit for bit as `cv2.imread(path)` (then BGR ->
RGB) reads them with OpenCV 5.0 (grfmt_pxm.cpp, grfmt_pam.cpp,
grfmt_pfm.cpp).

P1-P6: every number, the header's and an ASCII raster's, is read as
cv2's ReadNumber reads it: whitespace and `#` comments (to the end of
the line) may come before it, any other byte is an error, and one byte
after its digits is consumed (so binary data starts one byte after the
last header number); a P1 pixel is one digit.

- P1/P4: 1 is black, 0 white (P4 rows padded to a byte).
- P2/P3 (ASCII): values above maxval are clamped to it; with maxval
  below 256 they are scaled to v * 255 // maxval; above, v >> 8.
- P5/P6 (binary): bytes as they are whatever maxval below 256 (no
  scaling); above, big-endian 16-bit samples, v >> 8.

P7 (PAM): header lines `WIDTH`, `HEIGHT`, `DEPTH`, `MAXVAL`, `TUPLTYPE`
up to `ENDHDR` (as `_pam_header` reads them); samples as they are
(maxval up to 255) or v >> 8; grey
replicated; the three samples of an RGB tuple come out in the file's
order as cv2's blue, green, red, so `imread_rgb` gives them reversed;
maxval 1 reads each row's first bytes as MSB-first bits, one grey
pixel each (1 is 255), a row still taking width * depth bytes.  cv2's
reads of GRAYSCALE_ALPHA and RGB_ALPHA differ from run to run (they
return memory they never wrote): the port raises on them.

PFM: `PF`, a line break, then width, height and scale, each ended by
one whitespace byte; the scale's sign gives the byte order
(negative: little-endian), float32 rows bottom first; cv2 multiplies
them by float32(1 / |scale|) and converts them to 8 bits unscaled,
rounding half to even and saturating, NaN and |x| >= 2^31 to 0.  Grey
PFMs (`Pf`) cv2 refuses.

What cv2 refuses raises ValueError naming the file and the cause."""

import re

import numpy as np


class _Stream:
    """The byte reader of cv2's ReadNumber."""

    def __init__(self, data, pos, name):
        self.data, self.pos, self.name = data, pos, name

    def byte(self):
        if self.pos >= len(self.data):
            raise ValueError("%s: PxM data ends early" % self.name)
        self.pos += 1
        return self.data[self.pos - 1]

    def number(self, maxdigits=0):
        code = self.byte()
        while not 48 <= code <= 57:
            if code == 35:  # '#': skip to the end of the line
                while code not in (10, 13):
                    code = self.byte()
                code = self.byte()
            elif code in b" \t\n\v\f\r":
                while code in b" \t\n\v\f\r":
                    code = self.byte()
            else:
                raise ValueError("%s: unexpected byte 0x%x in a PxM number"
                                 % (self.name, code))
        val = digits = 0
        while True:
            val = val * 10 + code - 48
            if val > 0x7FFFFFFF:
                raise ValueError("%s: PxM number too large" % self.name)
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            code = self.byte()
            if not 48 <= code <= 57:
                break
        return val


def _grey3(g):
    return np.repeat(np.asarray(g, np.uint8)[..., None], 3, -1)


def decode_pnm(data, name="PxM data"):
    """(H, W, 3) uint8 RGB of a P1-P6 file held in `data`."""
    if len(data) < 2 or data[0] != 0x50 or data[1] not in b"123456":
        raise ValueError("%s: not a PBM/PGM/PPM file" % name)
    kind = data[1] - 48
    s = _Stream(data, 2, name)
    W, H = s.number(), s.number()
    maxval = 1 if kind in (1, 4) else s.number()
    if maxval > 65535 or W <= 0 or H <= 0 or maxval <= 0:
        raise ValueError("%s: PxM size %dx%d, maxval %d" % (name, W, H,
                                                             maxval))
    ch = 3 if kind in (3, 6) else 1
    if kind == 1:
        bits = np.array([[s.number(1) != 0 for _ in range(W)]
                         for _ in range(H)], np.uint8)
        return _grey3(255 - bits * 255)
    if kind == 4:
        pitch = (W + 7) // 8
        if s.pos + H * pitch > len(data):
            raise ValueError("%s: PBM data ends early" % name)
        rows = np.frombuffer(data, np.uint8, H * pitch, s.pos).reshape(
            H, pitch)
        bits = np.unpackbits(rows, axis=1)[:, :W]
        return _grey3(255 - bits * 255)
    n = W * H * ch
    if kind in (2, 3):
        v = np.array([s.number() for _ in range(n)], np.int64)
        v = np.minimum(v, maxval)
        v = v * 255 // maxval if maxval < 256 else v >> 8
    else:
        wide = maxval > 255
        nbytes = n * (2 if wide else 1)
        if s.pos + nbytes > len(data):
            raise ValueError("%s: PxM data ends early (%d of %d bytes)"
                             % (name, len(data) - s.pos, nbytes))
        v = np.frombuffer(data, ">u2" if wide else np.uint8, n, s.pos)
        if wide:
            v = v >> 8
    v = v.astype(np.uint8).reshape(H, W, ch)
    return _grey3(v[..., 0]) if ch == 1 else np.ascontiguousarray(v)


#: PAM tuple types cv2 knows, and the depth each needs
_TUPLTYPES = {"BLACKANDWHITE": 1, "GRAYSCALE": 1, "GRAYSCALE_ALPHA": 2,
              "RGB": 3, "RGB_ALPHA": 4}


def _pam_header(data, name):
    """(fields {key: value}, data position) of a PAM header, read as
    cv2's ReadPAMHeaderLine reads it: the magic line is `P7` and a line
    break; each line starts after any whitespace (blank lines vanish),
    `#` starts a comment, a key must be one of `_PAM_KEYS` (else the file
    is refused) and ends at whitespace, its value runs to the line break
    (`\\n` or `\\r`, one byte); the data starts right after ENDHDR's
    line break."""
    if data[:2] != b"P7" or data[2:3] not in (b"\n", b"\r"):
        raise ValueError("%s: invalid PAM magic line" % name)
    pos, fields, n = 3, {}, len(data)
    while True:
        while pos < n and data[pos] in b" \t\n\v\f\r":
            pos += 1
        if pos >= n:
            raise ValueError("%s: PAM header without ENDHDR" % name)
        if data[pos] == 0x23:  # '#'
            while pos < n and data[pos] not in b"\n\r":
                pos += 1
            pos += 1
            continue
        start = pos
        while pos < n and data[pos] not in b" \t\n\v\f\r":
            pos += 1
        key = data[start:pos].decode("latin-1")
        if key not in _PAM_KEYS or pos >= n:
            raise ValueError("%s: invalid PAM header line %r" % (name, key))
        if data[pos] in b"\n\r":
            value = ""
        else:
            while pos < n and data[pos] in b" \t\n\v\f\r":
                pos += 1
            start = pos
            while pos < n and data[pos] not in b"\n\r":
                pos += 1
            if pos >= n:
                raise ValueError("%s: PAM header ends early" % name)
            value = data[start:pos].decode("latin-1")
        pos += 1
        if key == "ENDHDR":
            return fields, pos
        fields[key] = value


_PAM_KEYS = ("WIDTH", "HEIGHT", "DEPTH", "MAXVAL", "TUPLTYPE", "ENDHDR")


def _atoi(text):
    """atoi: the leading integer of `text` (0 if none)."""
    m = re.match(r"\s*([+-]?\d+)", text)
    return int(m.group(1)) if m else 0


def decode_pam(data, name="PAM data"):
    """(H, W, 3) uint8 RGB of a P7 file held in `data`."""
    fields, pos = _pam_header(data, name)
    if not {"WIDTH", "HEIGHT", "DEPTH", "MAXVAL"} <= fields.keys():
        raise ValueError("%s: PAM header lacks WIDTH, HEIGHT, DEPTH or "
                         "MAXVAL" % name)
    W, H = _atoi(fields["WIDTH"]), _atoi(fields["HEIGHT"])
    depth, maxval = _atoi(fields["DEPTH"]), _atoi(fields["MAXVAL"])
    tupl = fields.get("TUPLTYPE")
    if tupl is not None and tupl not in _TUPLTYPES:
        raise ValueError("%s: PAM tuple type %r" % (name, tupl))
    if W <= 0 or H <= 0 or not 0 < maxval <= 65535 or (
            depth not in (1, 3) and tupl is None):
        raise ValueError("%s: PAM %dx%d, depth %d, maxval %d"
                         % (name, W, H, depth, maxval))
    if tupl is None and maxval > 255:
        raise ValueError("%s: cv2 reads 16-bit PAMs only with a TUPLTYPE"
                         % name)
    if tupl is not None and _TUPLTYPES[tupl] != depth:
        raise ValueError("%s: PAM tuple type %s with depth %d"
                         % (name, tupl, depth))
    if depth in (2, 4):
        raise ValueError("%s: cv2's reads of PAM %s differ from run to run "
                         "(memory it never wrote); not read by the port"
                         % (name, tupl))
    wide = maxval > 255
    n = W * H * depth
    nbytes = n * (2 if wide else 1)
    if pos + nbytes > len(data):
        raise ValueError("%s: PAM data ends early (%d of %d bytes)"
                         % (name, len(data) - pos, nbytes))
    if maxval == 1:
        rows = np.frombuffer(data, np.uint8, n, pos).reshape(H, W * depth)
        bits = np.unpackbits(rows[:, :(W + 7) // 8], axis=1)[:, :W]
        return _grey3(bits * 255)
    v = np.frombuffer(data, ">u2" if wide else np.uint8, n, pos)
    if wide:
        v = v >> 8
    v = v.astype(np.uint8).reshape(H, W, depth)
    if depth == 1:
        return _grey3(v[..., 0])
    return np.ascontiguousarray(v[..., ::-1])


def _token(data, pos, name):
    """cv2's read_number: the bytes up to one whitespace byte, which it
    consumes.  Returns (token, next position)."""
    end = pos
    while end < len(data) and data[end] not in b" \t\n\v\f\r":
        end += 1
    if end >= len(data):
        raise ValueError("%s: PFM header ends early" % name)
    return data[pos:end].decode("latin-1"), end + 1


def decode_pfm(data, name="PFM data"):
    """(H, W, 3) uint8 RGB of a PFM file held in `data`."""
    if data[:2] not in (b"PF", b"Pf") or data[2:3] != b"\n":
        raise ValueError("%s: not a PFM file (PF or Pf and a line break)"
                         % name)
    if data[1:2] == b"f":
        raise ValueError("%s: cv2 does not read grey PFMs (imread's "
                         "\"Internal imread issue\")" % name)
    w, pos = _token(data, 3, name)
    h, pos = _token(data, pos, name)
    scale, pos = _token(data, pos, name)
    m = re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", scale)
    if not re.match(r"[+-]?\d", w) or not re.match(r"[+-]?\d", h) or m is None:
        raise ValueError("%s: PFM header %r %r %r" % (name, w, h, scale))
    W, H, scale = _atoi(w), _atoi(h), float(m.group(0))
    if W <= 0 or H <= 0:
        raise ValueError("%s: PFM %dx%d" % (name, W, H))
    n = W * H * 3
    if pos + 4 * n > len(data):
        raise ValueError("%s: PFM data ends early" % name)
    f = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, pos).astype(
        np.float32).reshape(H, W, 3)[::-1]
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        f = f * np.float32(np.float64(1.0) / abs(scale))
    # cvRound: half to even; NaN and |x| >= 2^31 give INT_MIN, so 0
    bad = ~(np.abs(f) < np.float32(2 ** 31))
    v = np.rint(np.where(bad, 0, f))
    return np.ascontiguousarray(np.clip(v, 0, 255).astype(np.uint8))
