"""The OpenCV operations the data loaders need, in numpy, bit for bit.

The reference's loaders call cv2 (`mergenet_tpu/data/dataset.py:75-80,
186-191`, `data_io.py:149-150`, `grain_pipeline.py:49-55`,
`rle.py:163-171`); the GPU machine has no cv2, PIL or grain.  Each
function here reproduces what cv2 computes, not an approximation of it:

    imread_rgb(path)             cv2.imread(path) + BGR -> RGB: PNG, JPEG
    resize(img, (w, h), interpolation)
                                 cv2.resize, INTER_LINEAR (uint8, float32)
                                 and INTER_NEAREST (any dtype)
    fill_poly(img, polys, color) cv2.fillPoly, 8-connected, shift 0

- uint8 INTER_LINEAR is cv2's fixed point: 11-bit coefficients
  (`saturate_cast<short>(w * 2048)`, rounded half to even), a horizontal
  pass into int32, and a vertical pass that drops 4 bits of each row
  before a 16-bit multiply-high, then rounds the sum by `(s + 2) >> 2`.
- float32 INTER_LINEAR takes one of cv2's three routes.  At 1, 3 and 4
  channels (cv2's IPP resize, AVX-512 code) each pass interpolates as
  `fma(b - a, t, a)`, with `t` the float32 of the double fractional
  position, but for the vertical blend of the clamped border columns of
  a widened 3- or 4-channel image: IPP takes each side's run of such
  columns in blocks of 16 pixels, then the rest, and blends unfused, `a
  + (b - a) * t` rounded twice, on a 4-channel image's whole blocks and
  on a rest of 5 to 15 columns (all channels at 4, channels 0 and 1 at
  3; a rest of 1 to 4 columns and 3-channel blocks stay fused).  At 2
  or 5 and more channels, and from a source with a single row or
  column, each pass
  computes `S0 * w0 + S1 * w1` with float32 taps (the position cast to
  float first, `w0 = 1 - w1`), each product and the sum rounded to
  float32; the vertical weights are not clamped at the borders, only
  the rows are.  An exact 2x shrink in both axes at 2 or 5 and more
  channels is cv2's area-fast path: `(((S0[2x] + S0[2x+1]) + S1[2x])
  + S1[2x+1]) * 0.25`.
- Source positions are `(d + 0.5) * scale - 0.5` in double, `scale` =
  src / dst for INTER_LINEAR and `floor(d / (dst / src))` for
  INTER_NEAREST, as cv2 computes them.
- `fill_poly` follows cv2's scan converter: each edge is drawn as an
  8-connected Bresenham line, then spans between consecutive active
  edges are filled on every row, with edge abscissas in 16.16 fixed
  point (left ends rounded up, right ends down); an edge that leaves
  the image starts from its clipped end points.

`tests/test_torch_port_data_imgproc.py` holds each against cv2."""

import numpy as np

from .. import io
from . import jpeg

INTER_NEAREST = 0
INTER_LINEAR = 1

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
_XY_SHIFT = 16


def imread_rgb(path):
    """(H, W, 3) uint8 RGB of an image file, as `cv2.imread(path)` then
    `cv2.cvtColor(img, cv2.COLOR_BGR2RGB)` give it.  PNG of any colour
    type and bit depth, non-interlaced or Adam7: grey and palette images
    are expanded, alpha is dropped, 16-bit samples keep their high byte.
    JPEG (`jpeg.decode_jpeg`): every file cv2 reads (Huffman or
    arithmetic coding, sequential, progressive or lossless; grey, YCbCr,
    RGB, CMYK or YCCK), EXIF orientation applied.  Other formats, and
    the JPEGs cv2 refuses too (12-bit, 2 components, lossless grey or
    YCbCr, hierarchical), raise ValueError naming the file and the
    cause, as does truncated or corrupt data."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:3] == b"\xff\xd8\xff":
        with open(path, "rb") as f:
            return jpeg.decode_jpeg(f.read(), path)
    if head != b"\x89PNG\r\n\x1a\n":
        raise ValueError("%s is neither a PNG nor a JPEG file" % path)
    return io.read_png_rgb(path)


# ---------------------------------------------------------------- resize

def _linear_taps(dst, src):
    """Per destination index: source index of the left tap (clamped as
    cv2 clamps it) and the double fractional weight of the right tap."""
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx)
    f = fx - sx
    sx = sx.astype(np.int64)
    lo = sx < 0
    f[lo], sx[lo] = 0.0, 0
    hi = sx >= src - 1
    f[hi], sx[hi] = 0.0, src - 1
    return sx, np.minimum(sx + 1, src - 1), f


def _linear_taps_u8(dst, src):
    """cv2's fixed-point taps: the position computed in double and cast to
    float, its floor, and the two coefficients saturate_cast<short>(w *
    2048) (rounded half to even)."""
    fx = ((np.arange(dst, dtype=np.float64) + 0.5) * (1.0 / (dst / src))
          - 0.5).astype(np.float32)
    sx = np.floor(fx)
    f = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    return sx, f


def _resize_linear_u8(img, dw, dh):
    H, W = img.shape[:2]
    src = img.reshape(H, W, -1).astype(np.int64)
    sx, fx = _linear_taps_u8(dw, W)
    lo = sx < 0
    fx[lo], sx[lo] = 0, 0
    hi = sx >= W - 1
    fx[hi], sx[hi] = 0, W - 1
    a1 = np.rint(fx * np.float32(_COEF_SCALE)).astype(np.int64)
    a0 = np.rint((np.float32(1) - fx) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    x1 = np.minimum(sx + 1, W - 1)
    rows = (src[:, sx] * a0[None, :, None]
            + src[:, x1] * a1[None, :, None])  # int32 in cv2, scale 2^11
    sy, fy = _linear_taps_u8(dh, H)  # rows are clipped, weights not
    b1 = np.rint(fy * np.float32(_COEF_SCALE)).astype(np.int64)
    b0 = np.rint((np.float32(1) - fy) * np.float32(_COEF_SCALE)).astype(
        np.int64)
    r0 = rows[np.clip(sy, 0, H - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, H - 1)] >> 4
    s = (((r0 * b0[:, None, None]) >> 16)
         + ((r1 * b1[:, None, None]) >> 16))
    out = np.clip((s + 2) >> 2, 0, 255).astype(np.uint8)
    return out.reshape((dh, dw) + img.shape[2:])


def _fma32(a, b, c):
    """float32 a * b + c rounded once (a fused multiply-add) for float32
    arrays: the product is exact in float64, the sum is rounded to float64
    and then to float32, and the one case where that double rounding can
    differ from a single rounding (a float64 sum on a float32 midpoint
    with a nonzero residual) is corrected from the residual."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    p = a * b
    s = p + c
    bp = s - c  # TwoSum: the exact residual of the float64 sum
    e = (p - bp) + (c - (s - bp))
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    toward = np.nextafter(r, np.where(d > 0, np.float32(np.inf),
                                      np.float32(-np.inf)))
    mid = (d != 0) & (np.abs(d) * 2 == np.abs(
        toward.astype(np.float64) - r.astype(np.float64)))
    # on a midpoint the cast rounded to even; the residual decides instead
    past = mid & (e != 0) & (np.sign(e) == np.sign(d))
    back = mid & (e != 0) & (np.sign(e) != np.sign(d))
    out = np.where(past, toward, r)
    return np.where(back, r, out).astype(np.float32)


#: IPP's blocks of clamped border columns, and the shortest rest of a
#: run that it blends unfused
_IPP_BORDER_BLOCK = 16
_IPP_BORDER_REST = 5


def _border_unfused(dw, W, cn):
    """(dw, cn) bool: the destination columns and channels whose vertical
    blend cv2's IPP route computes unfused (the clamped border runs of a
    widened 3- or 4-channel image, module docstring)."""
    out = np.zeros((dw, cn), bool)
    if cn not in (3, 4):
        return out
    sx = np.floor((np.arange(dw, dtype=np.float64) + 0.5) * (W / dw) - 0.5)
    for run in (np.flatnonzero(sx < 0), np.flatnonzero(sx >= W - 1)):
        n = run.size
        whole = np.arange(n) < n - n % _IPP_BORDER_BLOCK
        rest = ~whole & (n % _IPP_BORDER_BLOCK >= _IPP_BORDER_REST)
        if cn == 4:
            out[run] = (whole | rest)[:, None]
        else:
            out[run, :2] = rest[:, None]
    return out


def _resize_linear_f32(img, dw, dh):
    H, W = img.shape[:2]
    src = img.reshape(H, W, -1).astype(np.float32)
    x0, x1, f = _linear_taps(dw, W)
    a, b = src[:, x0], src[:, x1]
    rows = _fma32(b - a, np.broadcast_to(
        f.astype(np.float32)[None, :, None], a.shape), a)
    fy = (np.arange(dh, dtype=np.float64) + 0.5) * (H / dh) - 0.5
    sy = np.floor(fy)
    t = (fy - sy).astype(np.float32)
    sy = sy.astype(np.int64)
    lo = sy < 0
    t[lo], sy[lo] = 0, 0
    a = rows[np.clip(sy, 0, H - 1)]
    b = rows[np.clip(sy + 1, 0, H - 1)]
    t = np.broadcast_to(t[:, None, None], a.shape)
    out = np.where(_border_unfused(dw, W, src.shape[2])[None],
                   a + (b - a) * t, _fma32(b - a, t, a))
    return out.reshape((dh, dw) + img.shape[2:])


def _taps32(dst, src, clamp_weight):
    """cv2's float taps: the float32 of the double position, its floor
    and the float32 fraction w1; indices clipped to the source, and the
    weight set to 0 where the left tap was clamped when
    `clamp_weight` (cv2 does so on the horizontal pass only)."""
    fx = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
          - 0.5).astype(np.float32)
    sx = np.floor(fx)
    w1 = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    if clamp_weight:
        w1[(sx < 0) | (sx >= src - 1)] = 0
    return np.clip(sx, 0, src - 1), np.clip(sx + 1, 0, src - 1), w1


def _resize_linear_f32_wsum(img, dw, dh):
    """cv2's generic float route: `S0 * w0 + S1 * w1` on each pass, each
    product and the sum rounded to float32."""
    H, W = img.shape[:2]
    src = img.reshape(H, W, -1).astype(np.float32)
    if H == 2 * dh and W == 2 * dw:  # cv2's area-fast path
        s0, s1 = src[0::2], src[1::2]
        acc = ((s0[:, 0::2] + s0[:, 1::2]) + s1[:, 0::2]) + s1[:, 1::2]
        return (acc * np.float32(0.25)).reshape((dh, dw) + img.shape[2:])
    one = np.float32(1)
    x0, x1, w1 = _taps32(dw, W, True)
    w1 = w1[None, :, None]
    rows = src[:, x0] * (one - w1) + src[:, x1] * w1
    y0, y1, v1 = _taps32(dh, H, False)
    v1 = v1[:, None, None]
    out = rows[y0] * (one - v1) + rows[y1] * v1
    return out.reshape((dh, dw) + img.shape[2:])


def _resize_nearest(img, dw, dh):
    H, W = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / W))).astype(
        np.int64), W - 1)
    sy = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / H))).astype(
        np.int64), H - 1)
    return img[sy][:, sx]


def resize(img, dsize, interpolation=INTER_LINEAR):
    """`cv2.resize(img, dsize, interpolation=...)` for an (H, W) or
    (H, W, C) array; `dsize` is (width, height) as cv2 takes it.
    INTER_LINEAR takes uint8 or float32, INTER_NEAREST any dtype."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:  # cv2 returns (h, w) then
        img = img[..., 0]
    dw, dh = int(dsize[0]), int(dsize[1])
    if dw <= 0 or dh <= 0 or img.shape[0] == 0 or img.shape[1] == 0:
        raise ValueError("resize: empty source %s or size %s"
                         % (img.shape, (dw, dh)))
    if interpolation == INTER_NEAREST:
        return _resize_nearest(img, dw, dh)
    if interpolation != INTER_LINEAR:
        raise ValueError("resize: only INTER_NEAREST (0) and INTER_LINEAR "
                         "(1), got %r" % (interpolation,))
    if img.dtype == np.uint8:
        return _resize_linear_u8(img, dw, dh)
    if img.dtype == np.float32:
        cn = img.shape[2] if img.ndim == 3 else 1
        if cn in (1, 3, 4) and min(img.shape[:2]) > 1:
            return _resize_linear_f32(img, dw, dh)
        return _resize_linear_f32_wsum(img, dw, dh)
    raise TypeError("resize: INTER_LINEAR takes uint8 or float32, got %s"
                    % img.dtype)


# -------------------------------------------------------------- fillPoly

def _clip_line(w, h, p1, p2):
    """cv2's clipLine on an image of w x h: the segment clipped to the
    image, and whether any of it is inside."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (x1, y1), (x2, y2), (c1 | c2) == 0


def _line8(img, p1, p2, color):
    """cv2's 8-connected Line (LineIterator, left to right) from p1 to p2,
    clipped to the image."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        p1, p2, inside = _clip_line(w, h, p1, p2)
        if not inside:
            return
    (x, y), (x2, y2) = p1, p2
    dx, dy = x2 - x, y2 - y
    if dx < 0:  # left to right
        x, y, dx, dy = x2, y2, -dx, -dy
    ystep = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += ystep
            x += 1 if minor else 0
        else:
            x += 1
            y += ystep if minor else 0


def _tdiv(a, b):
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_poly(img, polys, color):
    """`cv2.fillPoly(img, polys, color)` in place (8-connected, shift 0,
    no offset) on an (H, W) or (H, W, C) array; `polys` is a list of
    (N, 2) integer (x, y) vertex arrays.  Returns `img`."""
    h, w = img.shape[:2]
    one = 1 << _XY_SHIFT
    edges = []
    for poly in polys:
        pts = [(int(x), int(y)) for x, y in np.asarray(poly).reshape(-1, 2)]
        if not pts:
            continue
        p0 = pts[-1]
        for p1 in pts:
            # the edge's line, then its entry in the scan converter
            _line8(img, p0, p1, color)
            x0c, x1c = p0[0] << _XY_SHIFT, p1[0] << _XY_SHIFT
            y0c, y1c = p0[1], p1[1]
            if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h
                    and 0 <= p1[1] < h):
                t0, t1, _ = _clip_line(w, h, p0, p1)
                if t0[1] != t1[1]:
                    y0c, y1c = t0[1], t1[1]
                x0c, x1c = t0[0] << _XY_SHIFT, t1[0] << _XY_SHIFT
            if p0[1] != p1[1]:
                dx = _tdiv(x1c - x0c, y1c - y0c)
                if p0[1] < p1[1]:
                    edges.append([p0[1], p1[1], x0c + (p0[1] - y0c) * dx,
                                  dx])
                else:
                    edges.append([p1[1], p0[1], x1c + (p1[1] - y1c) * dx,
                                  dx])
            p0 = p1
    if len(edges) < 2:
        return img
    y_min = min(e[0] for e in edges)
    y_max = max(e[1] for e in edges)
    xs = [e[2] for e in edges] + [e[2] + (e[1] - e[0]) * e[3] for e in edges]
    if y_max < 0 or y_min >= h or max(xs) < 0 or min(xs) >= (w << _XY_SHIFT):
        return img
    edges.sort(key=lambda e: (e[0], e[2], e[3]))
    active, k = [], 0
    for y in range(edges[0][0], min(y_max, h)):
        active = [e for e in active if e[1] != y]
        while k < len(edges) and edges[k][0] == y:
            active.append(edges[k])
            k += 1
        active.sort(key=lambda e: e[2])
        for i in range(0, len(active) - 1, 2):
            left, right = active[i], active[i + 1]
            if y >= 0:
                xa, xb = sorted((left[2], right[2]))
                x1, x2 = (xa + one - 1) >> _XY_SHIFT, xb >> _XY_SHIFT
                if x1 < w and x2 >= 0:
                    img[y, max(x1, 0):min(x2, w - 1) + 1] = color
            left[2] += left[3]
            right[2] += right[3]
    return img


def poly_mask(poly, h, w):
    """(h, w) uint8 mask of one COCO polygon (flat [x0, y0, x1, y1, ...]),
    vertices rounded half to even as the reference's
    `np.round(pts).astype(np.int32)` (`mergenet_tpu/data/rle.py:170`)."""
    pts = np.round(np.asarray(poly, np.float64).reshape(-1, 2)).astype(
        np.int32)
    return fill_poly(np.zeros((h, w), np.uint8), [pts], 1)
