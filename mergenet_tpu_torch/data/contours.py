"""`cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[0]`
in numpy and Python, bit for bit.

The reference's Cityscapes converter traces each instance's visible mask
with it (`egs/cityscape/local/convert_cityscapes_to_coco.py:75-76`); the
GPU machine has no cv2.  This is Suzuki and Abe's border following as
OpenCV writes it (`modules/imgproc/src/contours.cpp`, `icvFetchContour`
with `method == 0`, and the raster scan of `cvFindNextContour`):

- foreground is any nonzero pixel, 8-connected, on a one-pixel zero
  frame;
- the raster scan meets an outer border where a 0 is followed by a
  pixel still 1 (not yet traced).  Under RETR_EXTERNAL the border is
  traced only if the last traced pixel before it on its row (`lnbd`,
  the frame if none) is not a plain border pixel: so a component inside
  a hole of another is dropped, and holes are never traced;
- the first neighbour of the start pixel is searched clockwise from
  direction 4 (left), chain codes 0 = +x, 1 = (+x, -y), 2 = -y, ...,
  7 = (+x, +y); each step searches counter-clockwise from one past the
  direction back to the pixel it came from.  A visited pixel whose
  search passed its east 0-neighbour is marked right-bound (`2 | -128`
  as a signed char), any other still-1 pixel is marked 2;
- the trace ends on returning to the start pixel from its first
  neighbour, so every point is listed, repeated ones included (a 1x3
  line traces out and back); a lone pixel is a 1-point contour;
- the contours come out in reverse order of discovery, each an
  `(N, 1, 2)` int32 array of (x, y).

Only the mask's bounding box plus a one-pixel frame is scanned: the rows
and columns outside it hold no border and do not change the scan.  The
scan jumps between the row's value changes with numpy; tracing is a
Python loop over border pixels."""

import numpy as np

#: chain code -> step: 0 = +x, 1 = (+x, -y), 2 = -y, ..., 7 = (+x, +y)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)

#: OpenCV's marks of a traced pixel: `nbd` = 2, and `nbd | -128` as a
#: signed char for a right-bound one
_MARK = 2
_MARK_RIGHT = 2 - 128


def _trace(flat, start, deltas, w):
    """Follow the outer border from flat index `start`, marking it in
    `flat` (int8, framed); returns its (N, 2) points in framed (x, y)."""
    s = 4
    while True:  # first neighbour, clockwise from the left
        s = (s - 1) & 7
        if flat[start + deltas[s]] != 0 or s == 4:
            break
    if s == 4:  # a lone pixel
        flat[start] = _MARK_RIGHT
        return [(start % w, start // w)]
    first = start + deltas[s]
    pts = []
    cur = start
    while True:
        s_end = s
        while s < 15:
            s += 1
            nxt = cur + deltas[s]
            if flat[nxt] != 0:
                break
        s &= 7
        if 0 < s <= s_end:
            flat[cur] = _MARK_RIGHT
        elif flat[cur] == 1:
            flat[cur] = _MARK
        pts.append((cur % w, cur // w))
        if nxt == start and cur == first:
            return pts
        cur = nxt
        s = (s + 4) & 7


def find_contours_external(mask):
    """The outer borders of `mask`'s 8-connected components (any nonzero
    pixel), as `cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_NONE)[0]` returns them: a list of (N, 1, 2) int32
    arrays of (x, y), the last border found in raster order first;
    components inside another's hole are left out."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError("find_contours_external takes an (H, W) mask, got "
                         "shape %s" % (mask.shape,))
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return []
    oy, ox = int(ys.min()), int(xs.min())
    crop = mask[oy:int(ys.max()) + 1, ox:int(xs.max()) + 1] != 0
    h, w = crop.shape[0] + 2, crop.shape[1] + 2
    img = np.zeros((h, w), np.int8)
    img[1:-1, 1:-1] = crop
    flat = img.reshape(-1)
    deltas = [dx + dy * w for dx, dy in zip(_DX, _DY)] * 2
    found = []
    for y in range(1, h - 1):
        row = img[y]
        x, lnbd = 1, 0
        while x < w:
            # the row's next value changes, from x on, with its values now
            steps = np.flatnonzero(row[x:] != row[x - 1:-1]) + x
            traced = False
            for x in steps.tolist():
                p, prev = int(row[x]), int(row[x - 1])
                if prev == 0 and p == 1 and row[lnbd] <= 0:
                    pts = _trace(flat, y * w + x, deltas, w)
                    found.append(np.asarray(pts, np.int32).reshape(-1, 1, 2))
                    lnbd, traced = x, True
                    break
                if p & -2:
                    lnbd = x
            if not traced:
                break
            x += 1
    offset = np.asarray([ox - 1, oy - 1], np.int32)
    return [c + offset for c in reversed(found)]
