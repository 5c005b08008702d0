"""Instance-mask overlay (`mergenet_tpu.utils.visualization` is the
reference), bit-equal to it without cv2.

The reference blends a random colour per instance into the image and
writes each instance's id at its centroid with `cv2.putText`
(FONT_HERSHEY_SIMPLEX, scale 0.4, white, thickness 1, LINE_AA).  That
call's effect on a pixel is a fixed map from the old byte to the new
one, the same for each channel, and it does not depend on where the
text goes; a number is its digits drawn one after another, each 7
pixels right of the last.  `hershey_digits.npz` holds, per digit, the
touched pixels' offsets from the text origin (row, column) and their
256-entry maps, rendered once by cv2
(`tests/test_torch_port_visualization.py` renders them again and holds
the file equal to them).  Applying the maps in drawing order, clipped
to the image, gives cv2's bytes, labels at the borders included."""

import functools
import os

import numpy as np

from ..data import imgproc

#: horizontal advance of one digit at scale 0.4, in pixels
DIGIT_ADVANCE = 7
GLYPHS = os.path.join(os.path.dirname(__file__), "hershey_digits.npz")


@functools.lru_cache(maxsize=1)
def _glyphs():
    with np.load(GLYPHS) as z:
        return {d: (z["d%s_offsets" % d].astype(np.int64),
                    z["d%s_table" % d]) for d in "0123456789"}


def put_digits(img, text, origin):
    """Draw the digits of `text` into the (H, W, 3) uint8 `img` in place
    as `cv2.putText(img, text, origin, FONT_HERSHEY_SIMPLEX, 0.4, (255,
    255, 255), 1, LINE_AA)` does; `origin` is the (x, y) of the text's
    bottom-left corner."""
    glyphs = _glyphs()
    H, W = img.shape[:2]
    for i, ch in enumerate(text):
        off, table = glyphs[ch]
        y = origin[1] + off[:, 0]
        x = origin[0] + DIGIT_ADVANCE * i + off[:, 1]
        keep = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        y, x, table = y[keep], x[keep], table[keep]
        rows = np.arange(len(y))[:, None]
        img[y, x] = table[rows, img[y, x]]
    return img


def visualize_mask(img, mask, transparency=0.7, show_ids=True, seed=0):
    """Overlay an instance mask on an image.

    Args:
        img: (3, H, W) or (H, W, 3) float [0,1] or uint8 image.
        mask: (H, W) int instance ids, 0 = background.
        transparency: overlay alpha for non-background pixels.
    Returns:
        (H, W, 3) uint8 image."""
    img = np.asarray(img)
    mask = np.asarray(mask)
    if img.ndim == 3 and img.shape[0] == 3 and img.shape[-1] != 3:
        img = np.moveaxis(img, 0, -1)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    img = img.copy()
    H, W = mask.shape
    if img.shape[:2] != (H, W):
        img = imgproc.resize(img, (W, H))

    rng = np.random.RandomState(seed)
    n = int(mask.max())
    colors = rng.randint(0, 255, size=(n + 1, 3)).astype(np.uint8)
    overlay = colors[mask]
    fg = (mask > 0)[..., None]
    blended = np.where(
        fg,
        (img * (1 - transparency) + overlay * transparency).astype(np.uint8),
        img)

    if show_ids:
        for k in range(1, n + 1):
            ys, xs = np.nonzero(mask == k)
            if ys.size == 0:
                continue
            put_digits(blended, str(k), (int(xs.mean()), int(ys.mean())))
    return blended
