"""The port's overlay (`mergenet_tpu_torch/utils/visualization.py`)
against the reference's `visualize_mask`, which draws with cv2
(installed here, not on the GPU machine), bit for bit: random masks up
to 120 instances (3-digit ids), labels cut by each border, uint8 and
float (3, H, W) images, an image whose size differs from the mask's.
The committed glyph data is rendered again here with cv2 and must equal
the file."""

import cv2
import numpy as np
import pytest

from mergenet_tpu.utils.visualization import visualize_mask as ref_visualize
from mergenet_tpu_torch.utils import visualization as V


def render_glyph_tables(size=48, origin=(20, 30)):
    """Per digit: the offsets (row, column) from the text origin of every
    pixel `cv2.putText` changes, and each one's map from the old byte to
    the new (rendered on the 256 constant backgrounds)."""
    ox, oy = origin
    ident = np.arange(256, dtype=np.uint8)[:, None, None]
    out = {}
    for d in "0123456789":
        planes = np.empty((256, size, size), np.uint8)
        for v in range(256):
            img = np.full((size, size, 3), v, np.uint8)
            cv2.putText(img, d, origin, cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                        (255, 255, 255), 1, cv2.LINE_AA)
            assert (img == img[..., :1]).all()  # the same map per channel
            planes[v] = img[..., 0]
        ys, xs = np.nonzero((planes != ident).any(0))
        assert ys.min() > 0 and xs.min() > 0  # the canvas holds the glyph
        assert ys.max() < size - 1 and xs.max() < size - 1
        out["d%s_offsets" % d] = np.stack([ys - oy, xs - ox], 1).astype(
            np.int8)
        out["d%s_table" % d] = planes[:, ys, xs].T.copy()
    return out


def test_committed_glyphs_equal_a_fresh_cv2_render():
    fresh = render_glyph_tables()
    with np.load(V.GLYPHS) as z:
        assert sorted(z.files) == sorted(fresh)
        for k, v in fresh.items():
            assert z[k].dtype == v.dtype, k
            np.testing.assert_array_equal(z[k], v, err_msg=k)
    # the same maps at another origin: the glyphs do not move with it
    np.testing.assert_array_equal(render_glyph_tables(origin=(17, 33))[
        "d8_table"], fresh["d8_table"])


def test_put_digits_equals_cv2_at_every_border():
    rng = np.random.default_rng(0)
    H, W = 40, 60
    for t in range(400):
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        text = str(int(rng.integers(1, 10000)))
        org = (int(rng.integers(-30, W + 5)), int(rng.integers(-5, H + 12)))
        ref = img.copy()
        cv2.putText(ref, text, org, cv2.FONT_HERSHEY_SIMPLEX, 0.4,
                    (255, 255, 255), 1, cv2.LINE_AA)
        np.testing.assert_array_equal(V.put_digits(img, text, org), ref,
                                      err_msg=str((text, org)))


def _mask(rng, H, W, n):
    """Instance ids 1..n as rectangles, some at the borders, later ones
    on top; some ids end up fully covered (no label)."""
    m = np.zeros((H, W), np.int32)
    for k in range(1, n + 1):
        h, w = (int(v) for v in rng.integers(2, min(12, H, W), 2))
        y = int(rng.choice([0, H - h, rng.integers(0, H - h)]))
        x = int(rng.choice([0, W - w, rng.integers(0, W - w)]))
        m[y:y + h, x:x + w] = k
    return m


@pytest.mark.parametrize("kind", ["uint8", "float chw", "resized"])
def test_visualize_mask_equals_reference(kind):
    rng = np.random.default_rng({"uint8": 1, "float chw": 2,
                                 "resized": 3}[kind])
    for n, (H, W) in ((120, (72, 96)), (9, (30, 41)), (1, (8, 9)),
                      (0, (16, 16))):
        mask = _mask(rng, H, W, n)
        if kind == "uint8":
            img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        elif kind == "float chw":
            img = rng.random((3, H, W)).astype(np.float32) * 1.1 - 0.05
        else:
            img = rng.integers(0, 256, (H + 13, W - 3, 3)).astype(np.uint8)
        for alpha, ids in ((0.3, True), (0.7, False)):
            got = V.visualize_mask(img, mask, transparency=alpha,
                                   show_ids=ids, seed=n)
            ref = ref_visualize(img, mask, transparency=alpha,
                                show_ids=ids, seed=n)
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=str((n, kind)))
