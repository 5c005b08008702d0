"""The port's cv2 operations (`mergenet_tpu_torch/data/imgproc.py`, the
PNG reader in `io.py`) held against cv2 itself, bit for bit, with no
tolerance: `cv2.resize` INTER_LINEAR on uint8 (the loaders' image
resize, `mergenet_tpu/data/dataset.py:78`) and float32
(`data_io.py:150`), INTER_NEAREST on integer masks (`dataset.py:79`),
`cv2.fillPoly` (`rle.py:170`), and `cv2.imread` + BGR->RGB on PNGs of
every colour type and filter cv2 or PIL writes.  cv2 and PIL are
installed here, not on the GPU machine: the port uses neither."""

import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

from mergenet_tpu_torch import io
from mergenet_tpu_torch.data import imgproc


def _sizes(rng, n, lo=1, hi=90):
    return [tuple(int(v) for v in rng.integers(lo, hi, 4)) for _ in range(n)]


#: (H, W) -> (h, w): the recipes' integer downscales (x2 of
#: run_pspfpnet_crop.sh, x3), an x2 upscale (scale 0.5), odd sizes
LINEAR_CASES = [((64, 128), (32, 64)), ((63, 127), (31, 63)),
                ((96, 150), (32, 50)), ((40, 60), (80, 120)),
                ((512, 1024), (256, 512)), ((37, 53), (18, 26)),
                ((33, 71), (66, 142)), ((100, 100), (37, 61))]


@pytest.mark.parametrize("src,dst", LINEAR_CASES)
def test_resize_linear_uint8_equals_cv2(src, dst):
    rng = np.random.default_rng(src[0] * 7 + dst[1])
    for shape in (src + (3,), src):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        ref = cv2.resize(img, dst[::-1])
        got = imgproc.resize(img, dst[::-1])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_resize_linear_uint8_random_sizes_equal_cv2():
    rng = np.random.default_rng(1)
    for H, W, h, w in _sizes(rng, 150):
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.resize(img, (w, h)),
                                      cv2.resize(img, (w, h)),
                                      err_msg=str((H, W, h, w)))


def test_resize_linear_float32_equals_cv2():
    """Every single-channel case, and multi-channel ones that do not
    widen the image (the two cases cv2 computes another way are the
    strict xfail below)."""
    rng = np.random.default_rng(2)
    cases = [(H, W, h, w, 1) for H, W, h, w in _sizes(rng, 80, lo=2)]
    cases += [(H, W, h, min(w, W), 3) for H, W, h, w in _sizes(rng, 80,
                                                                lo=2)]
    cases += [(512, 1024, 256, 256, 3), (64, 64, 32, 32, 3),
              (45, 60, 512, 512, 1), (1024, 2048, 512, 1024, 3)]
    for H, W, h, w, cn in cases:
        img = (rng.random((H, W, cn)) * 255).astype(np.float32)
        np.testing.assert_array_equal(imgproc.resize(img, (w, h)),
                                      cv2.resize(img, (w, h)),
                                      err_msg=str((H, W, h, w, cn)))


@pytest.mark.xfail(strict=True, reason=(
    "float32 INTER_LINEAR that widens a multi-channel image, or from a "
    "source with a single row or column: cv2 5.0 differs by an ulp at "
    "some pixels there (ROADMAP.md section 3)"))
@pytest.mark.parametrize("case", ["3 channels widened", "single row"])
def test_resize_linear_float32_cases_cv2_computes_otherwise(case):
    rng = np.random.default_rng(8)
    if case == "single row":
        img, size = np.full((1, 1), 100.3, np.float32), (6, 94)
    else:
        img = (rng.random((10, 3, 3)) * 255).astype(np.float32)
        size = (75, 77)
    np.testing.assert_array_equal(imgproc.resize(img, size),
                                  cv2.resize(img, size))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
def test_resize_nearest_equals_cv2(dtype):
    rng = np.random.default_rng(3)
    hi = 250 if dtype == np.uint8 else 60000
    cases = _sizes(rng, 100) + [(512, 1024, 256, 512), (513, 1025, 171, 341),
                                (1024, 2048, 341, 682)]
    for H, W, h, w in cases:
        m = rng.integers(0, hi, (H, W)).astype(dtype)
        ref = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
        got = imgproc.resize(m, (w, h), interpolation=imgproc.INTER_NEAREST)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref, err_msg=str((H, W, h, w)))


def _polygons(rng, n):
    """Random (H, W, (N, 2) int32 points, kind): inside the image, reaching
    past it, star-shaped (concave), and degenerate (collinear, repeated,
    one or two points)."""
    for t in range(n):
        H, W = (int(v) for v in rng.integers(5, 90, 2))
        k = int(rng.integers(1, 12))
        kind = ("inside", "outside", "concave", "degenerate")[t % 4]
        if kind == "inside":
            pts = np.stack([rng.integers(0, W, k), rng.integers(0, H, k)], 1)
        elif kind == "outside":
            pts = np.stack([rng.integers(-20, W + 20, k),
                            rng.integers(-20, H + 20, k)], 1)
        elif kind == "concave":
            ang = np.sort(rng.random(k) * 2 * np.pi)
            r = rng.random(k) * min(H, W) / 2
            pts = np.stack([W / 2 + r * np.cos(ang),
                            H / 2 + r * np.sin(ang)], 1).round()
        else:
            x, y, s = rng.integers(0, W, 2), rng.integers(0, H, 2), \
                rng.random(k)
            pts = np.stack([x[0] + s * (x[1] - x[0]),
                            y[0] + s * (y[1] - y[0])], 1).round()
        yield H, W, pts.astype(np.int32), kind


def test_fill_poly_equals_cv2():
    rng = np.random.default_rng(4)
    kinds = set()
    for H, W, pts, kind in _polygons(rng, 1200):
        ref = cv2.fillPoly(np.zeros((H, W), np.uint8), [pts], 1)
        got = imgproc.fill_poly(np.zeros((H, W), np.uint8), [pts], 1)
        np.testing.assert_array_equal(got, ref, err_msg=str(
            (kind, H, W, pts.tolist())))
        kinds.add(kind)
    assert len(kinds) == 4


def test_fill_poly_several_contours_and_colours_equal_cv2():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 5, (70, 90, 3)).astype(np.uint8)
    polys = [np.array([[5, 5], [60, 8], [30, 50]], np.int32),
             np.array([[40, 20], [85, 60], [10, 66], [50, 40]], np.int32)]
    ref = cv2.fillPoly(img.copy(), polys, (9, 200, 31))
    got = imgproc.fill_poly(img.copy(), polys, (9, 200, 31))
    np.testing.assert_array_equal(got, ref)


def test_poly_mask_rounds_as_the_reference():
    """COCO polygons are floats: the reference rounds half to even
    (`np.round`) before cv2.fillPoly."""
    poly = [2.5, 3.5, 40.5, 7.49, 21.2, 30.5, 3.5, 18.0]
    pts = np.round(np.asarray(poly).reshape(-1, 2)).astype(np.int32)
    ref = cv2.fillPoly(np.zeros((35, 45), np.uint8), [pts], 1)
    np.testing.assert_array_equal(imgproc.poly_mask(poly, 35, 45), ref)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)


PNG_PARAMS = ([[cv2.IMWRITE_PNG_COMPRESSION, c] for c in (0, 1, 6, 9)]
              + [[cv2.IMWRITE_PNG_STRATEGY, getattr(
                  cv2, "IMWRITE_PNG_STRATEGY_" + s)] for s in (
                  "DEFAULT", "FILTERED", "HUFFMAN_ONLY", "RLE", "FIXED")]
              + [[cv2.IMWRITE_PNG_FILTER, getattr(
                  cv2, "IMWRITE_PNG_FILTER_" + f)] for f in (
                  "NONE", "SUB", "UP", "AVG", "PAETH")])


def test_read_png_equals_cv2_over_levels_strategies_and_filters(tmp_path):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    img[5:15, 5:20] = (77, 3, 250)  # flat runs: other filters win there
    path = str(tmp_path / "f.png")
    filters = set()
    for params in PNG_PARAMS:
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR), params)
        got = io.read_png_rgb(path)
        np.testing.assert_array_equal(got, _cv2_rgb(path), err_msg=str(
            params))
        np.testing.assert_array_equal(got, img)
        filters |= _filter_types(path)
    assert filters == {0, 1, 2, 3, 4}


def _filter_types(path):
    import zlib
    data = open(path, "rb").read()
    W, H = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    return {raw[i * (W * 3 + 1)] for i in range(H)}


def test_read_png_colour_types_equal_cv2(tmp_path):
    """Grey, RGBA and 16-bit (cv2), grey + alpha, palette (8-, 4- and
    2-bit) and 1-bit grey (PIL, cv2's bilevel): read as cv2 reads them."""
    rng = np.random.default_rng(7)
    made = {
        "rgb16": lambda p: cv2.imwrite(p, rng.integers(
            0, 65536, (9, 13, 3)).astype(np.uint16)),
        "grey8": lambda p: cv2.imwrite(p, rng.integers(
            0, 256, (9, 13)).astype(np.uint8)),
        "grey16": lambda p: cv2.imwrite(p, rng.integers(
            0, 65536, (9, 13)).astype(np.uint16)),
        "rgba8": lambda p: cv2.imwrite(p, rng.integers(
            0, 256, (9, 13, 4)).astype(np.uint8)),
        "rgba16": lambda p: cv2.imwrite(p, rng.integers(
            0, 65536, (9, 13, 4)).astype(np.uint16)),
        "bilevel": lambda p: cv2.imwrite(p, (rng.random((9, 13)) > 0.5)
                                         .astype(np.uint8) * 255,
                                         [cv2.IMWRITE_PNG_BILEVEL, 1]),
        "grey_alpha": lambda p: Image.fromarray(rng.integers(
            0, 256, (9, 11, 2)).astype(np.uint8), "LA").save(p),
        "palette8": lambda p: Image.fromarray(rng.integers(
            0, 256, (19, 21, 3)).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE, colors=200).save(p),
        "palette4": lambda p: Image.fromarray(rng.integers(
            0, 256, (9, 11, 3)).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE, colors=13).save(p),
        "palette2": lambda p: Image.fromarray(rng.integers(
            0, 256, (9, 11, 3)).astype(np.uint8)).convert(
            "P", palette=Image.ADAPTIVE, colors=4).save(p, bits=2),
        "grey1": lambda p: Image.fromarray(rng.random((9, 19)) > 0.5).save(p),
    }
    seen = set()
    for name, write in made.items():
        path = str(tmp_path / (name + ".png"))
        write(path)
        with open(path, "rb") as f:
            depth, color = struct.unpack(">BB", f.read(26)[24:26])
        seen.add((color, depth))
        np.testing.assert_array_equal(imgproc.imread_rgb(path),
                                      _cv2_rgb(path), err_msg=name)
    assert {(0, 1), (0, 8), (0, 16), (2, 16), (3, 2), (3, 4), (3, 8),
            (4, 8), (6, 8), (6, 16)} <= seen


def test_imread_refuses_jpeg_and_interlaced_png(tmp_path):
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="JPEG"):
        imgproc.imread_rgb(jpg)
    png = str(tmp_path / "i.png")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png)
    data = bytearray(open(png, "rb").read())
    data[28] = 1  # IHDR interlace method: Adam7
    open(png, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        io.read_png_rgb(png)
    assert os.path.exists(png)
