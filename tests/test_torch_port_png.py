"""The port's PNG reader (`mergenet_tpu_torch/io.py`) on Adam7-interlaced
files, against cv2's libpng, which the JAX package reads PNGs with:
`io.read_png_rgb` and `imgproc.imread_rgb` bit for bit equal to
`cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`, and
`io.read_png_gray` to `cv2.imread(path, cv2.IMREAD_UNCHANGED)` (what the
Cityscapes converter reads instance ids with).

Files are written by `png_craft.write_png`: every colour type at every
bit depth, interlaced and not, sizes whose Adam7 passes are empty or
hold one pixel, seeded filter types per scanline, the data over two
IDAT chunks.  The non-interlaced colour types cv2 writes are held in
`test_torch_port_data_imgproc.py`."""

import cv2
import numpy as np
import pytest

from mergenet_tpu_torch import io
from mergenet_tpu_torch.data import imgproc
from png_craft import write_png

#: (colour type, bit depth) of every PNG the reader takes
TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
         (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
#: sizes (H, W): empty passes (1x1 has only pass 1), single rows and
#: columns, one full 8x8 tile, ragged edges
SIZES = [(1, 1), (1, 9), (9, 1), (2, 2), (5, 3), (8, 8), (13, 17), (33, 2)]


def _write(path, rng, color, depth, H, W, interlace):
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rng.integers(0, 1 << depth, (H, W, ch))
    palette = (rng.integers(0, 256, (1 << depth, 3)) if color == 3
               else None)
    write_png(path, samples, color, depth, interlace=interlace,
              palette=palette, rng=rng, idat_chunks=2)
    return samples


@pytest.mark.parametrize("color,depth", TYPES,
                         ids=["c%d-%dbit" % t for t in TYPES])
def test_adam7_reads_as_cv2(color, depth, tmp_path):
    rng = np.random.default_rng(color * 100 + depth)
    for H, W in SIZES:
        path = str(tmp_path / ("%dx%d.png" % (H, W)))
        samples = _write(path, rng, color, depth, H, W, interlace=True)
        ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(io.read_png_rgb(path), ref,
                                      err_msg=path)
        np.testing.assert_array_equal(imgproc.imread_rgb(path), ref)
        if color == 0:
            ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            got = io.read_png_gray(path)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
            if depth >= 8:
                np.testing.assert_array_equal(got, samples[..., 0])


@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
def test_read_png_gray_every_depth_as_cv2_unchanged(depth, tmp_path):
    """Grey at 1, 2 and 4 bits reads as libpng expands it for
    IMREAD_UNCHANGED (scaled to 0-255, uint8), at 8 and 16 bits
    unchanged; interlaced or not."""
    rng = np.random.default_rng(depth)
    for interlace in (False, True):
        path = str(tmp_path / ("g%d.png" % interlace))
        _write(path, rng, 0, depth, 19, 23, interlace)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        got = io.read_png_gray(path)
        assert got.dtype == ref.dtype == (np.uint16 if depth == 16
                                          else np.uint8)
        np.testing.assert_array_equal(got, ref)


def test_read_png_gray_refuses_colour_types_cv2_reads_with_channels(
        tmp_path):
    """cv2's IMREAD_UNCHANGED gives 3 or 4 channels for RGB, palette,
    grey + alpha and RGBA: not an instance-id map; refused, naming the
    file and the type."""
    rng = np.random.default_rng(3)
    for color, depth in ((2, 8), (3, 4), (4, 8), (6, 16)):
        path = str(tmp_path / ("c%d.png" % color))
        _write(path, rng, color, depth, 6, 7, interlace=True)
        assert cv2.imread(path, cv2.IMREAD_UNCHANGED).ndim == 3
        with pytest.raises(ValueError, match="colour type %d" % color) as e:
            io.read_png_gray(path)
        assert path in str(e.value)


def test_adam7_refusals_as_cv2(tmp_path):
    """Image data shorter than the seven passes' scanlines, and an
    unknown interlace method: cv2 returns None, the port raises."""
    import struct
    import zlib

    from png_craft import chunk
    rng = np.random.default_rng(4)
    path = str(tmp_path / "a.png")
    _write(path, rng, 2, 8, 9, 11, interlace=True)
    data = open(path, "rb").read()
    i = data.index(b"IDAT")
    raw = b""
    while i > 0:
        (n,) = struct.unpack(">I", data[i - 4:i])
        raw += data[i + 4:i + 4 + n]
        i = data.find(b"IDAT", i + 4 + n)
    short = zlib.compress(zlib.decompress(raw)[:-5])
    head = data[:data.index(b"IDAT") - 4]
    cases = {"Adam7-interlaced": head + chunk(b"IDAT", short)
             + chunk(b"IEND", b"")}
    bad = bytearray(data)
    bad[28] = 2  # interlace method 2, the IHDR CRC made right
    bad[29:33] = struct.pack(">I", zlib.crc32(bytes(bad[12:29])) & 0xFFFFFFFF)
    cases["unknown PNG interlace method 2"] = bytes(bad)
    for cause, blob in cases.items():
        with open(path, "wb") as f:
            f.write(blob)
        assert cv2.imread(path) is None
        with pytest.raises(ValueError, match=cause) as e:
            imgproc.imread_rgb(path)
        assert path in str(e.value)
