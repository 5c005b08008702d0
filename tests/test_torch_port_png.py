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
`test_torch_port_data_imgproc.py`.

The eXIf chunk: orientations 1-8 (and none) in both byte orders, before
and after IDAT, on every colour type, against cv2 (which turns the image
for IMREAD_COLOR and not for IMREAD_UNCHANGED); which of several eXIf
chunks libpng keeps and how OpenCV's ExifReader walks IFD0.  (The JAX
package's datasets on a split of eXIf-turned PNGs are held in
`test_torch_port_containers.py`.)"""

import cv2
import numpy as np
import pytest

from mergenet_tpu_torch import io
from mergenet_tpu_torch.data import imgproc
from png_craft import chunk, exif_tiff, write_png

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


# -------------------------------------------------------------------- eXIf

def _orient_chunk(o, big_endian=False):
    return chunk(b"eXIf", exif_tiff([(0x0112, 3, o)], big_endian))


@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_as_cv2(orientation, big_endian, tmp_path):
    """cv2.imread turns a PNG by its eXIf orientation, before or after
    IDAT, whatever the colour type; IMREAD_UNCHANGED leaves it, and so
    does read_png_gray."""
    rng = np.random.default_rng(orientation * 2 + big_endian)
    c = [_orient_chunk(orientation, big_endian)]
    for color, depth in TYPES:
        for where in ("before", "after"):
            path = str(tmp_path / ("o%d_%d_%s.png" % (color, depth, where)))
            ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
            pal = rng.integers(0, 256, (1 << depth, 3)) if color == 3 \
                else None
            write_png(path, rng.integers(0, 1 << depth, (5, 7, ch)), color,
                      depth, palette=pal, rng=rng, **{where: c})
            ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            np.testing.assert_array_equal(io.read_png_rgb(path), ref,
                                          err_msg=path)
            np.testing.assert_array_equal(imgproc.imread_rgb(path), ref)
            if color == 0:
                ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
                assert ref.shape == (5, 7)
                np.testing.assert_array_equal(io.read_png_gray(path), ref)


def test_exif_chunk_libpng_keeps_and_entries_cv2_reads(tmp_path):
    """libpng keeps the first eXIf chunk of at least 4 bytes that starts
    II*\\0 or MM\\0* and has a good CRC (a later one is a duplicate,
    before or after IDAT); OpenCV's ExifReader takes IFD0's first
    Orientation entry, walks entries past the count as long as their tags
    are inside the data, and keeps nothing when one runs past it."""
    o = lambda v: (0x0112, 3, v)  # noqa: E731
    other = (0x0100, 3, 5)
    bad_crc = bytearray(_orient_chunk(6))
    bad_crc[-1] ^= 1
    cases = {
        "first wins": ([_orient_chunk(3), _orient_chunk(6)], []),
        "before beats after": ([_orient_chunk(3)], [_orient_chunk(6)]),
        "none, then a duplicate": ([_orient_chunk(0), _orient_chunk(6)], []),
        "Exif prefix invalid": ([chunk(b"eXIf", b"Exif\0\0"
                                       + exif_tiff([o(6)]))], []),
        "invalid, then good": ([chunk(b"eXIf", b"IM" + exif_tiff([o(6)])[
            2:]), _orient_chunk(3)], []),
        "3 bytes, then good": ([chunk(b"eXIf", b"II*"), _orient_chunk(3)],
                               []),
        "header only, then dup": ([chunk(b"eXIf", b"II*\0"),
                                   _orient_chunk(3)], []),
        "bad CRC, then good": ([bytes(bad_crc), _orient_chunk(3)], []),
        "empty IFD0": ([chunk(b"eXIf", exif_tiff([]))], []),
        "two entries": ([chunk(b"eXIf", exif_tiff([o(6), o(3)]))], []),
        "after another tag": ([chunk(b"eXIf", exif_tiff([other, o(7)]))],
                              []),
        "count past the entries": ([chunk(b"eXIf", exif_tiff(
            [o(6)], count=2))], []),
        "count far past": ([chunk(b"eXIf", exif_tiff([o(6)], count=9))],
                           []),
        "entry cut": ([chunk(b"eXIf", exif_tiff([o(6)])[:16])], []),
        "MM, LONG type": ([chunk(b"eXIf", exif_tiff([(0x0112, 4, 0)], True)
                                 )], []),
        "IFD past the end": ([chunk(b"eXIf", b"II*\0\xff\0\0\0")], []),
    }
    rng = np.random.default_rng(9)
    for k, (before, after) in enumerate(cases.values()):
        path = str(tmp_path / ("e%d.png" % k))
        write_png(path, rng.integers(0, 256, (4, 6, 3)), 2, 8,
                  before=before, after=after)
        ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(io.read_png_rgb(path), ref,
                                      err_msg=list(cases)[k])
