"""ctypes bridge to the byte-level decompressors of the port's raster
readers (`native/codecs.cc`): TIFF LZW (new and old style), GIF LZW,
PackBits, TIFF's horizontal predictor, CCITT fax (Modified Huffman,
T.4, T.6), ThunderScan and SGILog (LogL, LogLuv, LogLuv24), BMP RLE8/RLE4 and Radiance HDR's run-length
scanlines.  (Sun raster's byte encoding needs no decoder:
cv2 refuses byte-encoded files, and `sunras.py` with it.)  The containers
themselves (`tiff.py`, `bmp.py`, `pxm.py`, `sunras.py`, `hdr.py`,
`gif.py`) are parsed in Python.

The shared library is built with g++ at the first call, never at import,
into `mergenet_tpu_torch/_build/` by `_host_build.build`; a failed build
raises with g++'s stderr.  Every decoder checks its bounds and raises
ValueError, naming `name` and the cause, on data that runs short or is
corrupt."""

import ctypes
import os
import threading

import numpy as np

from .. import _host_build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                   "codecs.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None

_BYTES = ctypes.c_char_p
_OUT = ctypes.c_void_p
_SIZE = ctypes.c_size_t
_INT = ctypes.c_int
_ERR = (ctypes.c_char_p, ctypes.c_int)
_SIGNATURES = {
    "mn_tiff_lzw": (ctypes.c_long, [_BYTES, _SIZE, _OUT, _SIZE, *_ERR]),
    "mn_gif_lzw": (ctypes.c_long, [_BYTES, _SIZE, _INT, _OUT, _SIZE, *_ERR]),
    "mn_packbits": (ctypes.c_long, [_BYTES, _SIZE, _OUT, _SIZE, *_ERR]),
    "mn_tiff_unpredict": (None, [_OUT, _SIZE, _SIZE, _INT, _INT, _INT]),
    "mn_bmp_rle": (_INT, [_BYTES, _SIZE, _INT, _INT, _INT, _OUT, *_ERR]),
    "mn_hdr_rle": (_INT, [_BYTES, _SIZE, _INT, _INT, _OUT, *_ERR]),
    "mn_tiff_fax": (_INT, [_BYTES, _SIZE, _SIZE, _INT, _INT, _INT, _INT,
                           _INT, _OUT, *_ERR]),
    "mn_tiff_thunder": (_INT, [_BYTES, _SIZE, _INT, _INT, _OUT, *_ERR]),
    "mn_tiff_sgilog": (_INT, [_BYTES, _SIZE, _INT, _INT, _INT, _OUT,
                              *_ERR]),
}


def library_path():
    return _host_build.library_path(SRC, CXX_FLAGS)


def build():
    """Compile native/codecs.cc unless its library exists; returns the
    library's path."""
    return _host_build.build(SRC, CXX_FLAGS)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn, (res, args) in _SIGNATURES.items():
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _lib = lib
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _call(name, fn, *args):
    err = ctypes.create_string_buffer(256)
    r = fn(*args, err, len(err))
    if (r < 0) if fn.restype is ctypes.c_long else (r != 0):
        raise ValueError("%s: %s" % (name, err.value.decode()))
    return r


def tiff_lzw(data, size, name="TIFF"):
    """`size` bytes of TIFF LZW data (a strip or tile)."""
    out = np.zeros(size, np.uint8)
    lib = _load()
    n = _call(name, lib.mn_tiff_lzw, data, len(data), _ptr(out), size)
    if n != size:
        raise ValueError("%s: LZW data ends after %d of %d bytes"
                         % (name, n, size))
    return out


def gif_lzw(data, min_bits, size, name="GIF"):
    """(decoded bytes, count) of GIF LZW data, at most `size` of them."""
    out = np.zeros(size, np.uint8)
    lib = _load()
    n = _call(name, lib.mn_gif_lzw, data, len(data), min_bits, _ptr(out),
              size)
    return out, n


def packbits(data, size, name="TIFF"):
    out = np.zeros(size, np.uint8)
    lib = _load()
    _call(name, lib.mn_packbits, data, len(data), _ptr(out), size)
    return out


def tiff_unpredict(buf, rows, row_samples, spp, nbytes, big_endian):
    """Undo predictor 2 in place on a contiguous uint8 buffer of `rows`
    rows of `row_samples` samples of `nbytes` (1 or 2) bytes."""
    _load().mn_tiff_unpredict(_ptr(buf), rows, row_samples, spp, nbytes,
                              int(big_endian))
    return buf


def bmp_rle(data, bpp, width, height, name="BMP"):
    """(height, width) palette indices of BMP RLE8/RLE4 data, the first
    decoded row first."""
    out = np.zeros((height, width), np.uint8)
    lib = _load()
    _call(name, lib.mn_bmp_rle, data, len(data), bpp, width, height,
          _ptr(out))
    return out


def hdr_rle(data, width, height, name="HDR"):
    """(height, width, 4) RGBE bytes of Radiance scanlines."""
    out = np.zeros((height, width, 4), np.uint8)
    lib = _load()
    _call(name, lib.mn_hdr_rle, data, len(data), width, height, _ptr(out))
    return out


def tiff_fax(data, file_offset, scheme, options, fill_order, width, rows,
             name="TIFF"):
    """`rows` rows of `width` 1-bit pixels (1 black, rows padded to a
    byte) of one strip or tile of CCITT data: `scheme` 2, 3, 4 or 32771
    (the TIFF compression), `options` T4Options, `file_offset` where the
    data starts in the file (libtiff aligns 32771's rows to 16 bits of
    the file)."""
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    _call(name, _load().mn_tiff_fax, data, len(data), file_offset, scheme,
          options, fill_order, width, rows, _ptr(out))
    return out


def tiff_thunder(data, width, rows, name="TIFF"):
    """`rows` rows of `width` 4-bit pixels (two to a byte) of ThunderScan
    data."""
    out = np.zeros(rows * ((width + 1) // 2), np.uint8)
    _call(name, _load().mn_tiff_thunder, data, len(data), width, rows,
          _ptr(out))
    return out


def tiff_sgilog(data, width, rows, kind, name="TIFF"):
    """`rows` rows of `width` pixels of SGILog data as libtiff's 8-bit
    output gives them: grey bytes (kind 0, LogL) or RGB triples (kind 1,
    LogLuv; kind 2, SGILog24's LogLuv)."""
    out = np.zeros(rows * width * (3 if kind else 1), np.uint8)
    _call(name, _load().mn_tiff_sgilog, data, len(data), width, rows, kind,
          _ptr(out))
    return out
