"""ctypes bridge to the port's JPEG decoder (`native/jpeg.cc`, written
from ITU-T T.81 for the port; no libjpeg is vendored or linked).

The reference reads images with `cv2.imread` (`mergenet_tpu/data/
dataset.py:190`, `:343`, `grain_pipeline.py:54`), whose libjpeg-turbo
decodes JPEG files; the GPU machine has no cv2, PIL or libjpeg.
`decode_jpeg` returns what `cv2.imdecode` then `cv2.cvtColor(img,
cv2.COLOR_BGR2RGB)` return, bit for bit, the EXIF orientation applied as
cv2 applies it, for every JPEG cv2 reads: baseline, extended-sequential
and progressive, Huffman- or arithmetic-coded, with 8-bit samples;
lossless Huffman (RGB or CMYK, 2- to 8-bit samples); grey, YCbCr, RGB,
and 4-component Adobe CMYK or YCCK.  What cv2 refuses (12-bit samples,
2 components, lossless files that need a colour conversion, lossless
arithmetic coding, hierarchical files) raises, as do truncated and
corrupt data.  `native/jpeg.cc`'s header says which of libjpeg-turbo's
computations it follows, and holds the table of what cv2 reads.

The shared library is built with g++ at the first call, never at import,
into `mergenet_tpu_torch/_build/` by `_host_build.build` (named by a
hash of the source and flags); a failed build raises with g++'s
stderr."""

import ctypes
import os
import threading

import numpy as np

from .. import _host_build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                   "jpeg.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path():
    return _host_build.library_path(SRC, CXX_FLAGS)


def build():
    """Compile native/jpeg.cc unless its library exists; returns the
    library's path."""
    return _host_build.build(SRC, CXX_FLAGS)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.mn_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p), ip,
                ip, ip, ctypes.c_char_p, ctypes.c_int]
            lib.mn_jpeg_decode.restype = ctypes.c_int
            lib.mn_jpeg_free.argtypes = [u8p]
            lib.mn_jpeg_free.restype = None
            _lib = lib
    return _lib


def orient(img, orientation):
    """`img` turned as cv2's ExifTransform turns it for an EXIF
    orientation (1-8; anything else leaves it as it is)."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        img = img[:, ::-1]
    elif orientation == 3:
        img = img[::-1, ::-1]
    elif orientation == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data, name="JPEG data"):
    """(H, W, 3) uint8 RGB of the JPEG file held in `data` (bytes), EXIF
    orientation applied.  Raises ValueError, naming `name` and the
    cause, on data it does not decode."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_uint8)()
    h, w, o = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    if lib.mn_jpeg_decode(data, len(data), ctypes.byref(out),
                          ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(o), err, len(err)):
        raise ValueError("%s: %s" % (name, err.value.decode()))
    try:
        img = np.ctypeslib.as_array(out, (h.value, w.value, 3)).copy()
    finally:
        lib.mn_jpeg_free(out)
    return orient(img, o.value)
