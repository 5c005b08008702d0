"""ctypes bridge to the native C++ greedy merge decoder
(`mergenet_tpu/decoder/csegment.py` is the reference; `native/segment.cc`
is a copy of its source).

The shared library is built with g++ at the first call, never at import,
into `mergenet_tpu_torch/_build/` under a name made from a hash of the
source and the flags, so a changed source rebuilds and an unchanged one
is reused; a failed build raises with g++'s stderr.

Public surface (signature parity with the reference):
    run_segmentation(class_pred, adj_pred, num_classes, offset_list,
                     same_different_bias, object_merge_factor,
                     merge_logprob_bias, ...) -> (mask, object_class)
    run_segmentation_batch(...) -> (masks, object_classes)
"""

import ctypes
import os
import threading

import numpy as np

from .. import _host_build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "segment.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None


def library_path():
    return _host_build.library_path(_SRC, CXX_FLAGS)


def build():
    """Compile native/segment.cc unless the library for the current
    source exists.  Returns its path."""
    return _host_build.build(_SRC, CXX_FLAGS)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.mn_run_segmentation.argtypes = [
            f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, intp, i32p, i32p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.mn_run_segmentation.restype = None
        lib.mn_run_segmentation_batch.argtypes = [
            f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, intp, i32p, i32p,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int]
        lib.mn_run_segmentation_batch.restype = None
        _lib = lib
        return lib


_DEN_MODES = {"sum": 0, "product": 1}
_REMERGE_MODES = {"eq": 0, "ge": 1}


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _classes(row):
    """The class ids before the first -1 of an object_class row."""
    end = np.flatnonzero(row == -1)
    return [int(v) for v in row[:end[0] if len(end) else len(row)]]


def run_segmentation(class_pred, adj_pred, num_classes, offset_list,
                     same_different_bias=0.0, object_merge_factor=1.0,
                     merge_logprob_bias=0.0, den_mode="sum",
                     remerge_mode="eq", do_prune=False,
                     prune_threshold=200.0):
    """Decode one image on the host C++ decoder.

    Args:
        class_pred: (num_classes, H, W) float array of class probabilities.
        adj_pred:   (num_offsets, H, W) float array of sameness probabilities.
        num_classes, offset_list: model configuration.
        remaining args: segmenter hyperparameters (see SegmenterOptions).
        Defaults reproduce the reference Cityscapes recipe: 'sum'
        denominator, bias outside the division, merge on exact re-pop
        equality, no prune.

    Returns:
        (mask, object_class): (H, W) int32 instance mask with ids 1..K and a
        length-K list of class ids.
    """
    lib = _load()
    class_pred = np.ascontiguousarray(class_pred, dtype=np.float32)
    adj_pred = np.ascontiguousarray(adj_pred, dtype=np.float32)
    C, H, W = class_pred.shape
    O = adj_pred.shape[0]
    if C != num_classes or O != len(offset_list) \
            or adj_pred.shape[1:] != (H, W):
        raise ValueError("class_pred %s / adj_pred %s do not match "
                         "num_classes=%d and %d offsets" % (
                             class_pred.shape, adj_pred.shape, num_classes,
                             len(offset_list)))
    offsets = np.ascontiguousarray(offset_list, dtype=np.intc)
    mask = np.zeros((H, W), dtype=np.int32)
    object_class = np.full(H * W, -1, dtype=np.int32)
    lib.mn_run_segmentation(
        _ptr(class_pred, ctypes.c_float), C, _ptr(adj_pred, ctypes.c_float),
        O, H, W, _ptr(offsets, ctypes.c_int), _ptr(mask, ctypes.c_int32),
        _ptr(object_class, ctypes.c_int32), float(same_different_bias),
        float(object_merge_factor), float(merge_logprob_bias),
        _DEN_MODES[den_mode], _REMERGE_MODES[remerge_mode], int(do_prune),
        float(prune_threshold))
    return mask, _classes(object_class)


def run_segmentation_batch(class_pred, adj_pred, num_classes, offset_list,
                           same_different_bias=0.0, object_merge_factor=1.0,
                           merge_logprob_bias=0.0, den_mode="sum",
                           remerge_mode="eq", do_prune=False,
                           prune_threshold=200.0, num_threads=0):
    """Decode a batch (B, C, H, W)/(B, O, H, W); one host thread per image.

    Returns (masks, object_classes): (B, H, W) int32 and a list of B lists.
    """
    lib = _load()
    class_pred = np.ascontiguousarray(class_pred, dtype=np.float32)
    adj_pred = np.ascontiguousarray(adj_pred, dtype=np.float32)
    B, C, H, W = class_pred.shape
    O = adj_pred.shape[1]
    if C != num_classes or O != len(offset_list) \
            or adj_pred.shape != (B, O, H, W):
        raise ValueError("class_pred %s / adj_pred %s do not match "
                         "num_classes=%d and %d offsets" % (
                             class_pred.shape, adj_pred.shape, num_classes,
                             len(offset_list)))
    offsets = np.ascontiguousarray(offset_list, dtype=np.intc)
    masks = np.zeros((B, H, W), dtype=np.int32)
    object_class = np.full((B, H * W), -1, dtype=np.int32)
    lib.mn_run_segmentation_batch(
        _ptr(class_pred, ctypes.c_float), C, _ptr(adj_pred, ctypes.c_float),
        O, B, H, W, _ptr(offsets, ctypes.c_int), _ptr(masks, ctypes.c_int32),
        _ptr(object_class, ctypes.c_int32), float(same_different_bias),
        float(object_merge_factor), float(merge_logprob_bias),
        _DEN_MODES[den_mode], _REMERGE_MODES[remerge_mode], int(do_prune),
        float(prune_threshold), int(num_threads))
    return masks, [_classes(row) for row in object_class]
