"""Build and bind the CUDA kernels of `csrc/`.

One `nvcc -c` per `csrc/*.cu`, all started together, then one link,
make one shared library with a plain C interface (no PyTorch headers,
so the build takes seconds), written under `mergenet_tpu_torch/_build/`
and named by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one is reused.  The library is loaded with
ctypes; every entry point returns `cudaGetLastError()` and `check()`
raises on a non-zero code.

`LAUNCHES` counts kernel launches per wrapper: each wrapper adds one
where it launches its kernel and nowhere else.  A process started with
`MERGENET_LAUNCH_LOG=<file>` in its environment appends its counts to
that file as one JSON line when it exits (how a parent process counts
the launches of the recipes it runs as subprocesses)."""

import atexit
import collections
import ctypes
import glob
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")

#: launches per kernel wrapper (name -> count)
LAUNCHES = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # label, h_links, v_links, H, W, s, t, ccl, stream
    "mn_flood_scan": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # comp, packed, log_odds, best_pri, best_partner, H, W, offsets,
    # num_offsets, theta, size_cap, stream
    "mn_absorb_best_edges": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _I,
                             _P),
    # comp, clsfz, size, log_odds, best_pri, best_partner, H, W, offsets,
    # num_offsets, theta, size_cap, stream
    "mn_absorb_best_edges_unpacked": (_P, _P, _P, _P, _P, _P, _I, _I, _P,
                                      _I, _F, _I, _P),
    # table, idx, out, n, m, stream
    "mn_table_gather": (_P, _P, _P, _I, _I, _P),
    # table, idx, out, n, m, stream
    "mn_pgather": (_P, _P, _P, _I, _I, _P),
}

_lib = None
#: seconds the last nvcc call took in this process (None: no build ran)
build_seconds = None


def reset_launches():
    LAUNCHES.clear()


@atexit.register
def _log_launches():
    path = os.environ.get("MERGENET_LAUNCH_LOG")
    if path and LAUNCHES:
        with open(path, "a") as f:
            f.write(json.dumps(dict(LAUNCHES)) + "\n")


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libmergenet_kernels_%s.so"
                        % h.hexdigest()[:16])


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the GPU")
    return found


def build():
    """Compile csrc/*.cu unless the library for the current sources
    exists.  Returns its path."""
    out = library_path()
    if not os.path.exists(out):
        compile_library(sources(), out)
    return out


def compile_library(srcs, out):
    """One `nvcc -c` per source in `srcs`, all started together, then
    one link into the shared library `out` (replaced atomically)."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in srcs:
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o",
                os.path.join(work, "lib.so")]
        failed = []
        for cmd, obj, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append("%s\n%s" % (" ".join(cmd), err[-4000:]))
            link.append(obj)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (%d):\n%s\n%s" % (
                proc.returncode, " ".join(link), proc.stderr[-4000:]))
        os.replace(link[link.index("-o") + 1], out)  # atomic
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.mn_error_string.argtypes = [ctypes.c_int]
        lib.mn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err, name):
    """Raise when a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = library().mn_error_string(err).decode()
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, err, msg))


def stream_of(t):
    """The current CUDA stream handle of tensor t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond, msg):
    if not cond:
        raise ValueError(msg)


def kernel_device(*tensors):
    """'cpu' when every tensor is on the CPU (plain version), 'cuda' when
    every tensor is on one CUDA device (kernel); raises otherwise."""
    devs = {t.device for t in tensors}
    require(len(devs) == 1, "tensors on different devices: %s" % devs)
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    return dev.type
