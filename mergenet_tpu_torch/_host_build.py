"""Build a host C++ source of the port into a shared library with g++.

The library goes under `mergenet_tpu_torch/_build/` as
`libmergenet_<source stem>_<hash>.so`, the hash taken over the flags and
the source, so a changed source rebuilds and an unchanged one is reused.
It is written to a temporary file and renamed, so concurrent builders
never see half a library; a failed build raises with g++'s stderr.
Users: `decoder/csegment.py` (native/segment.cc) and `data/jpeg.py`
(native/jpeg.cc)."""

import hashlib
import os
import subprocess
import tempfile

from .ops._build import BUILD_DIR


def library_path(src, flags):
    """Where `build(src, flags)` puts its library."""
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, "libmergenet_%s_%s.so"
                        % (stem, h.hexdigest()[:16]))


def build(src, flags):
    """Compile `src` with `g++ flags` unless the library for the current
    source exists.  Returns its path."""
    out = library_path(src, flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *flags, src, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed (%d): %s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stderr[-4000:]))
        os.replace(tmp, out)  # atomic: concurrent builders never see half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
