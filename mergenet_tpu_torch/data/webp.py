"""WebP reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads a WebP file with OpenCV
5.0's decoder (grfmt_webp.cpp over libwebp 1.5), the bitstreams decoded
by `native/webp.cc` (written for the port; no libwebp is vendored or
linked) and every decision cv2 and libwebp make taken here:

- cv2 takes a file as WebP when WebPGetFeatures accepts its first 32
  bytes (`is_webp`): a RIFF 'WEBP' file whose first chunk is VP8, VP8L
  or VP8X (no check past the VP8X chunk then), or a raw VP8/VP8L
  bitstream; files under 32 bytes or over 64 MiB
  (OPENCV_IMGCODECS_WEBP_MAX_FILE_SIZE) are refused;
- a still file is decoded as WebPDecodeBGRInto decodes it: the RIFF
  size may not pass the end of the file; after a VP8X chunk (size 10,
  canvas = the bitstream's size) the chunks up to the first VP8/VP8L
  one are walked (their sizes checked against the RIFF size; the last
  ALPH chunk is the alpha); the bitstream is read from its chunk's
  payload to the end of the file.  The RGB of an image with alpha is
  the decoded colour, neither premultiplied nor blended (cv2 drops the
  alpha), but a lossy image's ALPH chunk is decoded and a corrupt one
  refuses the file;
- an animated file (the VP8X animation flag) is read as
  WebPAnimDecoder reads its first frame: the file must pass
  WebPDemux's checks (`_demux`: chunk sizes within the RIFF, ANIM before
  the frames, every frame's bitstream valid and inside the canvas,
  no unknown VP8X flag), and the first frame is decoded into a canvas
  of zeros at its offset; the background colour, blending and disposal
  play no part in the first frame;
- the EXIF orientation is that of the first EXIF chunk WebPDemux keeps:
  a VP8X file with the EXIF flag set that passes the demuxer's checks,
  read by `io.exif_orientation` and applied by `jpeg.orient`; a file the
  demuxer refuses is read but not turned;
- cv2's image size limits (2^20 a side, 2^30 pixels) apply to the
  canvas.

What cv2 refuses raises ValueError naming the file and the cause.

The shared library is built with g++ at the first call, never at
import, into `mergenet_tpu_torch/_build/` by `_host_build.build`."""

import ctypes
import os
import struct
import threading

import numpy as np

from .. import _host_build, io
from .jpeg import orient

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                   "webp.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None

HEADER_SIZE = 32  # cv2's WEBP_HEADER_SIZE
MAX_FILE_SIZE = 64 << 20
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30  # cv2's CV_IO_MAX_IMAGE_*
ALPHA_FLAG, ANIMATION_FLAG, EXIF_FLAG = 0x10, 0x02, 0x08
_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | EXIF_FLAG | 0x20 | 0x04  # ICCP, XMP
_MAX_CHUNK = 0xFFFFFFFF - 8 - 1
_MAX_AREA = 1 << 32

OK, SHORT, BAD = "ok", "not enough data", "bitstream error"


def library_path():
    return _host_build.library_path(SRC, CXX_FLAGS)


def build():
    """Compile native/webp.cc unless its library exists; returns the
    library's path."""
    return _host_build.build(SRC, CXX_FLAGS)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for fn in ("mn_webp_vp8", "mn_webp_vp8l", "mn_webp_alpha"):
                getattr(lib, fn).argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.c_int]
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def _le24(b, at):
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16


def _le32(b, at):
    return struct.unpack_from("<I", b, at)[0]


def _vp8_info(b, n, chunk_size):
    """(width, height) of a VP8 key frame's first 10 bytes, or None
    (libwebp's VP8GetInfo)."""
    if n < 10 or b[3:6] != b"\x9d\x01\x2a":
        return None
    bits = b[0] | b[1] << 8 | b[2] << 16
    w, h = (b[6] | b[7] << 8) & 0x3FFF, (b[8] | b[9] << 8) & 0x3FFF
    if (bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1
            or (bits >> 5) >= chunk_size or w == 0 or h == 0):
        return None
    return w, h


def _vp8l_info(b, n):
    """(width, height, has_alpha) of a VP8L header, or None."""
    if n < 5 or b[0] != 0x2F or b[4] >> 5:
        return None
    v = _le32(b, 1)
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, (v >> 28) & 1


def _headers(data, have_all_data):
    """libwebp's ParseHeadersInternal: (status, info), info holding the
    size, flags and, when the status is OK, where the bitstream starts
    (`offset`), whether it is lossless and the ALPH payload.  With
    `have_all_data` false (WebPGetFeatures) a VP8X file may end early."""
    info = {"width": 0, "height": 0, "alpha": 0, "animation": 0,
            "vp8x": False, "alpha_data": None}
    size = len(data)
    if size < 12:
        return SHORT, info
    pos, riff_size, found_riff = 0, 0, False
    if data[:4] == b"RIFF":  # ParseRIFF
        if data[8:12] != b"WEBP":
            return BAD, info
        riff_size = _le32(data, 4)
        if riff_size < 12 or riff_size > _MAX_CHUNK:
            return BAD, info
        if have_all_data and riff_size > size - 8:
            return SHORT, info
        pos, found_riff = 12, True

    def result(status):
        if status == OK or (status == SHORT and info["vp8x"]
                            and not have_all_data):
            info["alpha"] |= info["alpha_data"] is not None
            return OK, info
        return status, info

    if size - pos < 8:  # ParseVP8X
        return SHORT, info
    canvas = None
    if data[pos:pos + 4] == b"VP8X":
        if _le32(data, pos + 4) != 10:
            return BAD, info
        if size - pos < 18:
            return SHORT, info
        flags = _le32(data, pos + 8)
        canvas = (1 + _le24(data, pos + 12), 1 + _le24(data, pos + 15))
        if canvas[0] * canvas[1] >= _MAX_AREA:
            return BAD, info
        pos += 18
        info["vp8x"] = True
        if not found_riff:
            return BAD, info
        info["alpha"] = int(bool(flags & ALPHA_FLAG))
        info["animation"] = int(bool(flags & ANIMATION_FLAG))
        info["width"], info["height"] = canvas
        if info["animation"] and not have_all_data:
            return result(OK)
    if size - pos < 4:
        return result(SHORT)
    if (found_riff and info["vp8x"]) or (
            not found_riff and data[pos:pos + 4] == b"ALPH"):
        total = 4 + 8 + 10  # ParseOptionalChunks
        while True:
            if size - pos < 8:
                return result(SHORT)
            n = _le32(data, pos + 4)
            if n > _MAX_CHUNK:
                return result(BAD)
            disk = (8 + n + 1) & ~1
            total += disk
            if riff_size > 0 and total > riff_size:
                return result(BAD)
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if size - pos < disk:
                return result(SHORT)
            if data[pos:pos + 4] == b"ALPH":
                info["alpha_data"] = data[pos + 8:pos + 8 + n]
            pos += disk
    if size - pos < 8:  # ParseVP8Header
        return result(SHORT)
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        chunk = _le32(data, pos + 4)
        if riff_size >= 12 and chunk > riff_size - 12:
            return result(BAD)
        if have_all_data and chunk > size - pos - 8:
            return result(SHORT)
        pos += 8
        lossless = tag == b"VP8L"
    else:
        chunk = size - pos
        lossless = _vp8l_info(data[pos:pos + 5], size - pos) is not None
    if chunk > _MAX_CHUNK:
        return BAD, info
    b = data[pos:pos + 10]
    if not lossless:
        if size - pos < 10:
            return result(SHORT)
        got = _vp8_info(b, size - pos, chunk)
        if got is None:
            return BAD, info
    else:
        if size - pos < 5:
            return result(SHORT)
        got = _vp8l_info(b, size - pos)
        if got is None:
            return BAD, info
        info["alpha"] = got[2]
    if canvas is not None and canvas != got[:2]:
        return BAD, info
    info["width"], info["height"] = got[:2]
    info["offset"], info["lossless"] = pos, lossless
    return result(OK)


def is_webp(head):
    """Whether cv2 takes a file starting with `head` for WebP: its first
    32 bytes pass WebPGetFeatures."""
    return len(head) >= HEADER_SIZE and _headers(
        bytes(head[:HEADER_SIZE]), False)[0] == OK


def _decode_bitstream(data, info, name):
    """(H, W, 3) RGB of the bitstream at info['offset'] (to the end of
    `data`), a lossy one's ALPH chunk decoded and checked first."""
    lib = _load()
    w, h = info["width"], info["height"]
    err = ctypes.create_string_buffer(256)
    if not info["lossless"] and info["alpha_data"] is not None:
        a = np.empty((h, w), np.uint8)
        if lib.mn_webp_alpha(info["alpha_data"], len(info["alpha_data"]), w,
                             h, a.ctypes.data, err, len(err)):
            raise ValueError("%s: %s" % (name, err.value.decode()))
    rgb = np.empty((h, w, 3), np.uint8)
    body = data[info["offset"]:]
    fn = lib.mn_webp_vp8l if info["lossless"] else lib.mn_webp_vp8
    if fn(body, len(body), w, h, rgb.ctypes.data, err, len(err)):
        raise ValueError("%s: %s" % (name, err.value.decode()))
    return rgb


class _Mem:
    """WebPDemux's MemBuffer: a cursor over the file cut at the RIFF
    end."""

    def __init__(self, data, riff_end):
        self.data, self.start = data, 12
        self.end = min(len(data), riff_end)
        self.riff_end = riff_end

    def left(self):
        return self.end - self.start

    def invalid(self, size):
        return size > self.riff_end - self.start

    def u32(self):
        v = _le32(self.data, self.start)
        self.start += 4
        return v

    def u24(self):
        v = _le24(self.data, self.start)
        self.start += 3
        return v


class _DemuxError(Exception):
    pass


def _frame(x, y):
    """A demuxed frame at (x, y): its ALPH and image chunks (offset,
    size), size, number and whether its image chunk is whole."""
    return {"x": x, "y": y, "alpha": None, "image": None, "complete": False,
            "num": 0, "width": 0, "height": 0}


def _store_frame(mem, frame, frame_num, min_size):
    """WebPDemux's StoreFrame: the ALPH and VP8/VP8L chunks from the
    cursor into `frame`; returns OK or SHORT (raises on an error)."""
    if mem.left() < 8 or mem.left() < min_size:
        return SHORT
    status, alpha_chunks, image_chunks = OK, 0, 0
    while True:
        at = mem.start
        tag = mem.data[at:at + 4]
        mem.start += 4
        size = mem.u32()
        if size > _MAX_CHUNK:
            raise _DemuxError("chunk size")
        padded = size + (size & 1)
        available = min(padded, mem.left())
        if mem.invalid(padded):
            raise _DemuxError("chunk past the RIFF end")
        if padded > mem.left():
            status = SHORT
        done = False
        if tag == b"VP8L" and alpha_chunks:
            raise _DemuxError("ALPH before VP8L")
        if tag == b"ALPH" and alpha_chunks == 0:
            alpha_chunks += 1
            frame["alpha"] = (at, 8 + available)
            frame["num"] = frame_num
            mem.start += available
        elif tag in (b"VP8 ", b"VP8L") and image_chunks == 0:
            st, info = _headers(mem.data[at:at + 8 + available], False)
            if status == SHORT and st == SHORT:
                return SHORT
            if st != OK:
                raise _DemuxError("frame bitstream")
            image_chunks += 1
            frame["image"] = (at, 8 + available)
            frame["width"], frame["height"] = info["width"], info["height"]
            frame["num"] = frame_num
            frame["complete"] = status == OK
            mem.start += available
        else:
            mem.start -= 8
            done = True
        if mem.start == mem.riff_end:
            done = True
        elif mem.left() < 8:
            status = SHORT
        if done or status != OK:
            return status


def _demux(data):
    """What WebPDemux (all data present) keeps of a VP8X file: {canvas,
    flags, frames, exif}; None where it refuses the file or the file is
    not an extended one."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return None
    riff_size = _le32(data, 4)
    if riff_size < 8 or riff_size > _MAX_CHUNK:
        return None
    mem = _Mem(data, riff_size + 8)
    if mem.end < mem.riff_end or data[12:16] != b"VP8X":
        return None
    try:
        return _demux_vp8x(mem)
    except _DemuxError:
        return None


def _demux_vp8x(mem):
    if mem.left() < 8:
        raise _DemuxError("short")
    mem.start += 4
    size = mem.u32()
    if size > _MAX_CHUNK or size < 10:
        raise _DemuxError("VP8X size")
    size += size & 1
    if mem.invalid(size) or mem.left() < size:
        raise _DemuxError("VP8X past the end")
    flags = mem.data[mem.start]
    mem.start += 4
    canvas = (1 + mem.u24(), 1 + mem.u24())
    if canvas[0] * canvas[1] >= _MAX_AREA:
        raise _DemuxError("canvas")
    mem.start += size - 10
    if mem.invalid(8) or mem.left() < 8:
        raise _DemuxError("nothing after VP8X")
    animation = bool(flags & ANIMATION_FLAG)
    frames, exif, anim_chunks = [], [], 0
    while True:  # ParseVP8XChunks
        at = mem.start
        tag = mem.data[at:at + 4]
        mem.start += 4
        size = mem.u32()
        if size > _MAX_CHUNK:
            raise _DemuxError("chunk size")
        padded = size + (size & 1)
        if mem.invalid(padded):
            raise _DemuxError("chunk past the RIFF end")
        status = OK
        if tag == b"VP8X":
            raise _DemuxError("second VP8X")
        elif tag in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim_chunks or animation or frames:
                raise _DemuxError("a still image where it may not be")
            mem.start -= 8
            frame = _frame(0, 0)
            status = _store_frame(mem, frame, 1, 0)
            if not flags & ALPHA_FLAG:
                frame["alpha"] = None
            frames.append(frame)
        elif tag == b"ANIM":
            if padded < 6:
                raise _DemuxError("ANIM size")
            if mem.left() < padded:
                status = SHORT
            else:  # the first ANIM is read, later ones skipped
                anim_chunks += 1
                mem.start += padded
        elif tag == b"ANMF":
            if anim_chunks == 0:
                raise _DemuxError("ANMF before ANIM")
            status = _demux_frame(mem, padded, frames, animation)
        elif padded <= mem.left():  # kept (EXIF only if flagged) or not
            if tag == b"EXIF" and flags & EXIF_FLAG:
                exif.append(mem.data[at + 8:at + 8 + size])
            mem.start += padded
        else:
            status = SHORT
        if mem.start == mem.riff_end:
            break
        if mem.left() < 8:
            status = SHORT
        if status != OK:
            break
    if status != OK:
        raise _DemuxError("the file ends inside a chunk")
    # IsValidExtendedFormat
    if not frames or flags & ~_VALID_FLAGS:
        raise _DemuxError("no frame, or unknown flags")
    for f in frames:
        if not animation and f["num"] > 1:
            raise _DemuxError("frames in a still file")
        if not f["complete"] or (f["alpha"] is None and f["image"] is None):
            raise _DemuxError("incomplete frame")
        if f["alpha"] is not None and f["image"] is not None and \
                f["alpha"][0] > f["image"][0]:
            raise _DemuxError("ALPH after the image")
        if f["width"] <= 0 or f["height"] <= 0:
            raise _DemuxError("frame size")
        if animation:
            inside = (f["x"] + f["width"] <= canvas[0]
                      and f["y"] + f["height"] <= canvas[1])
        else:
            inside = (f["x"], f["y"], f["width"], f["height"]) == (
                0, 0) + canvas
        if not inside:
            raise _DemuxError("frame outside the canvas")
    return {"canvas": canvas, "flags": flags, "frames": frames,
            "exif": exif}


def _demux_frame(mem, padded, frames, animation):
    """WebPDemux's ParseAnimationFrame."""
    if mem.invalid(16) or padded < 16:
        raise _DemuxError("ANMF size")
    if mem.left() < 16:
        return SHORT
    frame = _frame(2 * mem.u24(), 2 * mem.u24())
    w, h = 1 + mem.u24(), 1 + mem.u24()
    mem.start += 4  # duration, flags
    if w * h >= _MAX_AREA:
        raise _DemuxError("frame size")
    start = mem.start
    status = _store_frame(mem, frame, len(frames) + 1, padded - 16)
    if mem.start - start > padded - 16:
        raise _DemuxError("frame past its ANMF chunk")
    if animation and frame["num"] > 0:
        if frames and not frames[-1]["complete"]:
            raise _DemuxError("a frame after an incomplete one")
        frames.append(frame)
    return status


def _first_frame(data, dmx, name):
    """The first frame of an animation on a canvas of zeros, as
    WebPAnimDecoderGetNext composes it."""
    W, H = dmx["canvas"]
    f = dmx["frames"][0]
    at, size = f["image"]
    if f["alpha"] is not None:
        size += f["image"][0] - f["alpha"][0]
        at = f["alpha"][0]
    frag = data[at:at + size]
    status, info = _headers(frag, True)
    if status != OK or info["animation"]:
        raise ValueError("%s: WebP animation frame 1: %s" % (name, status))
    canvas = np.zeros((H, W, 3), np.uint8)
    canvas[f["y"]:f["y"] + info["height"], f["x"]:f["x"] + info["width"]] = \
        _decode_bitstream(frag, info, name + " (frame 1)")
    return canvas


def decode_webp(data, name="WebP data"):
    """(H, W, 3) uint8 RGB of the WebP file held in `data` (bytes), its
    EXIF orientation applied; the first frame of an animation."""
    data = bytes(data)
    if len(data) < HEADER_SIZE:
        raise ValueError("%s: a WebP file of %d bytes, under cv2's %d"
                         % (name, len(data), HEADER_SIZE))
    if len(data) > MAX_FILE_SIZE:
        raise ValueError("%s: a WebP file over cv2's %d bytes"
                         % (name, MAX_FILE_SIZE))
    status, feat = _headers(data[:HEADER_SIZE], False)
    if status != OK:
        raise ValueError("%s: not a WebP header cv2 reads (%s)"
                         % (name, status))
    W, H = feat["width"], feat["height"]
    if W > MAX_SIDE or H > MAX_SIDE or W * H > MAX_PIXELS:
        raise ValueError("%s: WebP canvas %dx%d past cv2's limits"
                         % (name, W, H))
    dmx = _demux(data)
    if feat["animation"]:
        if dmx is None:
            raise ValueError("%s: an animated WebP file WebPDemux refuses"
                             % name)
        rgb = _first_frame(data, dmx, name)
    else:
        status, info = _headers(data, True)
        if status != OK:
            raise ValueError("%s: WebP %s" % (name, status))
        if info["animation"]:
            raise ValueError("%s: WebP animation flag past the header"
                             % name)
        rgb = _decode_bitstream(data, info, name)
    if dmx is not None and dmx["exif"]:
        rgb = orient(rgb, io.exif_orientation(dmx["exif"][0]))
    return rgb
