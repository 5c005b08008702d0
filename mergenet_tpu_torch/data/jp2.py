"""JPEG 2000 reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads a JP2 file or a raw J2K
codestream with OpenCV 5.0's decoder (grfmt_jpeg2000_openjpeg.cpp over
OpenJPEG 2.5.3, strict mode), the codestream decoded by
`native/jp2.cc` (written for the port from ITU-T T.800; no OpenJPEG is
vendored or linked) and every decision cv2 and OpenJPEG make taken here:

- cv2 picks the JP2 reader by the 12-byte signature box and the J2K
  reader by SOC + SIZ (`FF 4F FF 51`);
- a JP2 file is walked as opj_jp2_read_header walks it: the signature
  box first, ftyp second, then boxes up to jp2c (jp2h with ihdr, colr,
  bpcc, pclr, cmap, cdef; misplaced image boxes read once jp2h is in);
  the codestream is read from jp2c's payload to the end of the file;
- the colour space is the first colr box's: 16 sRGB, 17 grey, 18 sYCC,
  12 CMYK and 24 e-sYCC (both refused by cv2), anything else (or an
  ICC profile, or a raw codestream) unknown, which cv2 reads as sRGB;
- after decoding, OpenJPEG checks and applies pclr/cmap (the palette's
  columns become the components, indices clamped to the palette) and
  cdef (colour channels swapped to their association, alpha marked);
- cv2 refuses a signed component, a maximum precision under 8, a
  component that is subsampled or off the image origin, CMYK, e-sYCC,
  and sRGB/sYCC with fewer than 3 components; it shifts every sample
  right by (maximum precision - 8) and casts it to 8 bits (the low
  byte: a palette's wider entries wrap); grey repeats component 0,
  sRGB takes components 0-2 (alpha and further components dropped),
  sYCC takes components 0-2 as Y, U, V through cvtColor's YUV2BGR
  (14-bit fixed point);
- cv2's image size limits (2^20 a side, 2^30 pixels) apply.

What cv2 refuses raises ValueError naming the file and the cause; the
port refuses no JPEG 2000 file cv2 reads, but for corrupt HT data where
OpenJPEG's MEL check depends on the buffer's address.  What
`cv2.imread` returns, probed on cv2's, Pillow's (OpenJPEG 2.5.4) and
`tests/j2k_craft.py`'s files (its HT encoder's among them), each row
held by `tests/test_torch_port_jp2.py` or
`tests/test_torch_port_jp2_ht.py`:

  variant                                           cv2.imread / port
  5/3 (any level, any band origin parity), 9/7,     OpenJPEG's lifting,
    RCT, ICT; 1-31 levels                             1.5 x 2^p, lrintf
  LRCP, RLCP, RPCL, PCRL, CPRL; POC in the main or  read
    tile header; precincts; 1-4 layers; tiles;
    tile-parts in any order; TNsot 0; PPM, PPT,
    SOP/EPH; PLT, TLM, PLM, CRG, COM
  code-block styles (BYPASS, RESET, TERMALL, VSC,   read
    PTERM, SEGSYM, all); 4x4 to 1024x4; RGN 1-12
  8-16 bits, mixed precisions                       >> (max - 8), low byte
  1-7 bits; a signed, subsampled or offset          None / ValueError
    component; an image origin other than 0
  colr 17 (grey), 1-4 components                    component 0 thrice
  colr 16, unknown, ICC, none, raw J2K; 3-4 comps   components 0-2 as RGB
  colr 18 (sYCC), 3-4 components                    cvtColor(YUV2BGR)
  colr 12 (CMYK), 24 (e-sYCC); sRGB/sYCC or raw     None / ValueError
    J2K with 1-2 components
  pclr/cmap (8-16-bit entries), cdef orders,        OpenJPEG's pclr/cdef
    alpha first or last, 65535
  pclr without cmap, bad cmap, bad cdef             None / ValueError
  truncated, flipped, lengths that lie (~4,300)     None or read / both
  HT (style 0x40): 1-3 passes, 5/3 and 9/7, 4x4     OpenJPEG's HT decoder:
    to 1024x4, every progression, precincts,          read
    tiles, VSC, MagSgn 0xFF stuffing, 8-16 bits,
    a block's passes in one layer (or TERMALL
    layers); HT on some components only (COC);
    CAP, Rsiz 0x4000
  HT with a block's passes over several layers      None / ValueError
    (the later pass joins the cleanup segment:
    Scup or segment length refused), 4+ passes,
    RGN, Mb over 30, the mixed bit 0x80
  HT data flipped (2,000 files, 1-3 bytes each)     1,340 equal, 659 both
                                                      refuse, 1 the port
                                                      refuses (a MEL check
                                                      that depends on the
                                                      buffer's address)
  MCT/MCC/MCO: an offset array; MCO alone;          DC shifts from the
    records OpenJPEG skips (Zmct, Ymct, Zmcc,         array; MCO zeroes
    Ymcc, 2+ collections, shuffled indices);          them; skipped
    CBD; Rsiz bit 15; ATK, DFS markers                records change
                                                      nothing; CBD sets
                                                      precision and sign
  MCT/MCC/MCO/CBD of wrong sizes, an MCC naming     None / ValueError
    no MCT record, COD MCT byte 2+, COD/COC
    transform 2+ (an ATK wavelet)
  32 levels under RPCL, PCRL, CPRL                  read (OpenJPEG's 32-bit
                                                      shift by 32 is the
                                                      x86 shift by 0)
  a POC giving a top resolution no packet           that resolution top
                                                      left, 0 elsewhere;
                                                      None with the MCT
                                                      and components at
                                                      different ones

The shared library is built with g++ at the first call, never at
import, into `mergenet_tpu_torch/_build/` by `_host_build.build`."""

import ctypes
import os
import struct
import threading

import numpy as np

from .. import _host_build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                   "jp2.cc")
# no -march and no contraction into FMA: the 9/7 wavelet, the ICT and
# the dequantisation round in float32 exactly as OpenJPEG's SSE code
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
_lock = threading.Lock()
_lib = None

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30  # cv2's CV_IO_MAX_IMAGE_*
GRAY, SYCC, EYCC, CMYK = 17, 18, 24, 12  # colr enumerated spaces


def is_jp2(head):
    """cv2's test of the first bytes: a JP2 signature box or a raw
    codestream."""
    return head[:12] == JP2_SIGNATURE or head[:4] == J2K_SIGNATURE


def library_path():
    return _host_build.library_path(SRC, CXX_FLAGS)


def build():
    """Compile native/jp2.cc unless its library exists; returns the
    library's path."""
    return _host_build.build(SRC, CXX_FLAGS)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mn_j2k_decode.restype = ctypes.c_void_p
            lib.mn_j2k_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.POINTER(ctypes.c_int),
                ctypes.c_char_p, ctypes.c_int]
            lib.mn_j2k_info.restype = ctypes.c_int
            lib.mn_j2k_info.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int]
            lib.mn_j2k_copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
            lib.mn_j2k_free.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class _Refused(Exception):
    pass


# ----------------------------------------------------------------- boxes

class _Header:
    """What opj_jp2_read_header keeps of the boxes before jp2c."""

    def __init__(self):
        self.ihdr = None  # (h, w, nc, bpc)
        self.enumcs = 0
        self.has_colr = False
        self.pclr = None  # (entries (n, ncols), sizes, signs)
        self.cmap = None  # [(cmp, mtyp, pcol)]
        self.cdef = None  # [(cn, typ, asoc)]


def _box_header(data, at, end):
    """(length, type, header size) of the box at `at` (OpenJPEG's
    opj_jp2_read_boxhdr), or None if fewer than 8 bytes are left."""
    if end - at < 8:
        return None
    n, kind = struct.unpack_from(">I4s", data, at)
    head = 8
    if n == 1:
        if end - at < 16:
            raise _Refused("Cannot handle box sizes higher than 2^32")
        hi, lo = struct.unpack_from(">II", data, at + 8)
        if hi:
            raise _Refused("Cannot handle box sizes higher than 2^32")
        n, head = lo, 16
    return n, kind, head


_IMG_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


def _read_image_box(hdr, kind, p):
    if kind == b"ihdr":
        if hdr.ihdr is not None:
            return  # "Ignoring ihdr box. First ihdr box already read"
        if len(p) != 14:
            raise _Refused("Bad image header box (bad size)")
        h, w, nc, bpc = struct.unpack_from(">IIHB", p)
        if not 1 <= nc <= 16384:
            raise _Refused("Invalid number of components (ihdr)")
        hdr.ihdr = (h, w, nc, bpc)
    elif kind == b"colr":
        if len(p) < 3:
            raise _Refused("Bad COLR header box (bad size)")
        if hdr.has_colr:
            return  # only the first colr box counts
        meth = p[0]
        if meth == 1:
            if len(p) < 7:
                raise _Refused("Bad COLR header box (bad size)")
            hdr.enumcs = struct.unpack_from(">I", p, 3)[0]
            if hdr.enumcs == 14 and len(p) != 7 and len(p) < 35:
                raise _Refused("Bad COLR header box (CIELab)")
            hdr.has_colr = True
        elif meth == 2:  # an ICC profile: the space is unknown to cv2
            hdr.enumcs = 0
            hdr.has_colr = True
    elif kind == b"bpcc":
        if hdr.ihdr is None or len(p) != hdr.ihdr[2]:
            raise _Refused("Bad BPCC header box (bad size)")
    elif kind == b"pclr":
        if hdr.pclr is not None or len(p) < 3:
            raise _Refused("Invalid PCLR box")
        n, ncols = struct.unpack_from(">HB", p)
        if n == 0 or n > 1024:
            raise _Refused("Invalid PCLR box. Reports %d entries" % n)
        if ncols == 0:
            raise _Refused("Invalid PCLR box. Reports 0 palette columns")
        if len(p) < 3 + ncols:
            raise _Refused("Invalid PCLR box")
        sizes = [(b & 0x7f) + 1 for b in p[3:3 + ncols]]
        signs = [b >> 7 for b in p[3:3 + ncols]]
        at = 3 + ncols
        entries = np.zeros((n, ncols), np.int64)
        for j in range(n):
            for i in range(ncols):
                nb = min((sizes[i] + 7) >> 3, 4)
                if len(p) < at + nb:
                    raise _Refused("Invalid PCLR box")
                entries[j, i] = int.from_bytes(p[at:at + nb], "big")
                at += nb
        hdr.pclr = (entries, sizes, signs)
    elif kind == b"cmap":
        if hdr.pclr is None:
            raise _Refused("Need to read a PCLR box before the CMAP box.")
        if hdr.cmap is not None:
            raise _Refused("Only one CMAP box is allowed.")
        ncols = hdr.pclr[0].shape[1]
        if len(p) < 4 * ncols:
            raise _Refused("Insufficient data for CMAP box.")
        hdr.cmap = [struct.unpack_from(">HBB", p, 4 * i)
                    for i in range(ncols)]
    elif kind == b"cdef":
        if hdr.cdef is not None:
            raise _Refused("more than one CDEF box")
        if len(p) < 2:
            raise _Refused("Insufficient data for CDEF box.")
        n = struct.unpack_from(">H", p)[0]
        if n == 0:
            raise _Refused("Number of channel description is equal to zero "
                           "in CDEF box.")
        if len(p) < 2 + 6 * n:
            raise _Refused("Insufficient data for CDEF box.")
        hdr.cdef = [list(struct.unpack_from(">HHH", p, 2 + 6 * i))
                    for i in range(n)]


def _read_jp2h(hdr, p):
    at, end = 0, len(p)
    has_ihdr = False
    while at < end:
        if end - at < 8:
            raise _Refused("Cannot handle box of less than 8 bytes")
        n, kind = struct.unpack_from(">I4s", p, at)
        head = 8
        if n == 1:
            if end - at < 16:
                raise _Refused("Cannot handle box of less than 16 bytes")
            hi, n = struct.unpack_from(">II", p, at + 8)
            if hi:
                raise _Refused("Cannot handle box sizes higher than 2^32")
            head = 16
        if n == 0:
            raise _Refused("Cannot handle box of undefined sizes")
        if n < head:
            raise _Refused("Box length is inconsistent.")
        if n > end - at:
            raise _Refused("Stream error while reading JP2 Header box: box "
                           "length is inconsistent.")
        if kind in _IMG_BOXES:
            _read_image_box(hdr, kind, p[at + head:at + n])
        if kind == b"ihdr":
            has_ihdr = True
        at += n
    if not has_ihdr:
        raise _Refused("Stream error while reading JP2 Header box: no "
                       "'ihdr' box.")


def _walk_jp2(data):
    """(header, offset of the codestream) of a JP2 file."""
    hdr = _Header()
    state = 0  # 1 signature, 2 ftyp, 4 jp2h
    at, end = 0, len(data)
    while True:
        bh = _box_header(data, at, end)
        if bh is None:
            raise _Refused("no codestream box")
        n, kind, head = bh
        if kind == b"jp2c":
            if not state & 4:
                raise _Refused("bad placed jpeg codestream")
            break
        if n == 0:
            raise _Refused("Cannot handle box of undefined sizes")
        if n < head:
            raise _Refused("invalid box size %d" % n)
        payload_n = n - head
        misplaced = kind in _IMG_BOXES
        if kind in (b"jP  ", b"ftyp", b"jp2h") or misplaced:
            if misplaced and not state & 4:
                # read once jp2h is in; before it, skipped
                if payload_n > end - at - head:
                    raise _Refused("Problem with skipping JPEG2000 box, "
                                   "stream error")
                at += n
                continue
            if payload_n > end - at - head:
                raise _Refused("Invalid box size %d for box '%s'" % (
                    n, kind.decode("latin-1")))
            p = data[at + head:at + n]
            if kind == b"jP  ":
                if state != 0:
                    raise _Refused("The signature box must be the first box "
                                   "in the file.")
                if len(p) != 4 or p != b"\r\n\x87\n":
                    raise _Refused("Error with JP signature Box")
                state |= 1
            elif kind == b"ftyp":
                if state != 1:
                    raise _Refused("The ftyp box must be the second box in "
                                   "the file.")
                if len(p) < 8 or (len(p) - 8) % 4:
                    raise _Refused("Error with FTYP signature Box size")
                state |= 2
            elif kind == b"jp2h":
                if not state & 2:
                    raise _Refused("the jp2h box before the ftyp box")
                _read_jp2h(hdr, p)
                state |= 4
            else:
                _read_image_box(hdr, kind, p)
        else:
            if not state & 1:
                raise _Refused("Malformed JP2 file format: first box must be "
                               "JPEG 2000 signature box")
            if not state & 2:
                raise _Refused("Malformed JP2 file format: second box must be "
                               "file type box")
            if payload_n > end - at - head:
                raise _Refused("Problem with skipping JPEG2000 box, stream "
                               "error")
        at += n
    if hdr.ihdr is None:
        raise _Refused("IHDR box missing. Required.")
    return hdr, at + head


# -------------------------------------------------------------- decoding

def _decode_codestream(cs, ihdr_wh):
    """((x0, y0, x1, y1) of the image, [[array (h, w) int32, prec, sgnd,
    dx, dy, x0, y0] per component])."""
    lib = _load()
    code = ctypes.c_int(0)
    err = ctypes.create_string_buffer(512)
    h = lib.mn_j2k_decode(cs, len(cs), ihdr_wh[0], ihdr_wh[1],
                          ctypes.byref(code), err, len(err))
    if not h:
        raise _Refused(err.value.decode("latin-1"))
    try:
        n = lib.mn_j2k_info(h, None, 0)
        info = np.zeros(n, np.int32)
        lib.mn_j2k_info(h, info.ctypes.data, n)
        out = []
        for c in range(info[4]):
            prec, sgnd, dx, dy, x0, y0, w, hh = (int(v) for v in
                                                 info[5 + 8 * c:13 + 8 * c])
            a = np.empty((hh, w), np.int32)
            if a.size:
                lib.mn_j2k_copy(h, c, a.ctypes.data)
            out.append([a, prec, sgnd, dx, dy, x0, y0])
        return (int(info[0]), int(info[1]), int(info[2]), int(info[3])), out
    finally:
        lib.mn_j2k_free(h)


def _check_color(hdr, ncomps):
    """opj_jp2_check_color: cdef and cmap must name channels that exist;
    may rewrite a lone component's odd cmap."""
    if hdr.cdef is not None:
        nr = ncomps
        if hdr.pclr is not None and hdr.cmap is not None:
            nr = hdr.pclr[0].shape[1]
        for cn, _, asoc in hdr.cdef:
            if cn >= nr:
                raise _Refused("Invalid component index %d (>= %d)." % (cn,
                                                                         nr))
            if asoc == 65535:
                continue
            if asoc > 0 and asoc - 1 >= nr:
                raise _Refused("Invalid component index %d (>= %d)." % (
                    asoc - 1, nr))
        for c in range(nr):
            if not any(cn == c for cn, _, _ in hdr.cdef):
                raise _Refused("Incomplete channel definitions.")
    if hdr.pclr is not None and hdr.cmap is not None:
        nr = hdr.pclr[0].shape[1]
        cm = [list(i) for i in hdr.cmap]
        sane = True
        for c in cm:
            if c[0] >= ncomps:
                sane = False
        used = [False] * nr
        for i, (_, mtyp, pcol) in enumerate(cm):
            if mtyp not in (0, 1) or pcol >= nr:
                sane = False
            elif used[pcol] and mtyp == 1:
                sane = False
            elif mtyp == 0 and pcol != 0:
                sane = False
            elif mtyp == 1 and pcol != i:
                sane = False
            else:
                used[pcol] = True
        for i in range(nr):
            if not used[i] and cm[i][1] != 0:
                sane = False
        if sane and ncomps == 1 and not all(used):
            for i in range(nr):
                cm[i][1], cm[i][2] = 1, i
        if not sane:
            raise _Refused("invalid component mapping (cmap)")
        hdr.cmap = [tuple(c) for c in cm]


def _apply_pclr(hdr, comps):
    entries, sizes, signs = hdr.pclr
    top = entries.shape[0] - 1
    new = []
    for i, (cmp_, mtyp, pcol) in enumerate(hdr.cmap):
        src = comps[cmp_]
        c = list(src)
        c[1], c[2] = sizes[i], signs[i]
        if mtyp == 0:
            c[0] = src[0].copy()
        else:
            k = np.clip(src[0].astype(np.int64), 0, top)
            c[0] = entries[k, pcol].astype(np.int32)
        new.append(c)
    return new


def _apply_cdef(hdr, comps):
    """opj_jp2_apply_cdef: colour channels move to their association;
    returns the alpha flags."""
    alpha = [0] * len(comps)
    info = [list(i) for i in hdr.cdef]
    for i in range(len(info)):
        cn, typ, asoc = info[i]
        if cn >= len(comps):
            continue
        if asoc == 0 or asoc == 65535:
            alpha[cn] = typ
            continue
        acn = asoc - 1
        if acn >= len(comps):
            continue
        if cn != acn and typ == 0:
            comps[cn], comps[acn] = comps[acn], comps[cn]
            alpha[cn], alpha[acn] = alpha[acn], alpha[cn]
            for j in range(i + 1, len(info)):
                if info[j][0] == cn:
                    info[j][0] = acn
                elif info[j][0] == acn:
                    info[j][0] = cn
        alpha[cn] = typ
    return alpha


def _yuv_to_rgb(y, u, v):
    """cv2.cvtColor(COLOR_YUV2BGR) on 8-bit planes (then as RGB): 14-bit
    fixed point, U and V centred on 128, rounded half up, saturated."""
    y, u, v = (p.astype(np.int64) for p in (y, u, v))
    u, v = u - 128, v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14
    r = y + descale(v * 18678)
    g = y + descale(u * -6472 + v * -9519)
    b = y + descale(u * 33292)
    return [np.clip(c, 0, 255).astype(np.uint8) for c in (r, g, b)]


def decode_jp2(data, path):
    """(H, W, 3) uint8 RGB of a JP2 file or raw J2K codestream's bytes,
    as cv2.imread + BGR2RGB give it; ValueError naming `path` and the
    cause where cv2 returns None."""
    try:
        return _decode(data)
    except _Refused as e:
        raise ValueError("%s: JPEG 2000 refused as cv2 refuses it: %s"
                         % (path, e)) from None


def _decode(data):
    if data[:12] == JP2_SIGNATURE:
        hdr, at = _walk_jp2(data)
        cs = data[at:]
        ihdr_wh = (hdr.ihdr[1], hdr.ihdr[0])
        space = hdr.enumcs
    else:
        hdr, cs, ihdr_wh, space = None, data, (0, 0), 0
    box, comps = _decode_codestream(cs, ihdr_wh)
    x0, y0, x1, y1 = box
    width, height = x1 - x0, y1 - y0
    # cv2's readHeader, on the components as the header gives them
    if any(c[2] for c in comps):
        raise _Refused("OpenJPEG2000: Component is signed")
    maxprec = max(c[1] for c in comps)
    if maxprec < 8:
        raise _Refused("OpenJPEG2000: Precision < 8 not supported")
    if width > MAX_SIDE or height > MAX_SIDE or width * height > MAX_PIXELS:
        raise _Refused("image size %dx%d past cv2's limits" % (width, height))
    if hdr is not None:
        _check_color(hdr, len(comps))
        if hdr.pclr is not None and hdr.cmap is not None:
            comps = _apply_pclr(hdr, comps)
        if hdr.cdef is not None:
            _apply_cdef(hdr, comps)
    # cv2's readData
    if space in (CMYK, EYCC):
        raise _Refused("OpenJPEG2000: Unsupported color space conversion")
    shift = max(0, maxprec - 8)
    for a, _, _, dx, dy, cx0, cy0 in comps:
        if dx != 1 or dy != 1 or cx0 != 0 or cy0 != 0 or \
                a.shape != (height, width):
            raise _Refused("OpenJPEG2000: tiles are not supported (a "
                           "component subsampled or off the origin)")
    n = len(comps)
    if space not in (GRAY, SYCC) and n < 3:
        raise _Refused("OpenJPEG2000: unsupported conversion from %d "
                       "components to 3 for SRGB image decoding" % n)
    if space == SYCC and n < 3:
        raise _Refused("OpenJPEG2000: unsupported conversion from %d "
                       "components to 3 for YCC image decoding" % n)
    # each sample shifted to 8 bits and cast (not saturated) to uint8
    planes = [(c[0] >> shift).astype(np.uint8) for c in comps[:3]]
    if space == GRAY:
        planes = planes[:1] * 3
    elif space == SYCC:
        planes = _yuv_to_rgb(*planes)
    return np.dstack(planes)
