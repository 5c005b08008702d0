"""AVIF reading for the port's `imgproc.imread_rgb`, bit for bit as
`cv2.imread(path)` (then BGR -> RGB) reads an AVIF file with OpenCV 5.0's
decoder (grfmt_avif.cpp over libavif 1.4.2 and libaom 3.14.1), the AV1
bitstream decoded by `native/avif.cc` (written for the port from the AV1
specification; no libaom, dav1d or libavif is vendored or linked) and
every decision cv2 and libavif make taken here:

- cv2 takes a file as AVIF when libavif's parse of its first 500 bytes
  succeeds or runs out of data (`_sniff`): an ftyp box first, naming
  avif or avis; the top-level boxes walked in order, every box header
  inside those 500 bytes; the meta box (and moov, for the avis brand)
  read whole or cut off at 500; then the data libavif reads during its
  parse (a grid's descriptor, the Exif item) must start inside them;
- the whole file is then parsed as libavif parses it: ftyp once, first;
  meta (version 0) with hdlr first (pre_defined 0, handler 'pict'), then
  iinf (v0/1, infe v2/v3), iloc (v0-2, construction 0 from the file or 1
  from idat, any extents, none of length 0), pitm, iref, iprp (ipco,
  whose known properties are parsed whether used or not, and ipma, whose
  essential flag is honoured: an unknown essential property refuses the
  file, irot, imir and clap must be essential); every box and item's
  data inside the file;
- the image is the primary item (av01, or a grid of av01 tiles of 64x64
  or more), or, when the major brand is avis, the first sample of the
  first av01 track (`_track`: tkhd with a nonzero ID, an elst of one
  entry of nonzero duration if edts is there, the box versions libavif
  reads, stsc/stsz/stco agreeing on the samples, every sample inside
  the file, av1C and colr from the sample entry, the track's size that
  of the frame); an av01 item needs av1C and ispe, a pixi must give
  av1C's depth; av1C's monochrome flag makes cv2 read grey; the alpha
  item (auxl + auxC) is decoded, then dropped; irot, imir and clap are
  read and not applied (cv2 applies none);
- the AV1 data: the sequence header's level must be one libaom defines
  and its trailing bits a 1 then 0s, a frame header OBU's too, the
  alignment bits after a header 0; each tile must end where libaom's
  reader says (no overrun by libaom's count, which is 14 bits short of
  the specification's, then a 1 bit and zero padding);
- colour: the nclx colr box, else the sequence header's; libavif's
  conversion as cv2's build runs it (see mn_avif_to_rgb): libyuv's
  fixed point for BT.601 (matrices 2, 5, 6), BT.709 (1) and BT.2020 (9),
  and for the chroma-derived matrix (12) with those primaries (bilinear
  chroma; samples deeper than 8 bits shifted down first), libavif's
  float path for identity (0, 4:4:4 only), YCgCo (8, full range only),
  FCC (4), SMPTE 240 (7), 12 with other primaries (kr, kb derived from
  them) and 15; grey (4:0:0) as cv2 reads grey, rounding deeper samples
  to 8 bits;
- the Exif item linked to the image (cdsc) must give a TIFF header at
  its offset; cv2 reads the orientation from the item past the offset
  field and applies it (`jpeg.orient`);
- cv2's image size limits (2^20 a side, 2^30 pixels) and libavif's
  (16384 x 16384 pixels, 32768 a side) apply.

What still raises "AVIF ..., not yet read by the port": a frame whose
output the in-loop filters would change (a luma loop-filter level other
than 0, non-zero CDEF strengths, loop restoration), superres, film grain
and quantizer matrices; and an ispe (or an avis track's size) that
differs from the AV1 frame's, which libavif rescales with libyuv's
scaler.  What cv2 refuses
raises ValueError naming the file and the cause.  What `cv2.imread`
returns for each variant, probed on cv2's, Pillow's and
`tests/avif_craft.py`'s files (each row held by
`tests/test_torch_port_avif.py`):

  variant                                          cv2.imread / port
  AV1 lossless (identity 4:4:4, BT.601 4:2:0),     read, bit-equal
    lossy with the filters off; 8, 10, 12 bits;
    4:4:4, 4:2:2, 4:2:0, 4:0:0; tiles; 128 SBs;
    palette, IntraBC, CfL, filter intra
  loop filter, CDEF, restoration, superres, film   read / not yet read
    grain, quantizer matrices (cv2's q<100 files)
  no pixi; no colr; ICC colr; nclx + ICC           read
  pixi depth other than the frame's; no ispe;      None / ValueError
    no av1C; an unknown essential property;
    non-essential irot, imir or clap
  irot 1-3, imir 0-1, clap (essential)             read, not applied
  alpha item (Pillow's RGBA)                       read, alpha dropped
  Exif item, orientations 1-8                      read, turned
  Exif item with a bad TIFF offset                 None / ValueError
  grid of av01 tiles (mdat or idat)                read
  grid descriptor or Exif starting past byte 500,  None / ValueError
    meta past byte 500, mdat before a long meta
  ispe or tkhd other than the frame's size         rescaled / ValueError
  avis sequence (Pillow's save_all)                the first frame
  avis with a moov libavif refuses (every moov     None / ValueError
    bit flipped in turn)
  ftyp without avif/avis; avis brand, no moov      None / ValueError
  matrices 3, 10, 11, 13, 14, 16+; YCgCo limited;  None / ValueError
    identity with subsampled chroma
  matrix 12 with primaries 4, 7, 8, 10-12, 22, or  read (kr, kb derived)
    unknown primaries (BT.709's)
  av1C monochrome over a colour frame              grey
  a frame header OBU and one tile group per tile   read
  truncated, corrupt (a level libaom does not      None / ValueError
    define, bad trailing or alignment bits, a
    tile overrun or bad padding, nonzero nclx
    reserved bits, box versions libavif refuses)

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
                   "avif.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None

SIGNATURE_SIZE = 500  # cv2's kAvifSignatureSize
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30  # cv2's CV_IO_MAX_IMAGE_*
AVIF_SIZE_LIMIT, AVIF_DIMENSION_LIMIT = 16384 * 16384, 32768
NOT_YET = "not yet read by the port"
_UNIQUE_META = (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf", b"iref")
_TRANSFORMS = (b"irot", b"imir", b"clap")
#: properties libavif knows; any other one marked essential refuses
_KNOWN = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot",
          b"imir", b"pixi", b"a1op", b"lsel", b"a1lx", b"clli", b"cmin",
          b"cmex", b"amve", b"reve", b"ndwt", b"mdcv", b"tmap")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")


def library_path():
    return _host_build.library_path(SRC, CXX_FLAGS)


def build():
    """Compile native/avif.cc unless its library exists; returns the
    library's path."""
    return _host_build.build(SRC, CXX_FLAGS)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.mn_avif_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int]
            lib.mn_avif_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int]
            lib.mn_avif_to_rgb.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_int]
            lib.mn_avif_counter_name.restype = ctypes.c_char_p
            for fn in ("mn_avif_probe", "mn_avif_decode", "mn_avif_to_rgb"):
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def counter_names():
    """Names of the coverage counters `decode_planes` can return."""
    lib = _load()
    return [lib.mn_avif_counter_name(i).decode()
            for i in range(lib.mn_avif_counter_count())]


class _Refused(Exception):
    """libavif refuses the file (cv2.imread returns None)."""


class _Truncated(Exception):
    """A read ran past the data (libavif's AVIF_RESULT_TRUNCATED_DATA)."""


class _IOError(Exception):
    """A read started past the data (avifIOMemoryRead's IO error)."""


# ---------------------------------------------------------------- boxes

class _Stream:
    """Big-endian reader over data[start:end] (libavif's avifROStream)."""

    def __init__(self, data, start=0, end=None):
        self.data, self.pos = data, start
        self.end = len(data) if end is None else end

    def left(self):
        return self.end - self.pos

    def take(self, n):
        if n > self.left():
            raise _Refused("box payload runs short")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, n):
        return int.from_bytes(self.take(n), "big")

    def full(self):
        v = self.u(4)
        return v >> 24, v & 0xFFFFFF

    def header(self, top=False):
        """(type, payload start, payload end, size-zero) of the next box."""
        start = self.pos
        size, typ = self.u(4), self.take(4)
        if size == 1:
            size = self.u(8)
        if typ == b"uuid":
            self.take(16)
        head = self.pos - start
        if size == 0:
            if not top:
                raise _Refused("a box of size 0 inside a box")
            return typ, self.pos, None, True
        if size < head:
            raise _Refused("box %r smaller than its header" % typ)
        return typ, self.pos, start + size, False

    def children(self):
        """[(type, start, end)] of the boxes filling the rest."""
        out = []
        while self.left():
            typ, a, b, _ = self.header()
            if b > self.end:
                raise _Refused("box %r runs past its parent" % typ)
            out.append((typ, a, b))
            self.pos = b
        return out

    def cstring(self):
        i = self.data.find(b"\0", self.pos, self.end)
        if i < 0:
            raise _Refused("unterminated string")
        out = self.data[self.pos:i]
        self.pos = i + 1
        return out


class _Reader:
    """libavif's avifIOMemory over `data`: a read starting past the end
    fails, one running past it comes back short."""

    def __init__(self, data):
        self.data = data

    def read(self, offset, size):
        if offset > len(self.data):
            raise _IOError("read at %d past %d bytes" % (offset,
                                                         len(self.data)))
        return self.data[offset:offset + size]


def _brands(payload):
    s = _Stream(payload)
    major, _ = s.take(4), s.take(4)
    if s.left() % 4:
        raise _Refused("ftyp brands not a multiple of 4 bytes")
    compat = [s.take(4) for _ in range(s.left() // 4)]
    return major, compat


def _top_level(rd):
    """libavif's avifParse: {ftyp brands, meta and moov payload spans}.
    Raises _Truncated where the data runs out first."""
    pos, out = 0, {"meta": None, "moov": None, "major": None}
    needs_meta = needs_moov = False
    ftyp_seen = False
    data = rd.data
    while True:
        head = rd.read(pos, 32)
        if not head:
            break
        s = _Stream(head)
        try:
            typ, a, b, zero = s.header(top=True)
        except _Refused:
            if len(head) < 32 and len(head) + pos == len(data):
                raise _Truncated("box header cut off")
            raise
        body = pos + a
        size = (b - a) if not zero else None
        if typ in (b"ftyp", b"meta", b"moov"):
            n = len(data) - body if zero else size
            got = rd.read(body, n)
            if not zero and len(got) != size:
                raise _Truncated("box %r cut off" % typ)
            end = body + len(got)
        else:
            end = body + (size if size is not None else len(data) - body)
        if not ftyp_seen and typ != b"ftyp":
            raise _Refused("the first box is %r, not ftyp" % typ)
        if typ == b"ftyp":
            if ftyp_seen:
                raise _Refused("a second ftyp")
            major, compat = _brands(data[body:end])
            brands = [major] + compat
            if b"avif" not in brands and b"avis" not in brands:
                raise _Refused("ftyp names neither avif nor avis")
            ftyp_seen = True
            out["major"] = major
            needs_meta = b"avif" in brands
            needs_moov = b"avis" in brands
        elif typ in (b"meta", b"moov"):
            key = typ.decode()
            if out[key] is not None:
                raise _Refused("a second %s box" % key)
            out[key] = (body, end)
        pos = end
        if ftyp_seen and (not needs_meta or out["meta"]) and (
                not needs_moov or out["moov"]):
            return out
    if not ftyp_seen:
        raise _Refused("no ftyp box")
    if (needs_meta and not out["meta"]) or (needs_moov and not out["moov"]):
        raise _Truncated("no meta or moov box")
    return out


# ------------------------------------------------------------------ meta

def _parse_meta(data, span):
    """Items, properties and references of the meta box."""
    s = _Stream(data, *span)
    version, _ = s.full()
    if version != 0:
        raise _Refused("meta version %d" % version)
    meta = {"items": {}, "props": [], "primary": None, "refs": [],
            "idat": None, "iloc": None}
    seen = set()
    for i, (typ, a, b) in enumerate(s.children()):
        if i == 0 and typ != b"hdlr":
            raise _Refused("meta's first box is %r, not hdlr" % typ)
        if typ in _UNIQUE_META:
            if typ in seen:
                raise _Refused("a second %r in meta" % typ)
            seen.add(typ)
        c = _Stream(data, a, b)
        if typ == b"hdlr":
            _version(c, typ, (0,))
            if c.u(4):
                raise _Refused("hdlr pre_defined is not 0")
            if c.take(4) != b"pict":
                raise _Refused("hdlr handler is not pict")
            c.take(12)  # reserved, which libavif does not check
            c.cstring()
        elif typ == b"pitm":
            v = _version(c, typ, (0, 1))
            meta["primary"] = c.u(2 if v == 0 else 4)
        elif typ == b"idat":
            meta["idat"] = (a, b)
        elif typ == b"iinf":
            _parse_iinf(c, meta["items"])
        elif typ == b"iloc":
            meta["iloc"] = c
        elif typ == b"iref":
            v = _version(c, typ, (0, 1))
            w = 2 if v == 0 else 4
            for rt, ra, rb in c.children():
                r = _Stream(data, ra, rb)
                frm = r.u(w)
                to = [r.u(w) for _ in range(r.u(2))]
                meta["refs"].append((rt, frm, to))
        elif typ == b"iprp":
            _parse_iprp(data, c, meta)
    if meta["iloc"] is not None:
        _parse_iloc(meta["iloc"], meta["items"])
    return meta


def _version(c, typ, allowed):
    """The version of a full box, refused unless libavif reads it."""
    v, _ = c.full()
    if v not in allowed:
        raise _Refused("%r version %d" % (typ, v))
    return v


def _parse_iinf(c, items):
    v = _version(c, b"iinf", (0, 1))
    n = c.u(2 if v == 0 else 4)
    kids = c.children()
    if len(kids) != n:
        raise _Refused("iinf counts %d entries, holds %d" % (n, len(kids)))
    for typ, a, b in kids:
        if typ != b"infe":
            raise _Refused("iinf holds %r" % typ)
        e = _Stream(c.data, a, b)
        ev, flags = e.full()
        if ev < 2:
            continue
        iid = e.u(2 if ev == 2 else 4)
        e.u(2)
        ityp = e.take(4)
        e.cstring()
        if ityp == b"mime":
            e.cstring()
        if iid in items:
            raise _Refused("item %d listed twice" % iid)
        items[iid] = {"type": ityp, "hidden": flags & 1, "props": [],
                      "extents": None, "method": 0}


def _parse_iloc(c, items):
    v = _version(c, b"iloc", (0, 1, 2))
    b0, b1 = c.u(1), c.u(1)
    off_size, len_size, base_size = b0 >> 4, b0 & 15, b1 >> 4
    idx_size = b1 & 15 if v in (1, 2) else 0
    for n in (off_size, len_size, base_size, idx_size):
        if n not in (0, 4, 8):
            raise _Refused("iloc field size %d" % n)
    count = c.u(2 if v < 2 else 4)
    seen = set()
    for _ in range(count):
        iid = c.u(2 if v < 2 else 4)
        if iid in seen:
            raise _Refused("item %d located twice" % iid)
        seen.add(iid)
        method = c.u(2) & 15 if v in (1, 2) else 0
        if method > 1:
            raise _Refused("iloc construction method %d" % method)
        c.u(2)  # data_reference_index, which libavif ignores
        base = c.u(base_size)
        extents = []
        for _ in range(c.u(2)):
            if idx_size:
                c.u(idx_size)
            off, n = base + c.u(off_size), c.u(len_size)
            if n == 0:
                raise _Refused("item %d has an extent of length 0" % iid)
            extents.append((off, n))
        if iid in items:
            items[iid]["extents"] = extents
            items[iid]["method"] = method


def _parse_iprp(data, c, meta):
    kids = c.children()
    if not kids or kids[0][0] != b"ipco":
        raise _Refused("iprp without ipco first")
    props = [(t, data[a:b]) for t, a, b in _Stream(data, *kids[0][1:])
             .children()]
    for t, p in props:
        _check_property(t, p)
    meta["props"] = props
    seen = set()
    for typ, a, b in kids[1:]:
        if typ != b"ipma":
            continue
        m = _Stream(data, a, b)
        v, flags = m.full()
        if v > 1:
            raise _Refused("ipma version %d" % v)
        for _ in range(m.u(4)):
            iid = m.u(2 if v < 1 else 4)
            if iid in seen:
                raise _Refused("item %d associated twice" % iid)
            seen.add(iid)
            lst = []
            for _ in range(m.u(1)):
                x = m.u(2) if flags & 1 else m.u(1)
                bits = 15 if flags & 1 else 7
                ess, idx = x >> bits, x & ((1 << bits) - 1)
                if idx == 0:
                    continue
                if idx > len(props):
                    raise _Refused("property index %d past ipco" % idx)
                lst.append((ess, idx - 1))
            if iid in meta["items"]:
                meta["items"][iid]["props"] = lst


def _check_property(typ, p):
    """libavif parses every property it knows when it reads ipco."""
    s = _Stream(p)
    if typ in (b"ispe", b"pixi", b"auxC"):
        _version(s, typ, (0,))
    if typ == b"ispe":
        s.take(8)
    elif typ == b"pixi":
        n = s.u(1)
        s.take(n)
    elif typ == b"auxC":
        s.cstring()
    elif typ == b"av1C":
        if len(p) < 4 or p[0] != 0x81:
            raise _Refused("av1C marker or version")
    elif typ == b"colr":
        kind = s.take(4)
        if kind == b"nclx":
            if s.take(7)[6] & 0x7F:
                raise _Refused("nclx reserved bits set")
    elif typ in (b"irot", b"imir"):
        s.take(1)
    elif typ == b"clap":
        s.take(32)
    elif typ == b"pasp":
        s.take(8)


def _prop(meta, item, typ):
    """(essential, payload) of an item's first property of `typ`."""
    for ess, idx in item["props"]:
        t, p = meta["props"][idx]
        if t == typ:
            return ess, p
    return None


def _props(meta, item, typ):
    return [meta["props"][idx][1] for _, idx in item["props"]
            if meta["props"][idx][0] == typ]


def _item_data(data, meta, iid, rd=None):
    item = meta["items"][iid]
    if item["extents"] is None:
        raise _Refused("item %d has no location" % iid)
    if item["method"] == 1:
        if meta["idat"] is None:
            raise _Refused("item %d in a missing idat" % iid)
        src = data[slice(*meta["idat"])]
    else:
        src = data
    out = b""
    for off, n in item["extents"]:
        if rd is not None and item["method"] == 0:
            got = rd.read(off, n)
            if len(got) != n:
                raise _Truncated("item %d cut off" % iid)
            out += got
            continue
        if off + n > len(src):
            raise _Refused("item %d runs past the %s" % (
                iid, "idat" if item["method"] else "file"))
        out += src[off:off + n]
    return out


def _check_props(meta, iid):
    item = meta["items"][iid]
    for ess, idx in item["props"]:
        t = meta["props"][idx][0]
        if ess and t not in _KNOWN:
            raise _Refused("item %d has an unknown essential property %r"
                           % (iid, t))
        if t in _TRANSFORMS and not ess:
            raise _Refused("item %d's %r is not marked essential" % (iid, t))


def _exif_item(meta, iid):
    for t, frm, to in meta["refs"]:
        if t == b"cdsc" and iid in to and frm in meta["items"] and \
                meta["items"][frm]["type"] == b"Exif":
            return frm
    return None


def _exif(payload):
    """The Exif block libavif hands cv2: the item after its 32-bit TIFF
    header offset, which must point at a TIFF header."""
    if len(payload) < 4:
        raise _Refused("Exif item shorter than its offset")
    off = struct.unpack_from(">I", payload)[0]
    if payload[4 + off:8 + off] not in (b"II*\0", b"MM\0*"):
        raise _Refused("Exif item's TIFF header offset is wrong")
    return payload[4:]


# -------------------------------------------------------------- sniffing

def _sniff(data):
    """Raises _Refused unless libavif's parse of the first 500 bytes
    succeeds or runs out of data, as cv2's checkSignature requires."""
    rd = _Reader(data[:SIGNATURE_SIZE])
    try:
        top = _top_level(rd)
        if top["meta"] is None:
            return
        meta = _parse_meta(rd.data, top["meta"])
        iid = meta["primary"]
        if iid is None or iid not in meta["items"]:
            return
        if meta["items"][iid]["type"] == b"grid":
            _item_data(rd.data, meta, iid, rd)
        ex = _exif_item(meta, iid)
        if ex is not None:
            _item_data(rd.data, meta, ex, rd)
    except (_Truncated, _Refused):
        # libavif's parse returns TRUNCATED_DATA (accepted) for any
        # structure cut off at 500 bytes; a structural error shows in the
        # full parse as well
        return
    except _IOError as e:
        raise _Refused("cv2 does not take it for AVIF (%s)" % e)


# ---------------------------------------------------------------- tracks

def _children(data, a, b, unique=()):
    kids = _Stream(data, a, b).children()
    seen = set()
    for t, _, _ in kids:
        if t in unique:
            if t in seen:
                raise _Refused("a second %r" % t)
            seen.add(t)
    return {t: (x, y) for t, x, y in reversed(kids)}


def _track(data, a, b):
    """The first sample of a trak box as libavif reads it: (payload,
    av1C, colr payloads, (width, height)), or None for a track without
    av01 samples."""
    kids = _children(data, a, b, (b"tkhd", b"mdia", b"edts"))
    if b"tkhd" not in kids or b"mdia" not in kids:
        raise _Refused("trak without tkhd or mdia")
    t = _Stream(data, *kids[b"tkhd"])
    v = _version(t, b"tkhd", (0, 1))
    n = 8 if v else 4
    t.take(2 * n)
    if t.u(4) == 0:
        raise _Refused("track ID 0")
    t.take(4 + n + 8 + 8 + 36)
    size = (t.u(4) >> 16, t.u(4) >> 16)
    if b"edts" in kids:
        e = _children(data, *kids[b"edts"])
        if b"elst" not in e:
            raise _Refused("edts without elst")
        el = _Stream(data, *e[b"elst"])
        v = _version(el, b"elst", (0, 1))
        if el.u(4) != 1:
            raise _Refused("elst with other than one entry")
        if el.u(8 if v else 4) == 0:
            raise _Refused("elst segment of duration 0")
    md = _children(data, *kids[b"mdia"], (b"mdhd", b"hdlr", b"minf"))
    if b"minf" not in md:
        raise _Refused("mdia without minf")
    if b"mdhd" in md:
        _version(_Stream(data, *md[b"mdhd"]), b"mdhd", (0, 1))
    if b"hdlr" in md:
        h = _Stream(data, *md[b"hdlr"])
        _version(h, b"hdlr", (0,))
        if h.u(4):
            raise _Refused("hdlr pre_defined is not 0")
        h.take(16)
        h.cstring()
    mi = _children(data, *md[b"minf"])
    if b"stbl" not in mi:
        raise _Refused("minf without stbl")
    st = _children(data, *mi[b"stbl"], (b"stsd", b"stts", b"stsc", b"stsz",
                                        b"stco", b"co64", b"stss"))
    for k in (b"stsd", b"stsc", b"stsz"):
        if k not in st:
            raise _Refused("stbl without %r" % k)
    if b"stco" not in st and b"co64" not in st:
        raise _Refused("stbl without chunk offsets")
    sd = _Stream(data, *st[b"stsd"])
    _version(sd, b"stsd", (0, 1))
    entries = sd.u(4)
    if entries == 0:
        raise _Refused("stsd without entries")
    av1c, colr = None, []
    for i in range(entries):
        typ, x, y, _ = sd.header()
        if y > sd.end:
            raise _Refused("sample entry past stsd")
        sd.pos = y
        if i == 0 and typ == b"av01":
            for ct, p, q in _Stream(data, x + 78, y).children():
                _check_property(ct, data[p:q])
                if ct == b"av1C":
                    av1c = data[p:q]
                elif ct == b"colr":
                    colr.append(data[p:q])
    if b"stts" in st:
        tt = _Stream(data, *st[b"stts"])
        _version(tt, b"stts", (0,))
        tt.take(8 * tt.u(4))
    if b"stss" in st:
        ss = _Stream(data, *st[b"stss"])
        _version(ss, b"stss", (0,))
        ss.take(4 * ss.u(4))
    sc = _Stream(data, *st[b"stsc"])
    _version(sc, b"stsc", (0,))
    runs = [(sc.u(4), sc.u(4), sc.u(4)) for _ in range(sc.u(4))]
    if not runs or runs[0][0] != 1 or any(
            r[0] <= q[0] for q, r in zip(runs, runs[1:])):
        raise _Refused("stsc runs")
    sz = _Stream(data, *st[b"stsz"])
    _version(sz, b"stsz", (0,))
    fixed, count = sz.u(4), sz.u(4)
    sizes = [fixed] * count if fixed else [sz.u(4) for _ in range(count)]
    key = b"stco" if b"stco" in st else b"co64"
    co = _Stream(data, *st[key])
    _version(co, key, (0,))
    offsets = [co.u(4 if key == b"stco" else 8) for _ in range(co.u(4))]
    if not offsets or not sizes:
        raise _Refused("a track without samples")
    samples, k = [], 0
    for c, off in enumerate(offsets, 1):
        per = [r[1] for r in runs if r[0] <= c][-1]
        for _ in range(per):
            if k >= len(sizes):
                raise _Refused("stsc gives more samples than stsz")
            samples.append((off, sizes[k]))
            off += sizes[k]
            k += 1
    if k != len(sizes):
        raise _Refused("stsc gives fewer samples than stsz")
    if any(o + n > len(data) for o, n in samples):
        raise _Refused("a sample runs past the file")
    if av1c is None:
        return None
    off, n = samples[0]
    return data[off:off + n], av1c, colr, size


def _first_sample(data, span):
    """libavif's image of an avis file: the first sample of its first
    av01 track."""
    for t, a, b in _Stream(data, *span).children():
        if t == b"trak":
            got = _track(data, a, b)
            if got is not None:
                return got
    raise _Refused("an avis file without an av01 track")


# ------------------------------------------------------------- decoding

def decode_planes(obus, counters=None):
    """(info, [Y, U, V]) of an AV1 item: info = {width, height, depth,
    mono, ssx, ssy, range, cp, tc, mc}; planes uint16 (U, V None when
    mono).  `counters`, an int64 array of counter_names()'s length, gets
    the coverage counts."""
    lib = _load()
    info = np.zeros(16, np.int32)
    err = ctypes.create_string_buffer(256)
    rc = lib.mn_avif_probe(obus, len(obus), info.ctypes.data, err, len(err))
    if rc == 0:
        w, h, bd, mono, ssx, ssy = (int(v) for v in info[:6])
        if w * h > AVIF_SIZE_LIMIT or max(w, h) > AVIF_DIMENSION_LIMIT:
            raise _Refused("AV1 frame %dx%d past libavif's limits" % (w, h))
        y = np.zeros((h, w), np.uint16)
        cw, ch = (w + ssx) >> ssx, (h + ssy) >> ssy
        u = np.zeros((ch, cw), np.uint16)
        v = np.zeros((ch, cw), np.uint16)
        rc = lib.mn_avif_decode(
            obus, len(obus), y.ctypes.data, u.ctypes.data, v.ctypes.data,
            None if counters is None else counters.ctypes.data, err,
            len(err))
    if rc == 2:
        raise NotImplementedError(err.value.decode())
    if rc:
        raise _Refused("AV1: %s" % err.value.decode())
    keys = ("width", "height", "depth", "mono", "ssx", "ssy", "csp",
            "range", "cp", "tc", "mc")
    meta = dict(zip(keys, (int(x) for x in info[:11])))
    return meta, [y] + ([None, None] if mono else [u, v])


def _nclx_of(colrs):
    for p in colrs:
        if p[:4] == b"nclx" and len(p) >= 11:
            cp, tc, mc = struct.unpack_from(">HHH", p, 4)
            return cp, tc, mc, p[10] >> 7
    return None


def _nclx(meta, item):
    return _nclx_of(_props(meta, item, b"colr"))


def _decode_item(data, meta, iid, counters):
    item = meta["items"][iid]
    _check_props(meta, iid)
    if _prop(meta, item, b"av1C") is None:
        raise _Refused("item %d has no av1C" % iid)
    ispe = _prop(meta, item, b"ispe")
    if ispe is None:
        raise _Refused("item %d has no ispe" % iid)
    s = _Stream(ispe[1], 4)
    iw, ih = s.u(4), s.u(4)
    if iw == 0 or ih == 0 or iw * ih > AVIF_SIZE_LIMIT or \
            max(iw, ih) > AVIF_DIMENSION_LIMIT:
        raise _Refused("ispe %dx%d past libavif's limits" % (iw, ih))
    c2 = _prop(meta, item, b"av1C")[1][2]
    av1c_depth = 12 if c2 & 0x20 else 10 if c2 & 0x40 else 8
    pixi = _prop(meta, item, b"pixi")
    if pixi is not None:
        p = _Stream(pixi[1], 4)
        depths = [p.u(1) for _ in range(p.u(1))]
        if not depths or any(d != av1c_depth for d in depths):
            raise _Refused("pixi depth %s, av1C's %d" % (depths, av1c_depth))
    info, planes = decode_planes(_item_data(data, meta, iid), counters)
    # cv2 picks a grey image by av1C's monochrome flag
    info["grey"] = bool(c2 & 0x10)
    if (iw, ih) != (info["width"], info["height"]):
        raise NotImplementedError(
            "ispe %dx%d other than the AV1 frame's %dx%d (libavif rescales)"
            % (iw, ih, info["width"], info["height"]))
    return info, planes


def _grid(data, meta, iid, counters):
    desc = _Stream(_item_data(data, meta, iid))
    version, flags = desc.u(1), desc.u(1)
    if version != 0:
        raise _Refused("grid version %d" % version)
    rows, cols = desc.u(1) + 1, desc.u(1) + 1
    n = 4 if flags & 1 else 2
    W, H = desc.u(n), desc.u(n)
    tiles = [to for t, frm, to in meta["refs"] if t == b"dimg" and frm == iid]
    tiles = tiles[0] if tiles else []
    if len(tiles) != rows * cols:
        raise _Refused("grid of %dx%d with %d tiles" % (rows, cols,
                                                        len(tiles)))
    decoded = [_decode_item(data, meta, t, counters) for t in tiles]
    info = decoded[0][0]
    tw, th = info["width"], info["height"]
    for i, _ in decoded[1:]:
        if any(i[k] != info[k] for k in ("width", "height", "depth",
                                         "mono", "ssx", "ssy", "range",
                                         "mc", "cp", "tc")):
            raise _Refused("grid tiles differ")
    if tw < 64 or th < 64:
        raise _Refused("grid tiles of %dx%d, under 64x64" % (tw, th))
    if tw * cols < W or th * rows < H or tw * (cols - 1) >= W or \
            th * (rows - 1) >= H:
        raise _Refused("grid tiles do not cover the canvas")
    planes = []
    for p in range(1 if info["mono"] else 3):
        sx, sy = (info["ssx"], info["ssy"]) if p else (0, 0)
        out = np.zeros((rows * ((th + sy) >> sy), cols * ((tw + sx) >> sx)),
                       np.uint16)
        for k, (_, pl) in enumerate(decoded):
            r, c = divmod(k, cols)
            a = pl[p]
            out[r * a.shape[0]:(r + 1) * a.shape[0],
                c * a.shape[1]:(c + 1) * a.shape[1]] = a
        planes.append(out[:(H + sy) >> sy, :(W + sx) >> sx])
    if info["mono"]:
        planes += [None, None]
    info = dict(info, width=W, height=H)
    return info, planes


def _to_rgb(info, planes, colour):
    cp, tc, mc, full = colour
    w, h = info["width"], info["height"]
    fmt = 3 if info["mono"] or info.get("grey") else {
        (0, 0): 0, (1, 0): 1, (1, 1): 2}.get((info["ssx"], info["ssy"]))
    if fmt is None:
        raise _Refused("4:4:0 chroma")
    y = np.ascontiguousarray(planes[0])
    u = np.ascontiguousarray(planes[1]) if planes[1] is not None else y
    v = np.ascontiguousarray(planes[2]) if planes[2] is not None else y
    rgb = np.zeros((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _load().mn_avif_to_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data,
                              w, h, info["depth"], fmt, mc, cp, full,
                              rgb.ctypes.data, err, len(err)):
        raise _Refused("libavif's conversion refuses %s"
                       % err.value.decode())
    return rgb


def read_avif(data, counters=None):
    """(RGB, EXIF orientation) of an AVIF file as cv2 reads it, or
    _Refused / NotImplementedError."""
    _sniff(data)
    rd = _Reader(data)
    try:
        top = _top_level(rd)
    except _Truncated as e:
        raise _Refused("truncated: %s" % e)
    except _IOError as e:
        raise _Refused(str(e))
    meta = _parse_meta(data, top["meta"]) if top["meta"] else None
    track = None
    if top["major"] == b"avis":
        if top["moov"] is None:
            raise _Refused("avis brand without a moov box")
        track = _first_sample(data, top["moov"])
    if track is not None:
        obus, av1c, colr, size = track
        info, planes = decode_planes(obus, counters)
        info["grey"] = bool(av1c[2] & 0x10)
        if size != (info["width"], info["height"]):
            raise NotImplementedError(
                "track size %dx%d other than the AV1 frame's %dx%d (libavif "
                "rescales)" % (size + (info["width"], info["height"])))
        colour = _nclx_of(colr)
        orientation = 0
    else:
        if meta is None:
            raise _Refused("no meta box")
        iid = meta["primary"]
        if iid is None or iid not in meta["items"]:
            raise _Refused("no primary item")
        item = meta["items"][iid]
        if item["type"] == b"grid":
            _check_props(meta, iid)
            info, planes = _grid(data, meta, iid, counters)
        elif item["type"] == b"av01":
            info, planes = _decode_item(data, meta, iid, counters)
        else:
            raise _Refused("primary item of type %r" % item["type"])
        colour = _nclx(meta, item)
        for t, frm, to in meta["refs"]:
            if t == b"auxl" and iid in to and frm in meta["items"]:
                aux = meta["items"][frm]
                urn = _prop(meta, aux, b"auxC")
                if aux["type"] == b"av01" and urn is not None and \
                        urn[1][4:].split(b"\0")[0] in ALPHA_URNS:
                    _decode_item(data, meta, frm, None)
        ex = _exif_item(meta, iid)
        orientation = 0
        if ex is not None:
            orientation = io.exif_orientation(_exif(_item_data(data, meta,
                                                               ex)))
    if colour is None:
        colour = (info["cp"], info["tc"], info["mc"], info["range"])
    w, h = info["width"], info["height"]
    if w > MAX_SIDE or h > MAX_SIDE or w * h > MAX_PIXELS:
        raise _Refused("image %dx%d past cv2's limits" % (w, h))
    return _to_rgb(info, planes, colour), orientation


def decode_avif(data, name="AVIF data"):
    """(H, W, 3) uint8 RGB of the AVIF file held in `data` (bytes), its
    EXIF orientation applied."""
    try:
        rgb, orientation = read_avif(bytes(data))
    except (_Refused, _Truncated, _IOError) as e:
        raise ValueError("%s: AVIF refused (%s)" % (name, e)) from None
    except NotImplementedError as e:
        raise ValueError("%s: AVIF with %s, %s" % (name, e, NOT_YET)) \
            from None
    return orient(rgb, orientation)
