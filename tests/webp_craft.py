"""WebP files for the tests that hold the port's WebP reader
(`mergenet_tpu_torch/data/webp.py`) to cv2's libwebp: an encoder over
the libwebp that Pillow bundles, driven through ctypes with a full
`WebPConfig` (cv2's quality knob never reaches token partitions, the
simple loop filter, segment counts, sharpness, `method`, `exact`,
near-lossless or the alpha plane's filtering and compression), and RIFF
chunk surgery for the extended (VP8X) layouts, animations, EXIF and
corrupt files.

Needs Pillow (its `pillow.libs/libwebp-*.so`, loaded after
`libsharpyuv-*.so` with RTLD_GLOBAL); the tests and
`tests/make_webp_fixtures.py` use it, the port never does."""

import ctypes
import glob
import os
import struct

import numpy as np

ENCODER_ABI = 0x0210

# ------------------------------------------------------------ containers

ALPHA_FLAG, ANIMATION_FLAG, EXIF_FLAG, ICCP_FLAG, XMP_FLAG = (
    0x10, 0x02, 0x08, 0x20, 0x04)


def chunk(tag, payload, size=None, pad=True):
    """A RIFF chunk; `size` overrides the size field, `pad` adds the pad
    byte an odd payload needs."""
    n = len(payload) if size is None else size
    body = tag + struct.pack("<I", n) + payload
    return body + (b"\0" if pad and len(payload) & 1 else b"")


def riff(body, size=None):
    """'RIFF' size 'WEBP' + the chunks in `body`."""
    n = 4 + len(body) if size is None else size
    return b"RIFF" + struct.pack("<I", n) + b"WEBP" + body


def chunks(data):
    """[(tag, payload)] of a RIFF WebP file's chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        (n,) = struct.unpack("<I", data[pos + 4:pos + 8])
        out.append((tag, data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def image_chunks(data):
    """The ALPH (if any) and VP8/VP8L chunks of a simple or extended
    still file, as raw chunk bytes."""
    return b"".join(chunk(t, p) for t, p in chunks(data)
                    if t in (b"ALPH", b"VP8 ", b"VP8L"))


def vp8x(flags, width, height):
    return chunk(b"VP8X", struct.pack("<I", flags)
                 + struct.pack("<I", width - 1)[:3]
                 + struct.pack("<I", height - 1)[:3])


def extended(data, flags=None, before=(), after=(), width=None, height=None):
    """A still file `data` rewritten as VP8X + `before` chunks + its
    image chunks + `after` chunks; the flags default to those the chunks
    imply."""
    img = image_chunks(data)
    w, h = size_of(data)
    extra = list(before) + list(after)
    if flags is None:
        flags = 0
        tags = [c[:4] for c in extra]
        if b"ALPH" in [t for t, _ in chunks(data)] or has_vp8l_alpha(data):
            flags |= ALPHA_FLAG
        flags |= EXIF_FLAG if b"EXIF" in tags else 0
        flags |= ICCP_FLAG if b"ICCP" in tags else 0
        flags |= XMP_FLAG if b"XMP " in tags else 0
    return riff(vp8x(flags, width or w, height or h) + b"".join(before)
                + img + b"".join(after))


def has_vp8l_alpha(data):
    for t, p in chunks(data):
        if t == b"VP8L":
            return bool((struct.unpack("<I", p[1:5])[0] >> 28) & 1)
    return False


def size_of(data):
    """(width, height) of a simple or extended still file's bitstream."""
    for t, p in chunks(data):
        if t == b"VP8 ":
            return (struct.unpack("<H", p[6:8])[0] & 0x3FFF,
                    struct.unpack("<H", p[8:10])[0] & 0x3FFF)
        if t == b"VP8L":
            v = struct.unpack("<I", p[1:5])[0]
            return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1
    raise ValueError("no VP8/VP8L chunk")


def anim(background=0, loops=0):
    return chunk(b"ANIM", struct.pack("<IH", background, loops))


def anmf(frame, x=0, y=0, duration=100, blend=True, dispose=False,
         width=None, height=None):
    """An ANMF chunk holding still file `frame`'s image chunks at (x, y)
    (even offsets: the format stores x/2, y/2)."""
    w, h = size_of(frame)
    flags = (0 if blend else 2) | (1 if dispose else 0)
    head = (struct.pack("<I", x // 2)[:3] + struct.pack("<I", y // 2)[:3]
            + struct.pack("<I", (width or w) - 1)[:3]
            + struct.pack("<I", (height or h) - 1)[:3]
            + struct.pack("<I", duration)[:3] + bytes([flags]))
    return chunk(b"ANMF", head + image_chunks(frame))


def animation(frames, canvas, background=0, flags=None, loops=0,
              before=(), after=()):
    """An animated file: VP8X (animation flag, plus alpha if asked) +
    ANIM + `frames` (ANMF chunks) on a canvas (width, height)."""
    if flags is None:
        flags = ANIMATION_FLAG | ALPHA_FLAG
    return riff(vp8x(flags, *canvas) + b"".join(before)
                + anim(background, loops) + b"".join(frames)
                + b"".join(after))


def exif_payload(orientation, big_endian=False, prefix=b""):
    """An EXIF chunk's payload: a TIFF header and IFD0 with one
    Orientation entry."""
    e = ">" if big_endian else "<"
    t = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    t += struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1,
                                               orientation, 0)
    return prefix + t + struct.pack(e + "I", 0)


# ------------------------------------------------------------ encoder

class Config(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR")
                 else ctypes.c_int) for name in (
        "lossless", "quality", "method", "image_hint", "target_size",
        "target_PSNR", "segments", "sns_strength", "filter_strength",
        "filter_sharpness", "filter_type", "autofilter",
        "alpha_compression", "alpha_filtering", "alpha_quality", "pass_",
        "show_compressed", "preprocessing", "partitions",
        "partition_limit", "emulate_jpeg_size", "thread_level",
        "low_memory", "near_lossless", "exact", "use_delta_palette",
        "use_sharp_yuv", "qmin", "qmax")]


class Picture(ctypes.Structure):
    _fields_ = [
        ("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
        ("y", ctypes.c_void_p), ("u", ctypes.c_void_p),
        ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
        ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p),
        ("a_stride", ctypes.c_int), ("pad1", ctypes.c_uint32 * 2),
        ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
        ("pad2", ctypes.c_uint32 * 3), ("writer", ctypes.c_void_p),
        ("custom_ptr", ctypes.c_void_p), ("extra_info_type", ctypes.c_int),
        ("extra_info", ctypes.c_void_p), ("stats", ctypes.c_void_p),
        ("error_code", ctypes.c_int), ("progress_hook", ctypes.c_void_p),
        ("user_data", ctypes.c_void_p), ("pad3", ctypes.c_uint32 * 3),
        ("pad4", ctypes.c_void_p), ("pad5", ctypes.c_void_p),
        ("pad6", ctypes.c_uint32 * 8), ("memory_", ctypes.c_void_p),
        ("memory_argb_", ctypes.c_void_p), ("pad7", ctypes.c_void_p * 2),
        ("spare", ctypes.c_uint8 * 256)]


class MemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32),
                ("spare", ctypes.c_uint8 * 64)]


_lib = None


def _load():
    global _lib
    if _lib is None:
        import PIL
        libs = os.path.join(os.path.dirname(os.path.dirname(
            PIL.__file__)), "pillow.libs")
        for pattern in ("libsharpyuv-*.so*", "libwebp-*.so*"):
            path = sorted(glob.glob(os.path.join(libs, pattern)))[0]
            lib = ctypes.CDLL(path, mode=ctypes.RTLD_GLOBAL)
        lib.WebPConfigInitInternal.argtypes = [
            ctypes.POINTER(Config), ctypes.c_int, ctypes.c_float,
            ctypes.c_int]
        lib.WebPPictureInitInternal.argtypes = [ctypes.POINTER(Picture),
                                                ctypes.c_int]
        for fn in ("WebPPictureImportRGB", "WebPPictureImportRGBA"):
            getattr(lib, fn).argtypes = [ctypes.POINTER(Picture),
                                         ctypes.c_void_p, ctypes.c_int]
        lib.WebPEncode.argtypes = [ctypes.POINTER(Config),
                                   ctypes.POINTER(Picture)]
        lib.WebPMemoryWriterInit.argtypes = [ctypes.POINTER(MemoryWriter)]
        lib.WebPMemoryWriterClear.argtypes = [ctypes.POINTER(MemoryWriter)]
        lib.WebPPictureFree.argtypes = [ctypes.POINTER(Picture)]
        _lib = lib
    return _lib


def encode(pixels, lossless=False, quality=75.0, **options):
    """A WebP file of (H, W, 3) RGB or (H, W, 4) RGBA uint8 `pixels`, as
    libwebp's WebPEncode writes it under a WebPConfig of
    `lossless`, `quality` and any other field of `Config` in `options`
    (e.g. segments=1, partitions=3, filter_type=0, filter_strength=60,
    filter_sharpness=7, method=0, exact=1, near_lossless=40,
    alpha_compression=0, alpha_filtering=2, pass_=3, autofilter=0)."""
    lib = _load()
    cfg = Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(quality), ENCODER_ABI):
        raise RuntimeError("WebPConfigInit failed")
    cfg.lossless = int(lossless)
    cfg.quality = quality
    for k, v in options.items():
        setattr(cfg, k, v)
    pic = Picture()
    if not lib.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI):
        raise RuntimeError("WebPPictureInit failed")
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, ch = pixels.shape
    pic.use_argb = int(lossless)
    pic.width, pic.height = w, h
    imp = lib.WebPPictureImportRGBA if ch == 4 else lib.WebPPictureImportRGB
    if not imp(ctypes.byref(pic), pixels.ctypes.data, w * ch):
        raise RuntimeError("WebPPictureImport failed")
    wr = MemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p)
    pic.custom_ptr = ctypes.addressof(wr)
    try:
        if not lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic)):
            raise RuntimeError("WebPEncode failed: error %d"
                               % pic.error_code)
        return ctypes.string_at(wr.mem, wr.size)
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))
        lib.WebPMemoryWriterClear(ctypes.byref(wr))


# ------------------------------------------------------------ VP8 rewriter

def _c_table(name):
    """A uint8 table of the port's webp.cc (the spec's tables, taken
    from libwebp), as bytes."""
    import re
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "mergenet_tpu_torch", "data", "native", "webp.cc")
    with open(src) as f:
        text = f.read()
    body = re.search(name + r"[^=]*=\s*\{([^}]*)\}", text).group(1)
    return bytes(int(v) for v in re.findall(r"\d+", body))


class _Dec:
    """A boolean decoder that records every (bit, probability) it
    reads into `self.rec`."""

    def __init__(self, d):
        self.d, self.p, self.value, self.range, self.bits = d, 0, 0, 254, -8
        self.rec = []
        self._load()

    def _load(self):
        b = self.d[self.p] if self.p < len(self.d) else 0
        self.p += 1
        self.value = (self.value << 8) | b
        self.bits += 8

    def get(self, prob):
        r = self.range
        if self.bits < 0:
            self._load()
        split = (r * prob) >> 8
        if (self.value >> self.bits) > split:
            r -= split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            r, bit = split + 1, 0
        sh = 7 ^ (r.bit_length() - 1)
        self.range, self.bits = (r << sh) - 1, self.bits - sh
        self.rec.append((bit, prob))
        return bit

    def val(self, n):
        v = 0
        for i in range(n - 1, -1, -1):
            v |= self.get(128) << i
        return v

    def sval(self, n):
        v = self.val(n)
        return -v if self.val(1) else v


class _Enc:
    """Arithmetic (boolean) encoder: the interval kept exactly, the code
    value its bottom, written with four bytes of padding."""

    def __init__(self):
        self.low, self.range, self.shifts = 0, 255, 0

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.low += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            self.low <<= 1
            self.shifts += 1

    def put_all(self, rec):
        for bit, prob in rec:
            self.put(bit, prob)

    def val(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1, 128)

    def sval(self, v, n):
        self.val(abs(v), n)
        self.val(int(v < 0), 1)

    def bytes(self):
        t = 8 + self.shifts
        n = -(-t // 8) + 4
        return (self.low << (8 * n - t)).to_bytes(n, "big")


_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
         (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))


def _parse_vp8(p):
    """Every syntax element of a VP8 key frame's payload `p`: the frame
    header fields, the recorded tail of partition 0's header (quant on),
    and per macroblock its segment id bits, the rest of its modes and its
    tokens, each as recorded (bit, probability) lists."""
    bits = p[0] | p[1] << 8 | p[2] << 16
    plen = bits >> 5
    w = (p[6] | p[7] << 8) & 0x3FFF
    h = (p[8] | p[9] << 8) & 0x3FFF
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    br = _Dec(p[10:10 + plen])
    hd = {"colorspace": br.val(1), "clamp": br.val(1)}
    hd["use_segment"] = br.val(1)
    hd["update_map"], hd["seg_data"] = 0, None
    if hd["use_segment"]:
        hd["update_map"] = br.val(1)
        if br.val(1):
            absolute = br.val(1)
            q = [br.sval(7) if br.val(1) else None for _ in range(4)]
            f = [br.sval(6) if br.val(1) else None for _ in range(4)]
            hd["seg_data"] = (absolute, q, f)
        hd["seg_probs"] = ([br.val(8) if br.val(1) else None
                            for _ in range(3)] if hd["update_map"] else None)
    hd["simple"], hd["level"], hd["sharpness"] = br.val(1), br.val(6), br.val(3)
    hd["lf_delta"] = br.val(1)
    hd["deltas"] = None
    if hd["lf_delta"] and br.val(1):
        hd["deltas"] = ([br.sval(6) if br.val(1) else None for _ in range(4)],
                        [br.sval(6) if br.val(1) else None for _ in range(4)])
    nparts = hd["parts"] = 1 << br.val(2)
    rest_start = len(br.rec)
    br.val(7)
    for _ in range(5):
        if br.val(1):
            br.sval(4)
    br.val(1)
    upd, dflt = _c_table("kCoeffsUpdateProba"), _c_table("kCoeffsProba0")
    probas = bytearray(dflt)
    for i in range(len(dflt)):
        if br.get(upd[i]):
            probas[i] = br.val(8)
    use_skip = br.val(1)
    skip_p = br.val(8) if use_skip else 0
    hd["rest"] = br.rec[rest_start:]
    bmodes = _c_table("kBModesProba")
    segp = [255 if v is None else v for v in (hd.get("seg_probs") or [])]
    # token partitions
    sizes, pos = [], 10 + plen + 3 * (nparts - 1)
    for k in range(nparts - 1):
        o = 10 + plen + 3 * k
        sizes.append(p[o] | p[o + 1] << 8 | p[o + 2] << 16)
    parts = []
    for k in range(nparts):
        n = sizes[k] if k < nparts - 1 else len(p) - pos
        parts.append(_Dec(p[pos:pos + n]))
        pos += n

    def prob(t, b, c, i):
        return probas[((t * 8 + b) * 3 + c) * 11 + i]

    def coeffs(td, t, ctx, n):
        pr = lambda b, c: [prob(t, b, c, i) for i in range(11)]
        pp = pr(_BANDS[n], ctx)
        while n < 16:
            if not td.get(pp[0]):
                return n
            while not td.get(pp[1]):
                n += 1
                pp = pr(_BANDS[n], 0)
                if n == 16:
                    return 16
            nb = _BANDS[n + 1]
            if not td.get(pp[2]):
                pp = pr(nb, 1)
            else:
                if not td.get(pp[3]):
                    if td.get(pp[4]):
                        td.get(pp[5])
                elif not td.get(pp[6]):
                    if not td.get(pp[7]):
                        td.get(159)
                    else:
                        td.get(165)
                        td.get(145)
                else:
                    b1 = td.get(pp[8])
                    b0 = td.get(pp[9 + b1])
                    for c in _CATS[2 * b1 + b0]:
                        td.get(c)
                pp = pr(nb, 2)
            td.get(128)  # sign
            n += 1
        return 16

    mbs = []
    intra_t = [0] * (4 * mbw)
    nz_t, nzdc_t = [0] * mbw, [0] * mbw
    for my in range(mbh):
        intra_l = [0] * 4
        row = []
        for mx in range(mbw):
            m = {}
            k = len(br.rec)
            seg = 0
            if hd["update_map"]:
                seg = (br.get(segp[1]) if not br.get(segp[0])
                       else br.get(segp[2]) + 2)
            m["seg"], m["seg_rec"] = seg, br.rec[k:]
            k = len(br.rec)
            m["skip"] = br.get(skip_p) if use_skip else 0
            i4 = not br.get(145)
            m["i4"] = i4
            if not i4:
                ym = (1 if br.get(128) else 3) if br.get(156) else \
                    (2 if br.get(163) else 0)
                intra_t[4 * mx:4 * mx + 4] = [ym] * 4
                intra_l = [ym] * 4
            else:
                for y in range(4):
                    ym = intra_l[y]
                    for x in range(4):
                        pb = bmodes[(intra_t[4 * mx + x] * 10 + ym) * 9:][:9]
                        if not br.get(pb[0]):
                            ym = 0
                        elif not br.get(pb[1]):
                            ym = 1
                        elif not br.get(pb[2]):
                            ym = 2
                        elif not br.get(pb[3]):
                            ym = 3 if not br.get(pb[4]) else (
                                4 if not br.get(pb[5]) else 5)
                        else:
                            ym = 6 if not br.get(pb[6]) else (
                                7 if not br.get(pb[7]) else (
                                    8 if not br.get(pb[8]) else 9))
                        intra_t[4 * mx + x] = ym
                    intra_l[y] = ym
            br.get(142) and br.get(114) and br.get(183)
            m["mode_rec"] = br.rec[k:]
            row.append(m)
        nz_l, nzdc_l = 0, 0
        td = parts[my % nparts]
        for mx, m in enumerate(row):
            k = len(td.rec)
            if m["skip"]:
                nz_t[mx] = nz_l = 0
                if not m["i4"]:
                    nzdc_t[mx] = nzdc_l = 0
            else:
                first, ac = 0, 3
                if not m["i4"]:
                    nz = coeffs(td, 1, nzdc_t[mx] + nzdc_l, 0)
                    nzdc_t[mx] = nzdc_l = int(nz > 0)
                    first, ac = 1, 0
                tnz, lnz = nz_t[mx] & 0xF, nz_l & 0xF
                for y in range(4):
                    l = lnz & 1
                    for x in range(4):
                        nz = coeffs(td, ac, l + (tnz & 1), first)
                        l = int(nz > first)
                        tnz = (tnz >> 1) | (l << 7)
                    tnz >>= 4
                    lnz = (lnz >> 1) | (l << 7)
                out_t, out_l = tnz, lnz >> 4
                for ch in (0, 2):
                    tnz, lnz = nz_t[mx] >> (4 + ch), nz_l >> (4 + ch)
                    for y in range(2):
                        l = lnz & 1
                        for x in range(2):
                            nz = coeffs(td, 2, l + (tnz & 1), 0)
                            l = int(nz > 0)
                            tnz = (tnz >> 1) | (l << 3)
                        tnz >>= 2
                        lnz = (lnz >> 1) | (l << 5)
                    out_t |= (tnz << 4) << ch
                    out_l |= (lnz & 0xF0) << ch
                nz_t[mx], nz_l = out_t & 0xFF, out_l & 0xFF
            m["tok_rec"] = td.rec[k:]
        mbs.append(row)
    return p[:10], hd, mbs


def vp8_rewrite(payload, partitions=None, colorspace=None, clamp=None,
                simple=None, level=None, sharpness=None, deltas=(),
                drop_map=False, seg_data=(), profile=None, scale=None):
    """VP8 key frame `payload` re-encoded with other frame-header fields
    and the same modes and tokens: `partitions` (log2 of the number of
    token partitions, 0-3), the colour space and clamping bits, the loop
    filter (`simple`, `level` 0-63, `sharpness` 0-7, `deltas`: None, or
    (ref deltas, mode deltas), 4 values or None each), `drop_map`
    (segment ids no longer sent: every macroblock uses segment 0),
    `seg_data` (None: the segments' quantisers and strengths not sent, or
    (absolute, 4 quantisers, 4 strengths)), the frame tag's `profile`
    (0-7) and the size fields' `scale` bits ((x, y), 0-3 each)."""
    head, hd, mbs = _parse_vp8(payload)
    nparts = hd["parts"] if partitions is None else 1 << partitions
    e = _Enc()
    e.val(hd["colorspace"] if colorspace is None else colorspace, 1)
    e.val(hd["clamp"] if clamp is None else clamp, 1)
    e.val(hd["use_segment"], 1)
    update_map = hd["update_map"] and not drop_map
    if hd["use_segment"]:
        e.val(update_map, 1)
        sd = hd["seg_data"] if seg_data == () else seg_data
        e.val(sd is not None, 1)
        if sd is not None:
            e.val(sd[0], 1)
            for vals, n in ((sd[1], 7), (sd[2], 6)):
                for v in vals:
                    e.val(v is not None, 1)
                    if v is not None:
                        e.sval(v, n)
        if update_map:
            for v in hd["seg_probs"]:
                e.val(v is not None, 1)
                if v is not None:
                    e.val(v, 8)
    e.val(hd["simple"] if simple is None else simple, 1)
    e.val(hd["level"] if level is None else level, 6)
    e.val(hd["sharpness"] if sharpness is None else sharpness, 3)
    dl = hd["deltas"] if deltas == () else deltas
    e.val(dl is not None, 1)
    if dl is not None:
        e.val(1, 1)
        for vals in dl:
            for v in vals:
                e.val(v is not None, 1)
                if v is not None:
                    e.sval(v, 6)
    e.val({1: 0, 2: 1, 4: 2, 8: 3}[nparts], 2)
    e.put_all(hd["rest"])
    for row in mbs:
        for m in row:
            if update_map:
                e.put_all(m["seg_rec"])
            e.put_all(m["mode_rec"])
    part0 = e.bytes()
    toks = [_Enc() for _ in range(nparts)]
    for y, row in enumerate(mbs):
        for m in row:
            toks[y % nparts].put_all(m["tok_rec"])
    toks = [t.bytes() for t in toks]
    head = bytearray(head)
    tag = (len(part0) << 5) | (1 << 4) | (
        ((head[0] >> 1) & 7 if profile is None else profile) << 1)
    head[0:3] = struct.pack("<I", tag)[:3]
    if scale is not None:
        head[7] = (head[7] & 0x3F) | (scale[0] << 6)
        head[9] = (head[9] & 0x3F) | (scale[1] << 6)
    sizes = b"".join(struct.pack("<I", len(t))[:3] for t in toks[:-1])
    return bytes(head) + part0 + sizes + b"".join(toks)


def with_vp8(data, payload):
    """Still file `data` with its VP8 chunk's payload replaced."""
    out = b"".join(chunk(t, payload if t == b"VP8 " else p)
                   for t, p in chunks(data))
    return riff(out)


# ------------------------------------------------------------ VP8L writer

class _Bits:
    """LSB-first bit writer."""

    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value, nbits):
        self.v |= (value & ((1 << nbits) - 1)) << self.n
        self.n += nbits

    def code(self, c, length):  # a prefix code, its first bit first
        for i in range(length - 1, -1, -1):
            self.put((c >> i) & 1, 1)

    def bytes(self):
        return self.v.to_bytes((self.n + 7) // 8, "little")


def _canonical(lens):
    """{symbol: (code, length)} of code lengths `lens`."""
    codes, code, prev = {}, 0, 0
    for length, s in sorted((l, s) for s, l in enumerate(lens) if l):
        code <<= length - prev
        codes[s] = (code, length)
        code += 1
        prev = length
    return codes


_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
             15)


class _Code:
    """A prefix code over an alphabet of `n` symbols, written to the
    stream: `simple` (one or two symbols, each 1 or 8 bits) or a complete
    code over the symbols `used` (all by default), its lengths sent
    through a two-symbol code-length code."""

    def __init__(self, n, used=None, simple=None):
        self.n, self.simple = n, simple
        if simple is not None:
            self.codes = ({simple[0]: (0, 0)} if len(set(simple)) == 1
                          else {s: (c, 1) for s, c in zip(sorted(simple),
                                                          (0, 1))})
            return
        used = sorted(set(range(n) if used is None else used))
        m = len(used)
        k = max(1, (m - 1).bit_length())
        lens = [0] * n
        for i, s in enumerate(used):  # 2m - 2^k of length k, the rest k-1
            lens[s] = k if i < 2 * m - (1 << k) else k - 1
        if m == 1:
            lens[used[0]] = 1  # a lone symbol: a code of no bits
        self.lens = lens
        self.codes = _canonical(lens) if m > 1 else {used[0]: (0, 0)}

    def write_header(self, w):
        if self.simple is not None:
            w.put(1, 1)
            w.put(len(self.simple) - 1, 1)
            first = self.simple[0]
            w.put(int(first > 1), 1)
            w.put(first, 8 if first > 1 else 1)
            if len(self.simple) == 2:
                w.put(self.simple[1], 8)
            return
        w.put(0, 1)
        vals = sorted(set(self.lens))
        cl = [0] * 19
        if len(vals) == 1:
            cl[vals[0]] = 1
        else:
            for v in vals[:2]:
                cl[v] = 1
            for v in vals[2:]:
                raise ValueError("more than two code lengths")
        w.put(19 - 4, 4)
        for i in range(19):
            w.put(cl[_CL_ORDER[i]], 3)
        w.put(0, 1)  # no max_symbol
        cl_codes = _canonical(cl) if len(vals) > 1 else {vals[0]: (0, 0)}
        for length in self.lens:
            w.code(*cl_codes[length])

    def write(self, w, s):
        w.code(*self.codes[s])


def _prefix(v):
    """(symbol, extra bits, extra value) of a copy length or distance
    code v >= 1."""
    d = v - 1
    if d < 4:
        return d, 0, 0
    hb = d.bit_length() - 1
    return 2 * hb + ((d >> (hb - 1)) & 1), hb - 1, d & ((1 << (hb - 1)) - 1)


def _image(w, ops, cache_bits=0, groups=None, meta=None):
    """The level-0 entropy-coded image `ops` (a list of ("lit", argb),
    ("copy", length, distance code) and ("cache", key)), with a colour
    cache of `cache_bits` and `groups` (a list of dicts of _Code per
    channel: green, red, blue, alpha, dist; one complete code each by
    default); `meta` = (bits, xsize, group index per tile, each op's
    pixel position (x, y)) sends an entropy image first."""
    if cache_bits:
        w.put(1, 1)
        w.put(cache_bits, 4)
    else:
        w.put(0, 1)
    ncache = (1 << cache_bits) if cache_bits else 0
    if groups is None:
        groups = [{}]
    full = []
    for g in groups:
        full.append({"green": g.get("green") or _Code(280 + ncache),
                     "red": g.get("red") or _Code(256),
                     "blue": g.get("blue") or _Code(256),
                     "alpha": g.get("alpha") or _Code(256),
                     "dist": g.get("dist") or _Code(40)})
    if meta is not None:
        bits, mx, tiles, _ = meta
        w.put(1, 1)
        w.put(bits - 2, 3)
        w.put(0, 1)  # no cache in the entropy image
        ecodes = {"green": _Code(280), "red": _Code(256),
                  "blue": _Code(256, simple=(0,)),
                  "alpha": _Code(256, simple=(0,)), "dist": _Code(40)}
        _write_codes(w, [ecodes])
        for t in tiles:
            _write_lit(w, ecodes, (t & 0xFF) << 8 | (t >> 8) << 16)
    else:
        w.put(0, 1)
    _write_codes(w, full)
    for i, op in enumerate(ops):
        g = full[0] if meta is None else full[meta[2][_tile(meta, i)]]
        if op[0] == "lit":
            _write_lit(w, g, op[1])
        elif op[0] == "cache":
            g["green"].write(w, 280 + op[1])
        else:
            s, nb, ex = _prefix(op[1])
            g["green"].write(w, 256 + s)
            w.put(ex, nb)
            s, nb, ex = _prefix(op[2])
            g["dist"].write(w, s)
            w.put(ex, nb)


def _tile(meta, i):
    bits, mx, _, pos = meta
    x, y = pos[i]
    return (y >> bits) * mx + (x >> bits)


def _write_codes(w, groups):
    for g in groups:
        for ch in ("green", "red", "blue", "alpha", "dist"):
            g[ch].write_header(w)


def _write_lit(w, g, argb):
    g["green"].write(w, (argb >> 8) & 0xFF)
    g["red"].write(w, (argb >> 16) & 0xFF)
    g["blue"].write(w, argb & 0xFF)
    g["alpha"].write(w, (argb >> 24) & 0xFF)


def _sub_image(w, pixels):
    """A transform's or palette's image: literals, complete codes."""
    w.put(0, 1)  # no cache
    g = [{"green": _Code(280), "red": _Code(256), "blue": _Code(256),
          "alpha": _Code(256), "dist": _Code(40)}]
    _write_codes(w, g)
    for p in pixels:
        _write_lit(w, g[0], int(p))


def vp8l(width, height, ops, transforms=(), cache_bits=0, groups=None,
         meta=None, alpha=False, version=0):
    """A VP8L bitstream (the chunk's payload): its header, `transforms`
    (("predictor", bits, modes per tile), ("cross", bits, ARGB
    multipliers per tile), ("green",), ("palette", ARGB colours), in
    the order they are sent), then the main image as `_image` writes
    it."""
    w = _Bits()
    w.put(0x2F, 8)
    w.put(width - 1, 14)
    w.put(height - 1, 14)
    w.put(int(alpha), 1)
    w.put(version, 3)
    for t in transforms:
        w.put(1, 1)
        kind = t[0]
        w.put({"predictor": 0, "cross": 1, "green": 2, "palette": 3}[kind],
              2)
        if kind in ("predictor", "cross"):
            w.put(t[1] - 2, 3)
            _sub_image(w, [(m & 0xF) << 8 if kind == "predictor" else m
                           for m in t[2]])
        elif kind == "palette":
            cols = [int(c) for c in t[1]]
            w.put(len(cols) - 1, 8)
            deltas = [cols[0]] + [
                sum(((((c >> s) & 0xFF) - ((p >> s) & 0xFF)) & 0xFF) << s
                    for s in (0, 8, 16, 24))
                for p, c in zip(cols, cols[1:])]
            _sub_image(w, deltas)
    w.put(0, 1)
    _image(w, ops, cache_bits, groups, meta)
    return w.bytes()


def vp8l_file(payload):
    return riff(chunk(b"VP8L", payload))
