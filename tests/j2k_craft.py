"""JPEG 2000 files for the tests that hold the port's reader
(`mergenet_tpu_torch/data/jp2.py`) to cv2's OpenJPEG: JP2 box surgery
(signature, ftyp, jp2h with ihdr, colr, bpcc, pclr, cmap, cdef, res),
codestream marker surgery, and a small T.800 encoder for tiny images
that writes what neither cv2 nor Pillow writes:

- tier 1: the MQ coder (T.800 C.2) and the three passes in stripes of
  4 rows, with every code-block style (BYPASS raw passes, RESET,
  TERMALL, VSC, PTERM, SEGSYM); each code-block codes every bit-plane
  of its integer coefficients;
- tier 2: tag trees, inclusion, zero bit-planes, passes split over
  layers, Lblock, segments; packets in the five progressions and in
  POC order; SOP/EPH, PPM/PPT packed headers, tiles on a tile grid
  with its own origin, tile-parts split and written in any order;
- the 5/3 forward DWT (vertical then horizontal per level, so that the
  decoder's rows-then-columns inverse undoes it) and RCT for lossless
  files; for 9/7, the quantised band coefficients are given directly
  (`bands=`), so that one non-zero coefficient per band and level pins
  the decoder's lifting constants;
- components of any precision (1-16 bits here), signed or not, each
  with its own subsampling; RGN max-shift;
- HT code-blocks (T.814, `cblksty=HT`): the cleanup pass (MEL, VLC with
  codewords taken from the decoder's own tables in
  `mergenet_tpu_torch/data/native/jp2.cc`, UVLC, MagSgn) and the
  SigProp and MagRef passes, each stream stuffed as the decoder
  unstuffs it; the 9/7 DWT and ICT of whole images for lossy files.

Pure Python and numpy; the tests and `tests/make_jp2_fixtures.py` use
it, the port never does."""

import os
import re
import struct

import numpy as np

JP2_SIG = b"\x00\x00\x00\x0cjP  \r\n\x87\n"

LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}

# ------------------------------------------------------------- JP2 boxes


def box(kind, payload, length=None):
    n = 8 + len(payload) if length is None else length
    return struct.pack(">I", n) + kind + payload


def boxes(data, start=0, end=None):
    """[(type, payload, offset)] of the boxes in data[start:end]
    (length 0: to the end)."""
    end = len(data) if end is None else end
    out, at = [], start
    while at + 8 <= end:
        n, kind = struct.unpack(">I4s", data[at:at + 8])
        head = 8
        if n == 1:
            n = struct.unpack(">Q", data[at + 8:at + 16])[0]
            head = 16
        if n == 0:
            n = end - at
        out.append((kind, data[at + head:at + n], at))
        at += n
    return out


def codestream(data):
    """The codestream of a JP2 file (its jp2c box), or `data` itself."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return data
    return dict((k, p) for k, p, _ in boxes(data))[b"jp2c"]


def ihdr(h, w, nc, bpc=7, c=7, unkc=0, ipr=0):
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, c, unkc, ipr))


def colr(enumcs=16, meth=1, icc=b"", prec=0, approx=0):
    if meth == 2:
        return box(b"colr", bytes([meth, prec, approx]) + icc)
    return box(b"colr", bytes([meth, prec, approx]) + struct.pack(">I",
                                                                 enumcs))


def pclr(entries, sizes, signs=None):
    """Palette: `entries` (n, ncols) ints, `sizes` bits per column."""
    entries = np.asarray(entries)
    signs = signs or [0] * len(sizes)
    out = struct.pack(">HB", entries.shape[0], entries.shape[1])
    out += bytes((s - 1) | (g << 7) for s, g in zip(sizes, signs))
    for row in entries:
        for v, s in zip(row, sizes):
            nb = min((s + 7) // 8, 4)
            out += int(v).to_bytes(nb, "big")
    return box(b"pclr", out)


def cmap(items):
    """[(component, mtyp, pcol)]."""
    return box(b"cmap", b"".join(struct.pack(">HBB", *i) for i in items))


def cdef(items):
    """[(channel, type, association)]."""
    return box(b"cdef", struct.pack(">H", len(items)) + b"".join(
        struct.pack(">HHH", *i) for i in items))


def jp2(cs, header=None, nc=None, enumcs=16, before=(), after=(),
        brand=b"jp2 "):
    """A JP2 file around codestream `cs`: jp2h holds `header` (a list of
    boxes; default ihdr + colr(enumcs)); `before`/`after`: boxes between
    ftyp and jp2h, and after jp2c."""
    siz = _siz(cs)
    if header is None:
        header = [ihdr(siz["h"], siz["w"], siz["nc"] if nc is None else nc,
                       siz["bpc"]), colr(enumcs)]
    return (JP2_SIG + box(b"ftyp", brand + b"\0\0\0\0" + brand)
            + b"".join(before) + box(b"jp2h", b"".join(header))
            + box(b"jp2c", cs) + b"".join(after))


def rebox(data, header=None, replace=None, drop=(), add=()):
    """Rewrites a JP2 file's jp2h: `replace` {type: box bytes or None}
    swaps (or drops) boxes of that type, `add` appends boxes."""
    out = b""
    for kind, payload, _ in boxes(data):
        if kind == b"jp2h":
            inner = b""
            for k, p, _ in boxes(payload):
                if k in drop:
                    continue
                if replace and k in replace:
                    if replace[k] is not None:
                        inner += replace[k]
                    continue
                inner += box(k, p)
            payload = (b"".join(header) if header is not None else inner
                       ) + b"".join(add)
        out += box(kind, payload)
    return out


def _siz(cs):
    i = cs.index(b"\xff\x51")
    (rsiz, x1, y1, x0, y0, tdx, tdy, tx0, ty0, nc) = struct.unpack(
        ">HIIIIIIIIH", cs[i + 4:i + 40])
    comps = [cs[i + 40 + 3 * k:i + 43 + 3 * k] for k in range(nc)]
    precs = {c[0] for c in comps}
    bpc = precs.pop() if len(precs) == 1 else 255
    return dict(w=x1 - x0, h=y1 - y0, nc=nc, bpc=bpc)


# ---------------------------------------------------------- marker surgery


def segments(cs):
    """[(marker, payload)] of the main header, then ('tiles', bytes) for
    everything from the first SOT on."""
    out, at = [(0xff4f, b"")], 2
    while True:
        m = struct.unpack(">H", cs[at:at + 2])[0]
        if m == 0xff90:
            out.append(("tiles", cs[at:]))
            return out
        n = struct.unpack(">H", cs[at + 2:at + 4])[0]
        out.append((m, cs[at + 4:at + 2 + n]))
        at += 2 + n


def marker(m, payload):
    return struct.pack(">HH", m, len(payload) + 2) + payload


def join(segs):
    out = b""
    for m, p in segs:
        if m == "tiles":
            out += p
        elif m == 0xff4f:
            out += b"\xff\x4f"
        else:
            out += marker(m, p)
    return out


def with_main_markers(cs, add=(), drop=(), edit=None):
    """Adds marker segments [(marker, payload)] before the first SOT,
    drops markers in `drop`, `edit`: {marker: fn(payload) -> payload}."""
    segs = [s for s in segments(cs) if s[0] not in drop]
    if edit:
        segs = [(m, edit[m](p) if m in edit else p) for m, p in segs]
    return join(segs[:-1] + list(add) + segs[-1:])


def set_rsiz(cs, rsiz):
    return with_main_markers(cs, edit={0xff51: lambda p: struct.pack(
        ">H", rsiz) + p[2:]})


def set_cblksty(cs, sty):
    def ed(p):
        p = bytearray(p)
        p[8] = sty
        return bytes(p)
    return with_main_markers(cs, edit={0xff52: ed})


# ------------------------------------------------------------- MQ encoder

_QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0)]

CTX_ZC, CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI = 0, 9, 14, 17, 18


class MQEncoder:
    """T.800 C.2 (software conventions); `flush` ends a segment."""

    def __init__(self):
        self.reset()
        self.start()

    def reset(self):
        self.st = [0] * 19
        self.mps = [0] * 19
        self.st[CTX_UNI], self.st[CTX_AGG], self.st[CTX_ZC] = 46, 3, 4

    def start(self):
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])  # the byte before the first (dropped)

    def _byteout(self):
        out = self.out
        if out[-1] == 0xff:
            out.append((self.c >> 20) & 0xff)
            self.c &= 0xfffff
            self.ct = 7
        elif not self.c & 0x8000000:
            out.append((self.c >> 19) & 0xff)
            self.c &= 0x7ffff
            self.ct = 8
        else:
            out[-1] += 1
            if out[-1] == 0xff:
                self.c &= 0x7ffffff
                out.append(self.c >> 20)
                self.c &= 0xfffff
                self.ct = 7
            else:
                out.append((self.c >> 19) & 0xff)
                self.c &= 0x7ffff
                self.ct = 8

    def _renorm(self):
        while True:
            self.a = (self.a << 1) & 0xffffffff
            self.c = (self.c << 1) & 0xffffffff
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d, cx):
        qe, nmps, nlps, sw = _QE[self.st[cx]]
        if d == self.mps[cx]:
            self.a -= qe
            if self.a & 0x8000 == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.st[cx] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                self.mps[cx] = 1 - self.mps[cx]
            self.st[cx] = nlps
            self._renorm()

    def flush(self):
        """Terminates the segment; returns its bytes and starts anew."""
        tempc = self.c + self.a
        self.c |= 0xffff
        if self.c >= tempc:
            self.c -= 0x8000
        self.c = (self.c << self.ct) & 0xffffffff
        self._byteout()
        self.c = (self.c << self.ct) & 0xffffffff
        self._byteout()
        data = bytes(self.out[1:])
        if data and data[-1] == 0xff:
            data = data[:-1]
        self.start()
        return data


class RawEncoder:
    """Raw (bypass) bits, MSB first, a 0 bit stuffed after each 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.byte, self.n, self.cap = 0, 0, 8

    def bit(self, b):
        self.byte = (self.byte << 1) | b
        self.n += 1
        if self.n == self.cap:
            self.out.append(self.byte)
            self.cap = 7 if self.byte == 0xff else 8
            self.byte, self.n = 0, 0

    def flush(self):
        if self.n:
            self.out.append(self.byte << (self.cap - self.n))
        data = bytes(self.out)
        self.__init__()
        return data


# ------------------------------------------------------------------ tier 1


def _zc(hh, vv, dd, orient):
    if orient == 1:
        hh, vv = vv, hh
    if orient == 3:
        hv = hh + vv
        if dd >= 3:
            return 8
        if dd == 2:
            return 7 if hv >= 1 else 6
        if dd == 1:
            return 5 if hv >= 2 else 4 if hv == 1 else 3
        return 2 if hv >= 2 else 1 if hv == 1 else 0
    if hh == 2:
        return 8
    if hh == 1:
        return 7 if vv >= 1 else 6 if dd >= 1 else 5
    if vv == 2:
        return 4
    if vv == 1:
        return 3
    return 2 if dd >= 2 else 1 if dd == 1 else 0


def encode_cblk(coef, orient, sty, nbps=None, roishift=0):
    """Segments [(bytes, npasses)] and the number of coded bit-planes of
    an integer code-block `coef` (h, w), every bit-plane coded (`nbps`
    forces more leading planes).  Segments follow the decoder's rules:
    BYPASS gives 10 passes, then raw sig+ref pairs and MQ cleanups,
    each segment's coder chosen by its first pass (raw where the
    bit-plane is at most numbps - 4, numbps not counting `roishift`)."""
    h, w = coef.shape
    mag = [[int(v) for v in row] for row in np.abs(coef)]
    neg = [[bool(v) for v in row] for row in coef < 0]
    nb = int(np.abs(coef).max()).bit_length() if coef.size else 0
    nbps = max(nb, nbps or 0)
    if nbps == 0:
        return [], 0
    W = w + 2  # flat state with a border of one sample
    sig = [0] * ((h + 2) * W)
    sgn = [0] * ((h + 2) * W)  # +1 / -1 where significant
    refined = [False] * (h * w)
    visited = [False] * (h * w)
    vsc = bool(sty & VSC)
    mq, raw = MQEncoder(), RawEncoder()

    def counts(x, y):
        i = (y + 1) * W + x + 1
        south = not (vsc and (y & 3) == 3)
        hh = sig[i - 1] + sig[i + 1]
        vv = sig[i - W] + (sig[i + W] if south else 0)
        dd = sig[i - W - 1] + sig[i - W + 1] + (
            sig[i + W - 1] + sig[i + W + 1] if south else 0)
        return hh, vv, dd

    def sc(x, y):
        i = (y + 1) * W + x + 1
        south = not (vsc and (y & 3) == 3)
        hc = sgn[i - 1] + sgn[i + 1]
        vc = sgn[i - W] + (sgn[i + W] if south else 0)
        hc = (hc > 0) - (hc < 0)
        vc = (vc > 0) - (vc < 0)
        xb = 0
        if hc < 0:
            hc, vc, xb = -hc, -vc, 1
        elif hc == 0 and vc < 0:
            vc, xb = -vc, 1
        if hc == 0:
            return CTX_SC + (0 if vc == 0 else 1), xb
        return CTX_SC + 3 + vc, xb

    def code_sign(x, y, is_raw):
        n = neg[y][x]
        if is_raw:
            raw.bit(int(n))
        else:
            cx, xb = sc(x, y)
            mq.encode(int(n) ^ xb, cx)
        i = (y + 1) * W + x + 1
        sig[i] = 1
        sgn[i] = -1 if n else 1

    cells = [(x, y) for k in range(0, h, 4) for x in range(w)
             for y in range(k, min(k + 4, h))]

    def sigpass(b, is_raw):
        for x, y in cells:
            if sig[(y + 1) * W + x + 1]:
                continue
            c = counts(x, y)
            if c == (0, 0, 0):
                continue
            bit = (mag[y][x] >> b) & 1
            if is_raw:
                raw.bit(bit)
            else:
                mq.encode(bit, CTX_ZC + _zc(*c, orient))
            if bit:
                code_sign(x, y, is_raw)
            visited[y * w + x] = True

    def refpass(b, is_raw):
        for x, y in cells:
            if not sig[(y + 1) * W + x + 1] or visited[y * w + x]:
                continue
            bit = (mag[y][x] >> b) & 1
            if is_raw:
                raw.bit(bit)
            else:
                if refined[y * w + x]:
                    cx = CTX_MAG + 2
                else:
                    cx = CTX_MAG + (1 if counts(x, y) != (0, 0, 0) else 0)
                mq.encode(bit, cx)
            refined[y * w + x] = True

    def clnpass(b):
        for k in range(0, h, 4):
            for x in range(w):
                y, yend = k, min(k + 4, h)
                if k + 4 <= h and all(
                        not sig[(j + 1) * W + x + 1] and not visited[j * w + x]
                        and counts(x, j) == (0, 0, 0)
                        for j in range(k, k + 4)):
                    bits = [(mag[j][x] >> b) & 1 for j in range(k, k + 4)]
                    if not any(bits):
                        mq.encode(0, CTX_AGG)
                        continue
                    mq.encode(1, CTX_AGG)
                    r = bits.index(1)
                    mq.encode(r >> 1, CTX_UNI)
                    mq.encode(r & 1, CTX_UNI)
                    y = k + r
                    code_sign(x, y, False)
                    y += 1
                for j in range(y, yend):
                    if sig[(j + 1) * W + x + 1] or visited[j * w + x]:
                        continue
                    bit = (mag[j][x] >> b) & 1
                    mq.encode(bit, CTX_ZC + _zc(*counts(x, j), orient))
                    if bit:
                        code_sign(x, j, False)
        visited[:] = [False] * (h * w)
        if sty & SEGSYM:
            for v in (1, 0, 1, 0):
                mq.encode(v, CTX_UNI)

    passes = [(2, nbps - 1)] + [(t, b) for b in range(nbps - 2, -1, -1)
                                for t in (0, 1, 2)]
    numbps_dec = nbps - roishift
    segs, i, prev = [], 0, None
    while i < len(passes):
        if sty & TERMALL:
            n = 1
        elif sty & LAZY:
            n = 10 if prev is None else 2 if prev in (1, 10) else 1
        else:
            n = len(passes)
        prev = n
        chunk = passes[i:i + n]
        t0, b0 = chunk[0]
        is_raw = bool(sty & LAZY) and t0 < 2 and b0 + 1 <= numbps_dec - 4
        for t, b in chunk:
            if t == 0:
                sigpass(b, is_raw)
            elif t == 1:
                refpass(b, is_raw)
            else:
                clnpass(b)
            if (sty & RESET) and not is_raw:
                mq.reset()
        segs.append((raw.flush() if is_raw else mq.flush(), len(chunk)))
        i += n
    return segs, nbps


# ---------------------------------------------------------- bit writer


class BitWriter:
    """Packet header bits, a 0 bit stuffed after each 0xFF byte."""

    def __init__(self):
        self.out = bytearray()
        self.byte, self.n, self.cap = 0, 0, 8

    def bit(self, b):
        self.byte = (self.byte << 1) | (b & 1)
        self.n += 1
        if self.n == self.cap:
            self.out.append(self.byte)
            self.cap = 7 if self.byte == 0xff else 8
            self.byte, self.n = 0, 0

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def flush(self):
        if self.n:
            self.out.append(self.byte << (self.cap - self.n))
            last = self.out[-1]
            self.byte, self.n, self.cap = 0, 0, 8
            if last == 0xff:
                self.out.append(0)
        elif self.out and self.out[-1] == 0xff:
            self.out.append(0)
        return bytes(self.out)


class TagTree:
    def __init__(self, w, h, values):
        self.levels = []
        vals = np.asarray(values, np.int64).reshape(h, w)
        while True:
            self.levels.append(vals)
            if vals.size <= 1:
                break
            hh, ww = (vals.shape[0] + 1) // 2, (vals.shape[1] + 1) // 2
            nxt = np.full((hh, ww), 1 << 40, np.int64)
            for y in range(vals.shape[0]):
                for x in range(vals.shape[1]):
                    nxt[y >> 1, x >> 1] = min(nxt[y >> 1, x >> 1], vals[y, x])
            vals = nxt
        self.low = [np.zeros(v.shape, np.int64) for v in self.levels]
        self.known = [np.zeros(v.shape, bool) for v in self.levels]
        self.w = w

    def encode(self, bw, leaf, threshold):
        y, x = divmod(leaf, self.w)
        path = []
        for lv in range(len(self.levels)):
            path.append((lv, y, x))
            y, x = y >> 1, x >> 1
        low = 0
        for lv, y, x in reversed(path):
            if low > self.low[lv][y, x]:
                self.low[lv][y, x] = low
            else:
                low = self.low[lv][y, x]
            v = self.levels[lv][y, x]
            while low < threshold:
                if low >= v:
                    if not self.known[lv][y, x]:
                        bw.bit(1)
                        self.known[lv][y, x] = True
                    break
                bw.bit(0)
                low += 1
            self.low[lv][y, x] = low


# ------------------------------------------------------------- wavelets


def _fwd53_1d(x, cas):
    """Forward 5/3 of one signal whose first sample has parity `cas`:
    its lows, then its highs (a lone odd sample is doubled)."""
    n = len(x)
    x = x.astype(np.int64).copy()
    if n == 1:
        return x * 2 if cas else x

    def refl(k):
        return -k if k < 0 else 2 * (n - 1) - k if k >= n else k
    for k in range(1 - cas, n, 2):  # highs
        x[k] -= (x[refl(k - 1)] + x[refl(k + 1)]) >> 1
    for k in range(cas, n, 2):  # lows
        x[k] += (x[refl(k - 1)] + x[refl(k + 1)] + 2) >> 2
    return np.concatenate([x[cas::2], x[1 - cas::2]])


def fwd53(a, x0, y0, levels):
    """Forward 5/3 of a tile-component with origin (x0, y0), in the
    decoder's layout (each level's lows first)."""
    a = a.astype(np.int64).copy()
    H, W = a.shape
    for lv in range(levels):
        rx0, rx1 = _cdivpow2(x0, lv), _cdivpow2(x0 + W, lv)
        ry0, ry1 = _cdivpow2(y0, lv), _cdivpow2(y0 + H, lv)
        h, w = ry1 - ry0, rx1 - rx0
        for i in range(w):
            a[:h, i] = _fwd53_1d(a[:h, i], ry0 % 2)
        for j in range(h):
            a[j, :w] = _fwd53_1d(a[j, :w], rx0 % 2)
    return a


_A, _B, _G, _D, _K = (-1.586134342, -0.052980118, 0.882911075, 0.443506852,
                      1.230174105)


def _fwd97_1d(x, cas):
    """Forward 9/7 (float lifting) of one signal whose first sample has
    parity `cas`: its lows (times 1/K), then its highs (times K/2)."""
    n = len(x)
    x = x.astype(np.float64).copy()
    if n == 1:
        return x * 2 if cas else x

    for c, par in ((_A, 1 - cas), (_B, cas), (_G, 1 - cas), (_D, cas)):
        k = np.arange(par, n, 2)
        right = np.where(k + 1 >= n, 2 * (n - 1) - (k + 1), k + 1)
        x[k] += c * (x[np.abs(k - 1)] + x[right])
    return np.concatenate([x[cas::2] / _K, x[1 - cas::2] * _K / 2])


def fwd97(a, x0, y0, levels):
    """Forward 9/7 of a tile-component, in the layout of fwd53."""
    a = a.astype(np.float64).copy()
    H, W = a.shape
    for lv in range(levels):
        rx0, rx1 = _cdivpow2(x0, lv), _cdivpow2(x0 + W, lv)
        ry0, ry1 = _cdivpow2(y0, lv), _cdivpow2(y0 + H, lv)
        h, w = ry1 - ry0, rx1 - rx0
        for i in range(w):
            a[:h, i] = _fwd97_1d(a[:h, i], ry0 % 2)
        for j in range(h):
            a[j, :w] = _fwd97_1d(a[j, :w], rx0 % 2)
    return a


def _quantise97(a, g, prec, quant):
    """Dead-zone quantisation of each band by its QCD step (the
    decoder's step: (1 + mant / 2048) * 2^(prec + gain - expn))."""
    expn, mants = quant
    out = np.zeros(a.shape, np.int64)
    for r, re_ in enumerate(g.res):
        for bi, bd in enumerate(re_["bands"]):
            ox, oy = g.band_offset(r, bd["bandno"])
            sl = (slice(oy, oy + bd["y1"] - bd["y0"]),
                  slice(ox, ox + bd["x1"] - bd["x0"]))
            i = 0 if r == 0 else 3 * r - 2 + bi
            step = (1 + mants[i] / 2048.0) * 2.0 ** (prec - expn[i])
            v = a[sl]
            out[sl] = np.sign(v) * np.floor(np.abs(v) / step)
    return out


# ------------------------------------------------------------------ encoder


def _cdiv(a, b):
    return -(-a // b)


def _cdivpow2(a, b):
    return -(-a >> b)


class Geometry:
    """Resolutions, bands, precincts and code-blocks of a tile-component
    (T.800 B.5-B.7, as OpenJPEG computes them)."""

    def __init__(self, tcx0, tcy0, tcx1, tcy1, levels, cblk, precincts):
        self.x0, self.y0, self.x1, self.y1 = tcx0, tcy0, tcx1, tcy1
        self.numres = levels + 1
        self.res = []
        for r in range(self.numres):
            lv = levels - r
            rx0, ry0 = _cdivpow2(tcx0, lv), _cdivpow2(tcy0, lv)
            rx1, ry1 = _cdivpow2(tcx1, lv), _cdivpow2(tcy1, lv)
            pdx, pdy = precincts[r] if precincts else (15, 15)
            tlpx, tlpy = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            brpx, brpy = _cdivpow2(rx1, pdx) << pdx, _cdivpow2(ry1, pdy) << pdy
            pw = 0 if rx0 == rx1 else (brpx - tlpx) >> pdx
            ph = 0 if ry0 == ry1 else (brpy - tlpy) >> pdy
            if r == 0:
                tlcx, tlcy, cgw, cgh, nb = tlpx, tlpy, pdx, pdy, 1
            else:
                tlcx, tlcy = _cdivpow2(tlpx, 1), _cdivpow2(tlpy, 1)
                cgw, cgh, nb = pdx - 1, pdy - 1, 3
            cbw, cbh = min(cblk[0], cgw), min(cblk[1], cgh)
            bands = []
            for b in range(nb):
                if r == 0:
                    bandno = 0
                    bx0, by0 = _cdivpow2(tcx0, lv), _cdivpow2(tcy0, lv)
                    bx1, by1 = _cdivpow2(tcx1, lv), _cdivpow2(tcy1, lv)
                else:
                    bandno = b + 1
                    xob, yob = bandno & 1, bandno >> 1
                    bx0 = _cdivpow2(tcx0 - (xob << lv), lv + 1)
                    by0 = _cdivpow2(tcy0 - (yob << lv), lv + 1)
                    bx1 = _cdivpow2(tcx1 - (xob << lv), lv + 1)
                    by1 = _cdivpow2(tcy1 - (yob << lv), lv + 1)
                precs = []
                for p in range(pw * ph):
                    cx0 = tlcx + (p % pw) * (1 << cgw)
                    cy0 = tlcy + (p // pw) * (1 << cgh)
                    px0, py0 = max(cx0, bx0), max(cy0, by0)
                    px1, py1 = min(cx0 + (1 << cgw), bx1), min(cy0 + (1 << cgh),
                                                              by1)
                    tx, ty = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                    cw = max(0, ((_cdivpow2(px1, cbw) << cbw) - tx) >> cbw)
                    ch = max(0, ((_cdivpow2(py1, cbh) << cbh) - ty) >> cbh)
                    if bx1 - bx0 == 0 or by1 - by0 == 0:
                        cw = ch = 0
                    cbs = []
                    for k in range(cw * ch):
                        qx, qy = tx + (k % cw) * (1 << cbw), ty + (k // cw) * (
                            1 << cbh)
                        cbs.append((max(qx, px0), max(qy, py0),
                                    min(qx + (1 << cbw), px1),
                                    min(qy + (1 << cbh), py1)))
                    precs.append(dict(cw=cw, ch=ch, cblks=cbs))
                bands.append(dict(bandno=bandno, x0=bx0, y0=by0, x1=bx1,
                                  y1=by1, precs=precs))
            self.res.append(dict(x0=rx0, y0=ry0, x1=rx1, y1=ry1, pw=pw, ph=ph,
                                 pdx=pdx, pdy=pdy, bands=bands))

    def band_offset(self, r, bandno):
        """Where band `bandno` of resolution r starts in the tile array."""
        x = y = 0
        if bandno & 1:
            lo = self.res[r - 1]
            x = lo["x1"] - lo["x0"]
        if bandno & 2:
            lo = self.res[r - 1]
            y = lo["y1"] - lo["y0"]
        return x, y


def packet_order(geo, comps, tile, numlayers, prg, pocs=None):
    """(layer, res, comp, precinct) in decoding order (OpenJPEG's pi.c,
    each packet once)."""
    tx0, ty0, tx1, ty1 = tile
    nc = len(geo)
    maxres = max(g.numres for g in geo)
    seen, out = set(), []
    if pocs:
        plist = [(r0, c0, min(l1, numlayers), r1, min(c1, nc), p)
                 for r0, c0, l1, r1, c1, p in pocs]
    else:
        plist = [(0, 0, numlayers, maxres, nc, prg)]

    def emit(l, r, c, p):
        if (l, r, c, p) not in seen:
            seen.add((l, r, c, p))
            out.append((l, r, c, p))

    def npr(c, r):
        return geo[c].res[r]["pw"] * geo[c].res[r]["ph"]

    def mind(cs):
        dx = dy = 0
        for c in cs:
            g, (cdx, cdy) = geo[c], comps[c]
            for r in range(g.numres):
                re = g.res[r]
                d = cdx << (re["pdx"] + g.numres - 1 - r)
                dx = d if not dx else min(dx, d)
                d = cdy << (re["pdy"] + g.numres - 1 - r)
                dy = d if not dy else min(dy, d)
        return dx, dy

    def visit(c, r, y, x, l1):
        g, (cdx, cdy) = geo[c], comps[c]
        if r >= g.numres:
            return
        re = g.res[r]
        lv = g.numres - 1 - r
        trx0, try0 = _cdiv(tx0, cdx << lv), _cdiv(ty0, cdy << lv)
        trx1, try1 = _cdiv(tx1, cdx << lv), _cdiv(ty1, cdy << lv)
        rpx, rpy = re["pdx"] + lv, re["pdy"] + lv
        if not (y % (cdy << rpy) == 0 or (y == ty0 and (try0 << lv) % (1 << rpy))):
            return
        if not (x % (cdx << rpx) == 0 or (x == tx0 and (trx0 << lv) % (1 << rpx))):
            return
        if re["pw"] == 0 or re["ph"] == 0 or trx0 == trx1 or try0 == try1:
            return
        prci = (_cdiv(x, cdx << lv) >> re["pdx"]) - (trx0 >> re["pdx"])
        prcj = (_cdiv(y, cdy << lv) >> re["pdy"]) - (try0 >> re["pdy"])
        for l in range(l1):
            emit(l, r, c, prci + prcj * re["pw"])

    def steps(lo, hi, d):
        v = lo
        while v < hi:
            yield v
            v += d - (v % d)

    for r0, c0, l1, r1, c1, p in plist:
        if p == 0:
            for l in range(l1):
                for r in range(r0, r1):
                    for c in range(c0, c1):
                        if r < geo[c].numres:
                            for q in range(npr(c, r)):
                                emit(l, r, c, q)
        elif p == 1:
            for r in range(r0, r1):
                for l in range(l1):
                    for c in range(c0, c1):
                        if r < geo[c].numres:
                            for q in range(npr(c, r)):
                                emit(l, r, c, q)
        elif p == 2:
            dx, dy = mind(range(nc))
            for r in range(r0, r1):
                for y in steps(ty0, ty1, dy):
                    for x in steps(tx0, tx1, dx):
                        for c in range(c0, c1):
                            visit(c, r, y, x, l1)
        elif p == 3:
            dx, dy = mind(range(nc))
            for y in steps(ty0, ty1, dy):
                for x in steps(tx0, tx1, dx):
                    for c in range(c0, c1):
                        for r in range(r0, min(r1, geo[c].numres)):
                            visit(c, r, y, x, l1)
        elif p == 4:
            for c in range(c0, c1):
                dx, dy = mind([c])
                for y in steps(ty0, ty1, dy):
                    for x in steps(tx0, tx1, dx):
                        for r in range(r0, min(r1, geo[c].numres)):
                            visit(c, r, y, x, l1)
    return out


def encode(comps, prec=8, signed=False, sub=None, levels=2, reversible=True,
           mct=False, cblk=(6, 6), cblksty=0, progression="LRCP", layers=1,
           precincts=None, tile=None, tile_origin=(0, 0), origin=(0, 0),
           roi=None, bands=None, quant=(8, 0), guard=2, sop=False, eph=False,
           packed=None, tileparts=1, tile_order=None, pocs=None,
           poc_in_tile=False, tnsot=True, comment=None, rsiz=0, ht_passes=1,
           ht_extra=0, tile_markers=()):
    """A J2K codestream of the components `comps` (2-D int arrays, each
    the size its subsampling `sub[c]` = (dx, dy) gives on the image grid
    from `origin`).

    `prec`/`signed`: one for all or one per component; `cblk`: code-block
    exponents (w, h); `precincts`: (PPx, PPy) per resolution; `tile`:
    (w, h) of the tile grid from `tile_origin`; `roi`: (component,
    shift, (x0, y0, x1, y1)) on the component grid, coefficients of the
    region shifted up (RGN max-shift); `bands` (irreversible only):
    fn(comp, res, bandno, shape) -> quantised int coefficients; `quant`:
    (expn, mant) for all bands or one per band; `packed`: None, "ppm" or
    "ppt"; `tileparts`: tile-parts per tile; `tile_order`: [(tile,
    part)] in the order they are written; `pocs`: [(RSpoc, CSpoc,
    LYEpoc, REpoc, CEpoc, Ppoc)] in the main header (or each tile's
    first tile-part with `poc_in_tile`); `tnsot`: write TNsot (else 0);
    `cblksty`: one for all or one per component (COC markers after the
    COD); with 0x40 (HT) the code-blocks are HT coded in `ht_passes`
    (1-3) passes, `ht_extra` more announced in the packet headers;
    `tile_markers`: [(marker, payload)] in each tile's first tile-part.
    Irreversible files without `bands` take the 9/7 DWT of the
    components (after the ICT with `mct`) quantised by `quant`."""
    nc = len(comps)
    sub = sub or [(1, 1)] * nc
    precs = list(prec) if isinstance(prec, (list, tuple)) else [prec] * nc
    sgnd = list(signed) if isinstance(signed, (list, tuple)) else \
        [signed] * nc
    X0, Y0 = origin
    X1 = _extent(X0, [(c.shape[1], s[0]) for c, s in zip(comps, sub)])
    Y1 = _extent(Y0, [(c.shape[0], s[1]) for c, s in zip(comps, sub)])
    TX0, TY0 = tile_origin
    TW, TH = tile or (X1 - TX0, Y1 - TY0)
    ntx, nty = _cdiv(X1 - TX0, TW), _cdiv(Y1 - TY0, TH)
    prg = PROGRESSIONS[progression] if isinstance(progression, str) else \
        progression
    nbands = 3 * levels + 1
    if reversible:
        top = max(precs)
        expn = [top + (0 if b == 0 else 2 if b % 3 == 0 else 1)
                for b in range(nbands)]
        mants = [0] * nbands
    else:
        qs = quant if isinstance(quant, list) else [quant] * nbands
        expn, mants = [e for e, _ in qs], [m for _, m in qs]
    out = [(0xff4f, b"")]
    siz = struct.pack(">HIIIIIIIIH", rsiz, X1, Y1, X0, Y0, TW, TH, TX0, TY0,
                      nc)
    for k in range(nc):
        siz += bytes([(precs[k] - 1) | (0x80 if sgnd[k] else 0), sub[k][0],
                      sub[k][1]])
    out.append((0xff51, siz))
    stys = list(cblksty) if isinstance(cblksty, (list, tuple)) else \
        [cblksty] * nc
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    spcod = [bytes([levels, cblk[0] - 2, cblk[1] - 2, sty,
                    1 if reversible else 0]) + (bytes(
                        (py << 4) | px for px, py in precincts)
                        if precincts else b"") for sty in stys]
    out.append((0xff52, bytes([scod, prg]) + struct.pack(">H", layers)
                + bytes([1 if mct else 0]) + spcod[0]))
    for k in range(1, nc):
        if stys[k] != stys[0]:
            out.append((0xff53, k.to_bytes(1 if nc <= 256 else 2, "big")
                        + bytes([scod & 1]) + spcod[k]))
    if reversible:
        qcd = bytes([guard << 5]) + bytes(e << 3 for e in expn)
    else:
        qcd = bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | m) for e, m in zip(expn, mants))
    out.append((0xff5c, qcd))
    if roi:
        out.append((0xff5e, bytes([roi[0], 0, roi[1]])))
    if pocs and not poc_in_tile:
        out.append((0xff5f, _poc(pocs, nc)))
    if comment:
        out.append((0xff64, b"\0\1" + comment))
    mb = [e + guard - 1 for e in expn]
    tiles_parts = {}
    for ty in range(nty):
        for tx in range(ntx):
            tb = (max(TX0 + tx * TW, X0), max(TY0 + ty * TH, Y0),
                  min(TX0 + (tx + 1) * TW, X1), min(TY0 + (ty + 1) * TH, Y1))
            tiles_parts[ty * ntx + tx] = _encode_tile(
                comps, sub, precs, sgnd, tb, (X0, Y0), levels, reversible,
                mct, cblk, stys, prg, layers, precincts, roi, bands, mb,
                sop, eph, tileparts, pocs, (ht_passes, ht_extra),
                (expn, mants))
    order = tile_order or [(t, q) for t in sorted(tiles_parts)
                           for q in range(len(tiles_parts[t]))]
    if packed == "ppm":
        data = b""
        for t, q in order:
            hdr = b"".join(h for _, h, _ in tiles_parts[t][q])
            data += struct.pack(">I", len(hdr)) + hdr
        for z, i in enumerate(range(0, max(len(data), 1), 60000)):
            out.append((0xff60, bytes([z]) + data[i:i + 60000]))
    cs = join(out)
    zppt = {}
    for t, q in order:
        pk = tiles_parts[t][q]
        markers = b""
        if q == 0 and pocs and poc_in_tile:
            markers += marker(0xff5f, _poc(pocs, nc))
        if q == 0:
            markers += b"".join(marker(m, p) for m, p in tile_markers)
        if packed == "ppt":
            hdr = b"".join(h for _, h, _ in pk)
            for i in range(0, max(len(hdr), 1), 60000):
                z = zppt[t] = zppt.get(t, -1) + 1
                markers += marker(0xff61, bytes([z]) + hdr[i:i + 60000])
        if packed:
            payload = b"".join(sp + body for sp, _, body in pk)
        else:
            payload = b"".join(sp + h + body for sp, h, body in pk)
        psot = 12 + len(markers) + 2 + len(payload)
        n = len(tiles_parts[t]) if tnsot else 0
        cs += marker(0xff90, struct.pack(">HIBB", t, psot, q, n)) + markers \
            + b"\xff\x93" + payload
    return cs + b"\xff\xd9"


def _extent(o, sizes):
    """The smallest X1 with ceil(X1/d) - ceil(o/d) = n for every (n, d)."""
    for x1 in range(o + 1, o + 2 + max(n * d for n, d in sizes) + max(
            d for _, d in sizes)):
        if all(_cdiv(x1, d) - _cdiv(o, d) == n for n, d in sizes):
            return x1
    raise ValueError("no image extent fits the component sizes %s" % sizes)


def _poc(pocs, nc):
    room = 1 if nc <= 256 else 2
    out = b""
    for r0, c0, l1, r1, c1, p in pocs:
        out += bytes([r0]) + c0.to_bytes(room, "big") + struct.pack(
            ">H", l1) + bytes([r1]) + c1.to_bytes(room, "big") + bytes([p])
    return out


def _encode_tile(comps, sub, precs, sgnd, tb, org, levels, reversible, mct,
                 cblk, stys, prg, layers, precincts, roi, bands, mb, sop,
                 eph, tileparts, pocs, ht=(1, 0), quant=None):
    """The tile's tile-parts, each a list of packets (SOP, header with
    its EPH, body)."""
    nc = len(comps)
    geo, data = [], []
    for k in range(nc):
        dx, dy = sub[k]
        cx0, cy0 = _cdiv(tb[0], dx), _cdiv(tb[1], dy)
        cx1, cy1 = _cdiv(tb[2], dx), _cdiv(tb[3], dy)
        ox, oy = _cdiv(org[0], dx), _cdiv(org[1], dy)
        geo.append(Geometry(cx0, cy0, cx1, cy1, levels, cblk, precincts))
        a = comps[k][cy0 - oy:cy1 - oy, cx0 - ox:cx1 - ox].astype(np.int64)
        if not sgnd[k]:
            a = a - (1 << (precs[k] - 1))
        data.append(a)
    if mct and reversible:
        r, g_, b = data[0], data[1], data[2]
        data[0], data[1], data[2] = (r + 2 * g_ + b) >> 2, b - g_, r - g_
    if mct and not reversible and not bands:
        r, g_, b = (d.astype(np.float64) for d in data[:3])
        data[:3] = [0.299 * r + 0.587 * g_ + 0.114 * b,
                    -0.16875 * r - 0.33126 * g_ + 0.5 * b,
                    0.5 * r - 0.41869 * g_ - 0.08131 * b]
    coefs = []
    for k in range(nc):
        g = geo[k]
        if reversible:
            coefs.append(fwd53(data[k], g.x0, g.y0, levels))
            continue
        if not bands:
            coefs.append(_quantise97(fwd97(data[k], g.x0, g.y0, levels), g,
                                     precs[k], quant))
            continue
        arr = np.zeros(data[k].shape, np.int64)
        for r, re in enumerate(g.res):
            for bd in re["bands"]:
                ox, oy = g.band_offset(r, bd["bandno"])
                shape = (bd["y1"] - bd["y0"], bd["x1"] - bd["x0"])
                if bands and shape[0] > 0 and shape[1] > 0:
                    arr[oy:oy + shape[0], ox:ox + shape[1]] = bands(
                        k, r, bd["bandno"], shape)
        coefs.append(arr)
    shift = {}
    if roi:
        rk, s, (rx0, ry0, rx1, ry1) = roi
        shift[rk] = s
        g, arr = geo[rk], coefs[rk]
        for r, re in enumerate(g.res):
            lv = g.numres - 1 - r
            for bd in re["bands"]:
                ox, oy = g.band_offset(r, bd["bandno"])
                sc = lv + (1 if r else 0)
                bx0 = max(bd["x0"], rx0 >> sc)
                by0 = max(bd["y0"], ry0 >> sc)
                bx1 = min(bd["x1"], _cdivpow2(rx1, sc))
                by1 = min(bd["y1"], _cdivpow2(ry1, sc))
                if bx1 > bx0 and by1 > by0:
                    sl = (slice(oy + by0 - bd["y0"], oy + by1 - bd["y0"]),
                          slice(ox + bx0 - bd["x0"], ox + bx1 - bd["x0"]))
                    arr[sl] = arr[sl] << s
    cbs = {}
    for k in range(nc):
        g = geo[k]
        s = shift.get(k, 0)
        for r, re in enumerate(g.res):
            for bi, bd in enumerate(re["bands"]):
                ox, oy = g.band_offset(r, bd["bandno"])
                bmb = mb[0 if r == 0 else 3 * r - 2 + bi]
                for p, pr in enumerate(bd["precs"]):
                    for q, (x0, y0, x1, y1) in enumerate(pr["cblks"]):
                        if x1 <= x0 or y1 <= y0:
                            cbs[(k, r, bi, p, q)] = ([], 0, 0)
                            continue
                        c = coefs[k][oy + y0 - bd["y0"]:oy + y1 - bd["y0"],
                                     ox + x0 - bd["x0"]:ox + x1 - bd["x0"]]
                        if stys[k] & HT:
                            segs, nbps = encode_ht_cblk(
                                c, ht[0], bool(stys[k] & VSC)) if c.any() \
                                else ([], 0)
                            if segs and ht[1]:
                                segs[-1] = (segs[-1][0], segs[-1][1] + ht[1])
                        else:
                            segs, nbps = encode_cblk(
                                c, bd["bandno"], stys[k],
                                nbps=s if c.any() else 0, roishift=s)
                        zbp = bmb + s - nbps
                        if segs and zbp < 0:
                            raise ValueError("coefficients past the band's "
                                             "bit-planes (Mb %d)" % bmb)
                        cbs[(k, r, bi, p, q)] = (segs, nbps, zbp)
    order = packet_order(geo, sub, tb, layers, prg, pocs)
    state, packets = {}, []
    for n, (l, r, k, p) in enumerate(order):
        hdr, body = _packet(geo[k], r, k, p, l, layers, cbs, state)
        packets.append((b"\xff\x91\x00\x04" + struct.pack(">H", n & 0xffff)
                        if sop else b"", hdr + (b"\xff\x92" if eph else b""),
                        body))
    per = max(1, _cdiv(len(packets), tileparts))
    return [packets[i * per:(i + 1) * per] for i in range(tileparts)]


def _packet(g, r, k, p, layer, layers, cbs, state):
    re = g.res[r]
    bw = BitWriter()
    body = b""
    entries = []
    for bi, bd in enumerate(re["bands"]):
        if bd["x1"] - bd["x0"] == 0 or bd["y1"] - bd["y0"] == 0:
            continue
        pr = bd["precs"][p]
        n = pr["cw"] * pr["ch"]
        key = (k, r, bi, p)
        if key not in state:
            fl = [_first_layer(sum(s[1] for s in cbs[key + (q,)][0]), layers)
                  for q in range(n)]
            zbp = [cbs[key + (q,)][2] for q in range(n)]
            state[key] = dict(incl=TagTree(pr["cw"], pr["ch"], fl),
                              imsb=TagTree(pr["cw"], pr["ch"], zbp),
                              lblock=[3] * n, done=[0] * n)
        entries.append((key, n, state[key]))
    present = any(_split(sum(s[1] for s in cbs[key + (q,)][0]), layers, layer)
                  [1] > _split(sum(s[1] for s in cbs[key + (q,)][0]), layers,
                               layer)[0]
                  for key, n, st in entries for q in range(n))
    bw.bit(1 if present else 0)
    if present:
        for key, n, st in entries:
            for q in range(n):
                segs = cbs[key + (q,)][0]
                total = sum(s[1] for s in segs)
                a, b = _split(total, layers, layer)
                npass = b - a
                if st["done"][q] == 0:
                    st["incl"].encode(bw, q, layer + 1)
                    if not npass:
                        continue
                    st["imsb"].encode(bw, q, 1 << 30)
                else:
                    bw.bit(1 if npass else 0)
                    if not npass:
                        continue
                _numpasses(bw, npass)
                pieces = _pieces(segs, st["done"][q], npass)
                need = max(nb.bit_length() - _flog2(np_) for nb, _, np_ in
                           pieces)
                inc = max(0, need - st["lblock"][q])
                for _ in range(inc):
                    bw.bit(1)
                bw.bit(0)
                st["lblock"][q] += inc
                for nb, chunk, np_ in pieces:
                    bw.bits(nb, st["lblock"][q] + _flog2(np_))
                    body += chunk
                st["done"][q] += npass
    return bw.flush(), body


def _flog2(n):
    return n.bit_length() - 1


def _numpasses(bw, n):
    if n == 1:
        bw.bit(0)
    elif n == 2:
        bw.bits(0b10, 2)
    elif n <= 5:
        bw.bits(0b1100 | (n - 3), 4)
    elif n <= 36:
        bw.bits(0b1111, 4)
        bw.bits(n - 6, 5)
    else:
        bw.bits(0b111111111, 9)
        bw.bits(n - 37, 7)


def _split(npass, layers, l):
    """Passes [a, b) that layer l carries: the first layers carry more."""
    bounds = [(npass * (i + 1) ** 2 + layers ** 2 // 2) // layers ** 2
              for i in range(layers)]
    return (0 if l == 0 else bounds[l - 1]), bounds[l]


def _first_layer(npass, layers):
    for l in range(layers):
        a, b = _split(npass, layers, l)
        if b > a:
            return l
    return 1 << 20


def _pieces(segs, done, npass):
    """(bytes, data, passes) of each segment piece the passes [done, done
    + npass) cover: a segment split between layers gives each layer a
    share of its bytes in proportion to its passes (the decoder reads
    the segment whole)."""
    out, start = [], 0
    for data, n in segs:
        a, b = max(start, done), min(start + n, done + npass)
        if a < b:
            lo = len(data) * (a - start) // n
            hi = len(data) * (b - start) // n if b < start + n else len(data)
            out.append((hi - lo, data[lo:hi], b - a))
        start += n
    return out


# ------------------------------------------------------------------ HTJ2K

HT = 0x40
_JP2_CC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mergenet_tpu_torch", "data", "native", "jp2.cc")


def vlc_tables():
    """The decoder's two context VLC tables (`native/jp2.cc`'s VLC_TBL0
    and VLC_TBL1: OpenJPEG's, read out of cv2), as two lists of 1024."""
    with open(_JP2_CC) as f:
        src = f.read()
    out = []
    for name in ("VLC_TBL0", "VLC_TBL1"):
        body = re.search(name + r"\[1024\] = \{([^}]*)\}", src).group(1)
        out.append([int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)])
        assert len(out[-1]) == 1024, name
    return out


def _vlc_encoders():
    """Per table and context, {(rho, u_off, e_k, e_1): (codeword, length)}
    with the shortest codeword of each, from the decoding tables."""
    encs = []
    for tbl in vlc_tables():
        per = []
        for c in range(8):
            d = {}
            for idx in range(128):
                e = tbl[(c << 7) | idx]
                n = e & 7
                key = ((e >> 4) & 15, (e >> 3) & 1, (e >> 12) & 15,
                       (e >> 8) & 15)
                cwd = idx & ((1 << n) - 1)
                if key not in d or d[key][1] > n:
                    d[key] = (cwd, n)
            per.append(d)
        encs.append(per)
    return encs


_VLC_ENC = []


class _MelWriter:
    """MEL events (T.814's adaptive run-length code), bits MSB first, 7
    bits after a 0xFF byte."""
    EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)

    def __init__(self):
        self.k, self.run = 0, 0
        self.out, self.tmp, self.rem = bytearray(), 0, 8

    def _bit(self, v):
        self.tmp = (self.tmp << 1) | v
        self.rem -= 1
        if self.rem == 0:
            self.out.append(self.tmp)
            self.rem = 7 if self.tmp == 0xff else 8
            self.tmp = 0

    def event(self, e):
        if not e:
            self.run += 1
            if self.run == 1 << self.EXP[self.k]:
                self._bit(1)
                self.run = 0
                self.k = min(self.k + 1, 12)
            return
        self._bit(0)
        for i in range(self.EXP[self.k] - 1, -1, -1):
            self._bit((self.run >> i) & 1)
        self.run = 0
        self.k = max(self.k - 1, 0)

    def flush(self):
        if self.run:
            self._bit(1)
        n = 8 if not self.out or self.out[-1] != 0xff else 7
        if self.rem != n:
            self.out.append((self.tmp << self.rem) & 0xff)
        if self.out and self.out[-1] == 0xff:
            self.out.append(0)  # no byte over 0x8F after a 0xFF
        return bytes(self.out)


class _FwdWriter:
    """LSB first, 7 bits after a 0xFF byte (MagSgn, SigProp)."""

    def __init__(self):
        self.out, self.tmp, self.used, self.cap = bytearray(), 0, 0, 8

    def bits(self, v, n):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == self.cap:
                self.out.append(self.tmp)
                self.cap = 7 if self.tmp == 0xff else 8
                self.tmp, self.used = 0, 0

    def flush(self, pad):
        """Pads the last byte with `pad` bits; MagSgn (pad 1) drops a
        trailing 0xFF, which the decoder's padding restores."""
        if self.used:
            if pad:
                self.tmp |= ((1 << (self.cap - self.used)) - 1) << self.used
            self.out.append(self.tmp)
        if pad:
            while self.out and self.out[-1] == 0xff:
                self.out.pop()
        return bytes(self.out)


class _RevWriter:
    """LSB first into bytes that are read backwards (the VLC, MagRef):
    after a byte over 0x8F the next may take an 8th bit (its MSB) only
    where its low 7 bits are not all set.  The VLC starts in the high
    nibble of the byte whose low nibble holds Scup."""

    def __init__(self, vlc):
        self.out = bytearray()
        self.tmp, self.used, self.gt = (0xf, 4, True) if vlc else (0, 0, True)

    def bits(self, v, n):
        for i in range(n):
            self.tmp |= ((v >> i) & 1) << self.used
            self.used += 1
            if self.used == 8 - self.gt:
                if self.gt and self.tmp != 0x7f:
                    self.gt = False
                    continue
                self.out.append(self.tmp)
                self.gt = self.tmp > 0x8f
                self.tmp, self.used = 0, 0

    def flush(self):
        if self.used:
            self.out.append(self.tmp)
        return bytes(self.out)  # in reading order (the last byte first)


def _uvlc_parts(u):
    """(prefix bits, prefix length, suffix bits, suffix length) of u >= 1."""
    if u == 1:
        return 1, 1, 0, 0
    if u == 2:
        return 2, 2, 0, 0
    if u <= 4:
        return 4, 3, u - 3, 1
    if u <= 36:
        return 0, 3, u - 5, 5
    raise ValueError("u %d past the UVLC's 36" % u)


def _bitlen(v):
    return int(v).bit_length()


def encode_ht_cblk(coef, passes=1, vsc=False):
    """The HT codeword segments [(bytes, passes)] of an integer code-block
    `coef` (h, w) and its number of bit-planes p: with one pass the
    cleanup codes every bit (p = 1); with 2 or 3 it codes the bits from
    plane 1 up (p = 2), SigProp the plane-0 bit of insignificant samples
    next to significant ones and, with 3, MagRef the plane-0 bit of the
    cleanup's significant samples (what neither reaches is lost)."""
    if not _VLC_ENC:
        _VLC_ENC.extend(_vlc_encoders())
    h, w = coef.shape
    plane = 0 if passes == 1 else 1
    mag = [[abs(int(v)) for v in row] for row in coef]
    neg = [[int(v) < 0 for v in row] for row in coef]
    mu = [[m >> plane for m in row] for row in mag]
    mel, vlc, ms = _MelWriter(), _RevWriter(True), _FwdWriter()
    line = [0] * (w // 2 + 4)

    def quad(xs, y):
        """rho, [(E, v)] of the quad at (xs, y)."""
        rho, out = 0, []
        for i in range(4):
            xx, yy = xs + i // 2, y + i % 2
            if xx < w and yy < h and mu[yy][xx]:
                rho |= 1 << i
                v = 2 * (mu[yy][xx] - 1) + int(neg[yy][xx])
                out.append((_bitlen(2 * (mu[yy][xx] - 1) + 1), v))
            else:
                out.append((0, 0))
        return rho, out

    for y in range(0, h, 2):
        initial = y == 0
        enc = _VLC_ENC[0 if initial else 1]
        ls0, c_q = line[0], 0
        line[0] = 0
        for x in range(0, w, 4):
            j = x // 2
            qs = [quad(x, y)] + ([quad(x + 2, y)] if x + 2 < w else [])
            infos = []
            for q, (rho, sm) in enumerate(qs):
                if not initial:
                    if q == 0:
                        c_q |= (ls0 >> 7) | ((line[j + 1] >> 5) & 4)
                    else:
                        c_q |= (line[j + 1] >> 7) | ((line[j + 2] >> 5) & 4)
                kappa = 1
                if not initial and bin(rho).count("1") > 1:
                    e = max(ls0 & 0x7f, line[j + 1] & 0x7f) if q == 0 else \
                        max(line[j + 1] & 0x7f, line[j + 2] & 0x7f)
                    kappa = max(1, e - 1)
                emax = max(e for e, _ in sm)
                U = max(kappa, emax)
                u = U - kappa
                uoff = int(u > 0)
                best = None
                if c_q == 0:
                    mel.event(int(rho != 0))
                if rho or c_q:
                    for (r, uo, ek, e1), cw in enc[c_q].items():
                        if r != rho or uo != uoff:
                            continue
                        if any((ek >> i) & 1 and (e1 >> i) & 1 != int(
                                sm[i][0] == U) for i in range(4)):
                            continue
                        if best is None or cw[1] < best[1][1]:
                            best = (ek, cw)
                    assert best is not None, (c_q, rho, uoff)
                    vlc.bits(*best[1])
                ek = best[0] if best else 0
                infos.append((rho, sm, U, u, ek))
                if initial:
                    c_q = (rho & 1) | ((rho >> 1) & 7)
                else:
                    c_q = ((rho >> 2) & 1) << 1 | ((rho >> 3) & 1) << 1
            us = [i[3] for i in infos] + [0]
            mode = int(us[0] > 0) | int(us[1] > 0) << 1
            if mode in (1, 2):
                pb, pn, sb, sn = _uvlc_parts(us[mode - 1])
                vlc.bits(pb, pn)
                vlc.bits(sb, sn)
            elif mode == 3:
                if initial and us[0] > 2 and us[1] > 2:
                    mel.event(1)
                    p0, p1 = _uvlc_parts(us[0] - 2), _uvlc_parts(us[1] - 2)
                    vlc.bits(p0[0], p0[1])
                    vlc.bits(p1[0], p1[1])
                    vlc.bits(p0[2], p0[3])
                    vlc.bits(p1[2], p1[3])
                elif initial:
                    mel.event(0)
                    p0 = _uvlc_parts(us[0])
                    vlc.bits(p0[0], p0[1])
                    if us[0] > 2:
                        vlc.bits(us[1] - 1, 1)
                        vlc.bits(p0[2], p0[3])
                    else:
                        p1 = _uvlc_parts(us[1])
                        vlc.bits(p1[0], p1[1])
                        vlc.bits(p0[2], p0[3])
                        vlc.bits(p1[2], p1[3])
                else:
                    p0, p1 = _uvlc_parts(us[0]), _uvlc_parts(us[1])
                    vlc.bits(p0[0], p0[1])
                    vlc.bits(p1[0], p1[1])
                    vlc.bits(p0[2], p0[3])
                    vlc.bits(p1[2], p1[3])
            if not initial:
                ls0 = line[j + 2]
                line[j + 1] = line[j + 2] = 0
            for q, (rho, sm, U, u, ek) in enumerate(infos):
                for i in range(4):
                    if not (rho >> i) & 1:
                        continue
                    e, v = sm[i]
                    ms.bits(v, U - ((ek >> i) & 1))
                    if i == 1:
                        line[j + q] = 0x80 | max(line[j + q] & 0x7f, e)
                    elif i == 3:
                        line[j + q + 1] = 0x80 | e
    mel_b, vlc_b = mel.flush(), vlc.flush()
    scup = len(mel_b) + len(vlc_b) + 1
    if scup > 4079:
        raise ValueError("Scup %d past 4079" % scup)
    tail = bytearray(vlc_b[::-1]) + bytes([scup >> 4])
    tail[-2] = (tail[-2] & 0xf0) | (scup & 0xf)
    segs = [(ms.flush(True) + mel_b + bytes(tail), 1)]
    if passes > 1:
        segs.append((_ht_refine(mag, neg, mu, passes, vsc), passes - 1))
    return segs, plane + 1


def _ht_refine(mag, neg, mu, passes, vsc):
    """SigProp (and MagRef with 3 passes) of plane 0: SigProp forwards
    from the segment's start, MagRef backwards from its end."""
    h, w = len(mag), len(mag[0])
    sig = [[m > 0 for m in row] for row in mu]
    st = [row[:] for row in sig]
    sp, mr = _FwdWriter(), _RevWriter(False)

    def on(x, y):
        return 0 <= x < w and 0 <= y < h and st[y][x]
    for y0 in range(0, h, 4):
        y1 = min(y0 + 4, h)
        for g in range(0, w, 4):
            fresh = []
            for x in range(g, min(g + 4, w)):
                for y in range(y0, y1):
                    if st[y][x]:
                        continue
                    south = not (vsc and y == y0 + 3)
                    near = [(x + dx, y + dy) for dy in (-1, 0, 1)
                            for dx in (-1, 0, 1) if (dx or dy)
                            and (dy < 1 or south)]
                    if not any(on(*q) for q in near):
                        continue
                    b = mag[y][x] & 1
                    sp.bits(b, 1)
                    if b:
                        st[y][x] = True
                        fresh.append((x, y))
            for x, y in fresh:
                sp.bits(int(neg[y][x]), 1)
        if passes > 2:
            for x in range(w):
                for y in range(y0, y1):
                    if sig[y][x]:
                        mr.bits(mag[y][x] & 1, 1)
    return sp.flush(False) + mr.flush()[::-1]
