"""JPEG writers for chosen quantised coefficients or samples, and the
marker surgery the JPEG tests need.

cv2's encoder writes what libjpeg chooses: Huffman coding, the usual
sampling factors, 8-bit quantisation tables, coefficients an image can
give.  These writers write what a test asks for:

- `write_jpeg`: sequential Huffman (SOF0, SOF1) with any sampling
  factors 1-4, 1-4 components, 8- or 16-bit tables, JFIF and Adobe
  markers (the transform flag that tells CMYK from YCCK), chosen
  component ids, restart intervals, and coefficients far past what an
  encoder emits (the inverse DCT's 16-bit overflows).  Its Huffman
  tables are fixed-length codes (DC: 16 symbols of 5 bits; AC: EOB, ZRL
  and every run/size up to size 15 in 8 bits), valid for any
  coefficient a 16-bit table can need.
- `write_jpeg_arith`: the same coefficients arithmetic-coded (T.81
  Annex D.1's QM coder with Table D.2, F.1.4's sequential and G.1.3's
  progressive procedures, as libjpeg's jcarith.c codes them), SOF9 or
  SOF10, with DAC conditioning tables, restart intervals and any scan
  script.
- `write_lossless`: lossless Huffman (SOF3, Annex H) of chosen samples:
  predictors 1-7, a point transform, precision 2-16, restart intervals.
- `dct_blocks`: an image plane's quantised coefficients (a float
  forward DCT), for encodings of pictures.

Used by `tests/test_torch_port_jpeg.py` against cv2's decoder and by
`tests/make_jpeg_fixtures.py`."""

import struct

import numpy as np

#: natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_DC_SYMS = list(range(16))
_AC_SYMS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                           for s in range(1, 16)]


def segment(marker, payload):
    """One marker segment: FF, marker, big-endian length, payload."""
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def blocks_shape(comps, ci, width, height):
    """(rows, cols) of 8x8 blocks of component `ci` that `write_jpeg`
    codes: the MCU grid's for an interleaved scan, the component's own
    for a single-component image."""
    mh = max(c[0] for c in comps)
    mv = max(c[1] for c in comps)
    h, v = comps[ci][:2]
    if len(comps) == 1:
        cw = -(-width * h // mh)
        ch = -(-height * v // mv)
        return -(-ch // 8), -(-cw // 8)
    return -(-height // (8 * mv)) * v, -(-width // (8 * mh)) * h


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code, n):
        self.acc = (self.acc << n) | (code & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


#: T.81 Annex K.3's tables: (bits per length 1-16, symbols) of the DC
#: and AC luminance (table 0) and chrominance (table 1) codes
ANNEX_K = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}


def _codes(counts, syms):
    """{symbol: (code, length)} of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[syms[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


#: write_jpeg's fixed-length codes, as (DC, AC) code dicts
_FIXED = (_codes([0, 0, 0, 0, 16] + [0] * 11, list(range(16))),
          _codes([0] * 7 + [len(_AC_SYMS)] + [0] * 8, _AC_SYMS))


def _code_block(bits, blk, pred, codes=_FIXED):
    """Huffman-code one block (natural order) with the (DC, AC) code
    dicts `codes`; returns its DC."""
    dc_codes, ac_codes = codes
    zz = np.asarray(blk).reshape(64)[ZIGZAG].astype(np.int64)
    dc = int(zz[0])
    diff = dc - pred
    s = abs(diff).bit_length()
    bits.put(*dc_codes[s])
    if s:
        bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
    run = 0
    last = max([k for k in range(1, 64) if zz[k]], default=0)
    for k in range(1, last + 1):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            bits.put(*ac_codes[0xF0])
            run -= 16
        s = abs(v).bit_length()
        bits.put(*ac_codes[(run << 4) | s])
        bits.put(v if v > 0 else v + (1 << s) - 1, s)
        run = 0
    if last < 63:
        bits.put(*ac_codes[0x00])
    return dc


def _dht(tc, th, syms, length):
    counts = [0] * 16
    counts[length - 1] = len(syms)
    return bytes([(tc << 4) | th]) + bytes(counts) + bytes(syms)


def _frame(comps, width, height, qtables, *, sof, precision=8, jfif=True,
           adobe=None, ids=None, q16=False):
    """SOI, the JFIF / Adobe markers, the DQTs and the frame header."""
    n = len(comps)
    ids = ids or list(range(1, n + 1))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                       + bytes([adobe]))
    for tq, table in sorted(qtables.items()):
        zz = np.asarray(table).reshape(64)[ZIGZAG]
        if q16:
            out += segment(0xDB, bytes([0x10 | tq])
                           + b"".join(struct.pack(">H", int(q)) for q in zz))
        else:
            out += segment(0xDB, bytes([tq]) + bytes(int(q) for q in zz))
    out += segment(sof, struct.pack(">BHHB", precision, height, width, n)
                   + b"".join(bytes([ids[i], (h << 4) | v, tq])
                              for i, (h, v, tq) in enumerate(comps)))
    return out, ids


def _scan_units(comps, width, height, cis, unit=8):
    """The MCUs of a scan over the components `cis`, each a list of
    (component, row, column) of its data units (8x8 blocks, or samples
    for `unit` 1): one unit per MCU in a single-component scan, the
    component's own units; the MCU grid's otherwise."""
    mh = max(c[0] for c in comps)
    mv = max(c[1] for c in comps)
    if len(cis) == 1:
        h, v = comps[cis[0]][:2]
        rows = -(-(-(-height * v // mv)) // unit)
        cols = -(-(-(-width * h // mh)) // unit)
        return [[(cis[0], r, c)] for r in range(rows) for c in range(cols)]
    return [[(ci, my * comps[ci][1] + y, mx * comps[ci][0] + x)
             for ci in cis for y in range(comps[ci][1])
             for x in range(comps[ci][0])]
            for my in range(-(-height // (unit * mv)))
            for mx in range(-(-width // (unit * mh)))]


def write_jpeg(comps, width, height, coefs, qtables, *, sof=0xC0,
               restart=0, precision=8, jfif=True, adobe=None, ids=None,
               q16=False, annex_k=False):
    """A sequential Huffman JPEG holding `coefs` exactly.

    comps:   (h, v, tq) per component (sampling factors, table number).
    coefs:   per component an int array (rows, cols, 8, 8) of quantised
             coefficients in natural order, DC absolute, of the shape
             `blocks_shape` gives.
    qtables: {tq: 64 values in natural order}.
    sof:     0xC0 (baseline) or 0xC1 (extended sequential).
    restart: the restart interval in MCUs (0: none).
    precision: the frame's sample precision (8; 12 is a 12-bit file).
    jfif / adobe: write an APP0 JFIF marker / an APP14 Adobe marker with
             this transform flag (4 components: 0 CMYK, 2 YCCK).
    ids:     the component ids (1, 2, ...).
    q16:     write the tables at 16-bit precision.
    annex_k: code with T.81 Annex K's tables (luminance for the first
             component, chrominance for the others; categories up to 11
             and 10 only) instead of the fixed-length codes."""
    n = len(comps)
    out, ids = _frame(comps, width, height, qtables, sof=sof,
                      precision=precision, jfif=jfif, adobe=adobe, ids=ids,
                      q16=q16)
    if annex_k:
        out += segment(0xC4, b"".join(
            bytes([tc << 4 | t]) + bytes(ANNEX_K[tc, t][0])
            + bytes(ANNEX_K[tc, t][1]) for tc in (0, 1) for t in (0, 1)))
        codes = [tuple(_codes(*ANNEX_K[tc, min(i, 1)]) for tc in (0, 1))
                 for i in range(n)]
        sel = [0x00] + [0x11] * (n - 1)
    else:
        out += segment(0xC4, _dht(0, 0, _DC_SYMS, 5)
                       + _dht(1, 0, _AC_SYMS, 8))
        codes, sel = [_FIXED] * n, [0x00] * n
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(0xDA, bytes([n]) + b"".join(
        bytes([ids[i], sel[i]]) for i in range(n)) + b"\x00\x3f\x00")
    bits = _Bits()
    preds = [0] * n
    for i, unit in enumerate(_scan_units(comps, width, height,
                                         list(range(n)))):
        if restart and i and i % restart == 0:
            bits.flush()
            out += bits.out + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            bits = _Bits()
            preds = [0] * n
        for ci, r, c in unit:
            preds[ci] = _code_block(bits, coefs[ci][r, c], preds[ci],
                                    codes[ci])
    bits.flush()
    out += bits.out + b"\xff\xd9"
    return bytes(out)


# ------------------------------------------------------- arithmetic coding

#: T.81 Table D.2 per state: (Qe, Next_Index_LPS, Next_Index_MPS,
#: Switch_MPS); state 113 is a fixed estimate of 0.5, the bin libjpeg
#: codes signs and refinement bits with
QE_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))


class ArithEncoder:
    """T.81 Annex D.1's encoder as libjpeg's jcarith.c runs it: the C
    register with 3 spare carry bits, 0xFF bytes stacked until a carry
    settles them, zero bytes held back and dropped at the end (D.1.8).
    A statistics bin is one entry of a bytearray: the state index in its
    low 7 bits, the MPS in bit 7."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _carry(self):
        """A byte that overflowed: the held byte + 1, stacked FFs -> 00."""
        if self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer + 1)
            if self.buffer + 1 == 0xFF:
                self.out.append(0)
        self.zc += self.sc
        self.sc = 0

    def _settle(self):
        """The held byte and the stacked FFs can no longer overflow."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self.out.append(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st, i, val):
        """Code the decision `val` with the bin st[i]."""
        sv = st[i]
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the LPS
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nlps | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:  # conditional exchange
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:  # renormalisation, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        """Flush the coder (D.1.8) and start a new segment."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            for shift, mask in ((19, 0x7FFF800), (11, 0x7F800)):
                if not self.c & mask:
                    break
                b = (self.c >> shift) & 0xFF
                self.out.append(b)
                if b == 0xFF:
                    self.out.append(0)
        self.reset()


def _arith_dc(enc, dcs, ctx, v, L, U):
    """F.1.4.1: the DC difference `v` coded with the DC statistics `dcs`
    at conditioning context `ctx`; returns the next context (F.1.4.4.1.2
    with the DAC bounds L and U)."""
    if v == 0:
        enc.encode(dcs, ctx, 0)
        return 0
    enc.encode(dcs, ctx, 1)
    if v > 0:
        enc.encode(dcs, ctx + 1, 0)
        st, nctx = ctx + 2, 4
    else:
        v = -v
        enc.encode(dcs, ctx + 1, 1)
        st, nctx = ctx + 3, 8
    m = 0
    v -= 1
    if v:
        enc.encode(dcs, st, 1)
        m, st, v2 = 1, 20, v >> 1
        while v2:
            enc.encode(dcs, st, 1)
            m <<= 1
            st += 1
            v2 >>= 1
    enc.encode(dcs, st, 0)
    if m < (1 << L) >> 1:
        nctx = 0
    elif m > (1 << U) >> 1:
        nctx += 8
    _arith_bits(enc, dcs, st + 14, m, v)
    return nctx


def _arith_bits(enc, st, i, m, v):
    """F.1.4.3.1's magnitude bits of v below its top bit m."""
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


def _arith_ac_value(enc, acs, fixed, st, k, v, K):
    """A nonzero AC value at zigzag position k: the sign with the fixed
    bin, the magnitude category from SE + 2 and X2 (189 or 217 by the
    DAC's Kx), then its bits."""
    enc.encode(fixed, 0, 1 if v < 0 else 0)
    v = abs(v) - 1
    st += 2
    m = 0
    if v:
        enc.encode(acs, st, 1)
        m, v2 = 1, v >> 1
        if v2:
            enc.encode(acs, st, 1)
            m <<= 1
            st = 189 if k <= K else 217
            v2 >>= 1
            while v2:
                enc.encode(acs, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
    enc.encode(acs, st, 0)
    _arith_bits(enc, acs, st + 14, m, v)


def _arith_ac(enc, acs, fixed, vals, ss, se, K):
    """F.1.4.2 / G.1.3.2: the AC values vals[ss..se] (zigzag order, the
    point transform applied), an EOB decision before each run."""
    ke = max([k for k in range(ss, se + 1) if vals[k]], default=0)
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        enc.encode(acs, st, 0)
        while vals[k] == 0:
            enc.encode(acs, st + 1, 0)
            st += 3
            k += 1
        enc.encode(acs, st + 1, 1)
        _arith_ac_value(enc, acs, fixed, st, k, vals[k], K)
        k += 1
    if k <= se:
        enc.encode(acs, 3 * (k - 1), 1)


def _arith_ac_refine(enc, acs, fixed, zz, ss, se, ah, al):
    """G.1.3.3: one more bit of the AC coefficients zz[ss..se]."""
    a = [abs(int(x)) for x in zz]
    ke = max([k for k in range(1, se + 1) if a[k] >> al], default=0)
    kex = max([k for k in range(1, ke + 1) if a[k] >> ah], default=0)
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            enc.encode(acs, st, 0)
        while True:
            m = a[k] >> al
            if m:
                if m >> 1:  # nonzero before: its next bit
                    enc.encode(acs, st + 2, m & 1)
                else:  # newly nonzero: its sign
                    enc.encode(acs, st + 1, 1)
                    enc.encode(fixed, 0, 1 if zz[k] < 0 else 0)
                break
            enc.encode(acs, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(acs, 3 * (k - 1), 1)


def progression(n):
    """libjpeg's jpeg_simple_progression scan script for n components:
    (components, Ss, Se, Ah, Al) per scan."""
    dc = lambda ah, al: [(tuple(range(n)), 0, 0, ah, al)] if n <= 4 else [
        ((c,), 0, 0, ah, al) for c in range(n)]
    ac = lambda ss, se, ah, al, cs: [((c,), ss, se, ah, al) for c in cs]
    if n == 3:
        return (dc(0, 1) + ac(1, 5, 0, 2, [0]) + ac(1, 63, 0, 1, [2, 1])
                + ac(6, 63, 0, 2, [0]) + ac(1, 63, 2, 1, [0]) + dc(1, 0)
                + ac(1, 63, 1, 0, [2, 1, 0]))
    cs = list(range(n))
    return (dc(0, 1) + ac(1, 5, 0, 2, cs) + ac(6, 63, 0, 2, cs)
            + ac(1, 63, 2, 1, cs) + dc(1, 0) + ac(1, 63, 1, 0, cs))


def dac_segment(dac):
    """A DAC marker segment from {(0, t): (L, U), (1, t): Kx}."""
    body = b""
    for (tc, tb), val in sorted(dac.items()):
        body += bytes([(tc << 4) | tb,
                       val[1] << 4 | val[0] if tc == 0 else val])
    return segment(0xCC, body)


def write_jpeg_arith(comps, width, height, coefs, qtables, *,
                     progressive=False, scans=None, restart=0, dac=None,
                     tables=None, precision=8, jfif=True, adobe=None,
                     ids=None, q16=False):
    """An arithmetic-coded JPEG (SOF9, or SOF10 when `progressive`)
    holding `coefs` (as `write_jpeg` takes them) exactly.

    scans:   (components, Ss, Se, Ah, Al) per scan; by default one
             interleaved sequential scan, or `progression(n)`.
    dac:     {(0, t): (L, U), (1, t): Kx} written as a DAC segment before
             the first scan (T.81's defaults: L 0, U 1, Kx 5).
    tables:  (DC, AC) conditioning table numbers per component (0-3;
             default 0 for the first component, 1 for the others).
    restart, precision, jfif, adobe, ids, q16: as in `write_jpeg`."""
    n = len(comps)
    tables = tables or [(0, 0)] + [(1, 1)] * (n - 1)
    conditioning = {(0, t): (0, 1) for t in range(16)}
    conditioning.update({(1, t): 5 for t in range(16)})
    conditioning.update(dac or {})
    out, ids = _frame(comps, width, height, qtables,
                      sof=0xCA if progressive else 0xC9, precision=precision,
                      jfif=jfif, adobe=adobe, ids=ids, q16=q16)
    if dac:
        out += dac_segment(dac)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    if scans is None:
        scans = progression(n) if progressive else [
            (tuple(range(n)), 0, 63, 0, 0)]
    zz = [np.asarray(c).reshape(c.shape[:2] + (64,))[..., ZIGZAG]
          .astype(np.int64) for c in coefs]
    for cis, ss, se, ah, al in scans:
        out += segment(0xDA, bytes([len(cis)]) + b"".join(
            bytes([ids[c], tables[c][0] << 4 | tables[c][1]]) for c in cis)
            + bytes([ss, se, ah << 4 | al]))
        enc = ArithEncoder()
        fixed = bytearray([113])
        dc_first = ss == 0 and (ah == 0 or not progressive)
        for i, unit in enumerate(_scan_units(comps, width, height, cis)):
            if i == 0 or (restart and i % restart == 0):
                if i:
                    enc.finish()
                    out += enc.out + bytes([0xFF, 0xD0
                                            + (i // restart - 1) % 8])
                    enc.out = bytearray()
                dcs = [bytearray(64) for _ in range(16)]
                acs = [bytearray(256) for _ in range(16)]
                preds = {c: 0 for c in cis}
                ctx = {c: 0 for c in cis}
            for ci, r, c in unit:
                b = zz[ci][r, c]
                dt, at = tables[ci]
                if dc_first:
                    dc = int(b[0]) >> al
                    ctx[ci] = _arith_dc(enc, dcs[dt], ctx[ci], dc - preds[ci],
                                        *conditioning[(0, dt)])
                    preds[ci] = dc
                elif ss == 0:  # DC refinement
                    enc.encode(fixed, 0, (int(b[0]) >> al) & 1)
                if not progressive:
                    _arith_ac(enc, acs[at], fixed, [int(x) for x in b], 1,
                              63, conditioning[(1, at)])
                elif ss and ah == 0:
                    _arith_ac(enc, acs[at], fixed, [
                        (abs(int(x)) >> al) * (1 if x >= 0 else -1)
                        for x in b], ss, se, conditioning[(1, at)])
                elif ss:
                    _arith_ac_refine(enc, acs[at], fixed, b, ss, se, ah, al)
        enc.finish()
        out += enc.out
    return bytes(out + b"\xff\xd9")


# ---------------------------------------------------------------- lossless

#: lossless difference categories 0-16, 5-bit codes
_LL_SYMS = list(range(17))


def lossless_shape(comps, ci, width, height):
    """(rows, cols) of samples of component `ci` that `write_lossless`
    codes (`blocks_shape` with one sample a data unit)."""
    mh = max(c[0] for c in comps)
    mv = max(c[1] for c in comps)
    h, v = comps[ci][:2]
    if len(comps) == 1:
        return -(-height * v // mv), -(-width * h // mh)
    return -(-height // mv) * v, -(-width // mh) * h


def _predict(x, pred, first, P, pt):
    """Annex H.1.2.1's prediction of every sample of one component's
    rows `x` (point-transformed), a row in `first` starting the 1-D
    prediction (the first row of the scan and of each restart
    interval)."""
    p = np.zeros_like(x)
    for r in range(x.shape[0]):
        row = x[r]
        if r in first:
            p[r, 0] = 1 << (P - pt - 1)
            p[r, 1:] = row[:-1]
            continue
        up = x[r - 1]
        ra, rb, rc = row[:-1], up[1:], up[:-1]
        p[r, 0] = up[0]
        p[r, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                    5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                    7: (ra + rb) >> 1}[pred]
    return p


def write_lossless(comps, width, height, samples, *, precision=8,
                   predictor=1, pt=0, restart=0, scans=None, sof=0xC3,
                   jfif=True, adobe=None, ids=None):
    """A lossless Huffman JPEG (Annex H) of `samples`: per component an
    int array of `lossless_shape` (values below 2**precision), coded with
    `predictor` (1-7) and the point transform `pt` in one interleaved
    scan, or in `scans` (tuples of components); samples past a
    component's own width and height are padding.  `restart` is in MCUs
    (libjpeg asks for whole MCU rows); each scan and restart interval
    starts a 1-D row, as T.81 has it.  The differences are coded with
    5-bit codes for categories 0-16."""
    n = len(comps)
    mh = max(c[0] for c in comps)
    mv = max(c[1] for c in comps)
    out, ids = _frame(comps, width, height, {}, sof=sof, precision=precision,
                      jfif=jfif, adobe=adobe, ids=ids)
    out += segment(0xC4, _dht(0, 0, _LL_SYMS, 5))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    for cis in scans or [tuple(range(n))]:
        out += segment(0xDA, bytes([len(cis)]) + b"".join(
            bytes([ids[i], 0x00]) for i in cis) + bytes([predictor, 0, pt]))
        one = len(cis) == 1
        diffs = {}
        for ci in cis:
            h, v = comps[ci][:2]
            x = np.asarray(samples[ci]).astype(np.int64) >> pt
            own_h = -(-height * v // mv)
            own_w = -(-width * h // mh)
            per_row, unit_rows = (own_w, 1) if one else (-(-width // mh), v)
            first = {r for r in range(own_h) if r % unit_rows == 0 and (
                r == 0 or restart and r // unit_rows * per_row % restart == 0)}
            d = np.zeros_like(x)
            d[:own_h, :own_w] = (x[:own_h, :own_w] - _predict(
                x[:own_h, :own_w], predictor, first, precision, pt)) & 0xFFFF
            diffs[ci] = d
        bits = _Bits()
        for i, unit in enumerate(_scan_units(comps, width, height, cis,
                                             unit=1)):
            if restart and i and i % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                bits = _Bits()
            for ci, r, c in unit:
                d = int(diffs[ci][r, c])
                d = d - 0x10000 if d > 0x8000 else d
                s = 16 if d == 0x8000 else abs(d).bit_length()
                bits.put(s, 5)
                if 0 < s < 16:
                    bits.put(d if d > 0 else d + (1 << s) - 1, s)
        bits.flush()
        out += bits.out
    return bytes(out + b"\xff\xd9")


# ----------------------------------------------------------------- pictures

_DCT = np.array([[(np.sqrt(1 / 8) if u == 0 else np.sqrt(2 / 8))
                  * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])


def dct_blocks(plane, shape, qtable):
    """Quantised coefficients (rows, cols, 8, 8) of an 8-bit plane (H, W)
    for the blocks shape `shape`, the plane padded by replicating its
    last row and column: a float forward DCT of the level-shifted
    samples, divided by `qtable` (natural order) and rounded."""
    rows, cols = shape
    p = np.pad(np.asarray(plane, np.float64) - 128,
               ((0, rows * 8 - plane.shape[0]), (0, cols * 8 - plane.shape[1])),
               mode="edge")
    b = p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    c = _DCT @ b @ _DCT.T
    return np.round(c / np.asarray(qtable, np.float64).reshape(8, 8)).astype(
        np.int64)


def read_coefficients(data):
    """The quantised coefficients of a sequential Huffman JPEG (what
    cv2's encoder writes): (comps, width, height, coefs, qtables, ids),
    as `write_jpeg` and `write_jpeg_arith` take them, so a file can be
    transcoded to arithmetic coding with the same coefficients."""
    qtables, dht, comps, ids, restart = {}, {}, [], [], 0
    coefs = None
    i = 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xD9:
            break
        n = struct.unpack(">H", data[i + 2:i + 4])[0]
        body = data[i + 4:i + 2 + n]
        i += 2 + n
        if m == 0xDB:
            j = 0
            while j < len(body):
                prec, tq = body[j] >> 4, body[j] & 15
                size = 128 if prec else 64
                raw = body[j + 1:j + 1 + size]
                vals = (np.frombuffer(raw, ">u2") if prec else np.frombuffer(
                    raw, np.uint8)).astype(np.int64)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qtables[tq] = table
                j += 1 + size
        elif m in (0xC0, 0xC1):
            _, height, width, nc = struct.unpack(">BHHB", body[:6])
            for k in range(nc):
                cid, hv, tq = body[6 + 3 * k:9 + 3 * k]
                ids.append(cid)
                comps.append((hv >> 4, hv & 15, tq))
            coefs = [np.zeros(blocks_shape(comps, k, width, height) + (8, 8),
                              np.int64) for k in range(nc)]
        elif m == 0xC4:
            j = 0
            while j < len(body):
                counts = body[j + 1:j + 17]
                syms = body[j + 17:j + 17 + sum(counts)]
                dht[body[j]] = {format(code, "0%db" % length): sym for sym, (
                    code, length) in _codes(counts, syms).items()}
                j += 17 + sum(counts)
        elif m == 0xDD:
            restart = struct.unpack(">H", body)[0]
        elif m == 0xDA:
            cis = [ids.index(body[1 + 2 * k]) for k in range(body[0])]
            sel = {ci: body[2 + 2 * k] for k, ci in enumerate(cis)}
            i = _huffman_scan(data, i, comps, width, height, cis, sel, dht,
                              restart, coefs)
    return comps, width, height, coefs, qtables, ids


def _huffman_scan(data, i, comps, width, height, cis, sel, dht, restart,
                  coefs):
    """Decode one sequential scan starting at data[i] into `coefs`;
    returns the position of the marker after it."""
    parts, cur, end = [], bytearray(), i
    while True:  # unstuff FF 00, split at RSTn, stop at another marker
        if data[end] != 0xFF:
            cur.append(data[end])
            end += 1
        elif data[end + 1] == 0:
            cur.append(0xFF)
            end += 2
        elif 0xD0 <= data[end + 1] <= 0xD7:
            parts.append(cur)
            cur, end = bytearray(), end + 2
        else:
            break
    parts.append(cur)
    bits = ["".join(format(b, "08b") for b in p) for p in parts]

    def huff(table, state):
        for length in range(1, 17):
            sym = table.get(state[0][state[1]:state[1] + length])
            if sym is not None:
                state[1] += length
                return sym
        raise ValueError("bad Huffman code")

    def get(state, n):
        v = int(state[0][state[1]:state[1] + n] or "0", 2)
        state[1] += n
        return v - (1 << n) + 1 if n and v < 1 << (n - 1) else v

    state = [bits[0], 0]
    preds = {c: 0 for c in cis}
    for u, unit in enumerate(_scan_units(comps, width, height, cis)):
        if restart and u and u % restart == 0:
            state = [bits[u // restart], 0]
            preds = {c: 0 for c in cis}
        for ci, r, c in unit:
            dc_t, ac_t = dht[sel[ci] >> 4], dht[0x10 | (sel[ci] & 15)]
            zz = np.zeros(64, np.int64)
            preds[ci] += get(state, huff(dc_t, state))
            zz[0] = preds[ci]
            k = 1
            while k < 64:
                rs = huff(ac_t, state)
                if rs == 0:
                    break
                k += rs >> 4
                if rs & 15:
                    zz[k] = get(state, rs & 15)
                k += 1
            coefs[ci][r, c].reshape(64)[ZIGZAG] = zz
    return end


def exif_app1(orientation, big_endian):
    """An APP1 Exif segment whose IFD0 holds one Orientation entry."""
    e = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHI", 0x0112, 3, 1)
    tiff += struct.pack(e + "HH", orientation, 0) + struct.pack(e + "I", 0)
    return segment(0xE1, b"Exif\x00\x00" + tiff)


def insert_after_soi(data, seg):
    """`data` with the segment `seg` placed right after SOI."""
    return data[:2] + seg + data[2:]


def find_marker(data, marker):
    """Offset of the first marker segment `marker` in the header."""
    i = 2
    while i + 4 <= len(data):
        assert data[i] == 0xFF, i
        m = data[i + 1]
        if m == marker:
            return i
        if m == 0xDA:
            break
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    raise KeyError(hex(marker))
