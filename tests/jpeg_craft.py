"""A JPEG writer for chosen quantised coefficients, and the marker
surgery the JPEG tests need.

cv2's encoder writes what libjpeg chooses: the usual sampling factors,
8-bit quantisation tables, coefficients an image can give.  `write_jpeg`
writes what a test asks for: any sampling factors 1-4, 8- or 16-bit
tables, SOF0 or SOF1, JFIF and Adobe markers, chosen component ids,
restart intervals, and coefficients far past what an encoder emits (the
inverse DCT's 16-bit overflows).  Its Huffman tables are fixed-length codes
(DC: 16 symbols of 5 bits; AC: EOB, ZRL and every run/size up to size
15 in 8 bits), valid for any coefficient a 16-bit table can need.

Used by `tests/test_torch_port_jpeg.py` against cv2's decoder."""

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


def _code_block(bits, blk, pred):
    """Huffman-code one block (natural order); returns its DC."""
    zz = np.asarray(blk).reshape(64)[ZIGZAG].astype(np.int64)
    dc = int(zz[0])
    diff = dc - pred
    s = abs(diff).bit_length()
    bits.put(_DC_SYMS.index(s), 5)
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
            bits.put(_AC_SYMS.index(0xF0), 8)
            run -= 16
        s = abs(v).bit_length()
        bits.put(_AC_SYMS.index((run << 4) | s), 8)
        bits.put(v if v > 0 else v + (1 << s) - 1, s)
        run = 0
    if last < 63:
        bits.put(_AC_SYMS.index(0x00), 8)
    return dc


def _dht(tc, th, syms, length):
    counts = [0] * 16
    counts[length - 1] = len(syms)
    return bytes([(tc << 4) | th]) + bytes(counts) + bytes(syms)


def write_jpeg(comps, width, height, coefs, qtables, *, sof=0xC0,
               restart=0, jfif=True, adobe=None, ids=None, q16=False):
    """A sequential Huffman JPEG holding `coefs` exactly.

    comps:   (h, v, tq) per component (sampling factors, table number).
    coefs:   per component an int array (rows, cols, 8, 8) of quantised
             coefficients in natural order, DC absolute, of the shape
             `blocks_shape` gives.
    qtables: {tq: 64 values in natural order}.
    sof:     0xC0 (baseline) or 0xC1 (extended sequential).
    restart: the restart interval in MCUs (0: none).
    jfif / adobe: write an APP0 JFIF marker / an APP14 Adobe marker with
             this transform flag.  ids: the component ids (1, 2, ...).
    q16:     write the tables at 16-bit precision."""
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
    out += segment(sof, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[i], (h << 4) | v, tq]) for i, (h, v, tq) in
        enumerate(comps)))
    out += segment(0xC4, _dht(0, 0, _DC_SYMS, 5) + _dht(1, 0, _AC_SYMS, 8))
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(0xDA, bytes([n]) + b"".join(
        bytes([ids[i], 0x00]) for i in range(n)) + b"\x00\x3f\x00")
    bits = _Bits()
    preds = [0] * n
    if n == 1:
        units = [[(0, r, c)] for r in range(coefs[0].shape[0])
                 for c in range(coefs[0].shape[1])]
    else:
        mh = max(c[0] for c in comps)
        mv = max(c[1] for c in comps)
        units = []
        for my in range(-(-height // (8 * mv))):
            for mx in range(-(-width // (8 * mh))):
                units.append([(ci, my * v + y, mx * h + x)
                              for ci, (h, v, _) in enumerate(comps)
                              for y in range(v) for x in range(h)])
    for i, unit in enumerate(units):
        if restart and i and i % restart == 0:
            bits.flush()
            out += bits.out + bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            bits = _Bits()
            preds = [0] * n
        for ci, r, c in unit:
            preds[ci] = _code_block(bits, coefs[ci][r, c], preds[ci])
    bits.flush()
    out += bits.out + b"\xff\xd9"
    return bytes(out)


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
