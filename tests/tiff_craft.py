"""Writers for the TIFF codecs `cv2.imread` reads beyond those of
`container_craft.tiff_bytes` (none, LZW, Deflate, PackBits): the CCITT
fax codings (Modified Huffman, T.4 1-D and 2-D with EOLs and fill bits,
T.6), ThunderScan, SGILog's byte planes, and JPEG streams wrapped as a
TIFF's strips or tiles (the whole stream in each, or its tables moved
into a JPEGTables tag).

The fax code tables are read from the port's own C++ source
(`mergenet_tpu_torch/data/native/codecs.cc`), so files written here
share them with the decoder; `tests/test_torch_port_tiff_codecs.py`
checks those tables against what libtiff's own encoder writes.

Numpy and the standard library only: `chip_smoke.py` rewraps the
committed JPEGs as JPEG-in-TIFF with `jpeg_tiff` on the GPU machine,
which has no cv2 or PIL."""

import bisect
import os
import re
import struct

import numpy as np

import container_craft as cc

_CODECS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mergenet_tpu_torch", "data", "native", "codecs.cc")


def _tables():
    with open(_CODECS) as f:
        src = f.read()

    def strings(name):
        m = re.search(r"%s\[\d+\] = \{(.*?)\};" % name, src, re.S)
        return re.findall(r'"([01]+)"', m.group(1))

    return {n: strings(n) for n in ("kWhiteTerm", "kWhiteMakeup",
                                    "kBlackTerm", "kBlackMakeup",
                                    "kExtMakeup", "kModeCodes")}


T = _tables()
EOL = "000000000001"
#: 2-D mode codes: pass, horizontal, then V(d) for d = b1 - a1 from -3
#: (VR3) to 3 (VL3), as libtiff's vcodes
PASS, HORIZ = T["kModeCodes"][0], T["kModeCodes"][1]
VCODES = {-3: T["kModeCodes"][5], -2: T["kModeCodes"][4],
          -1: T["kModeCodes"][3], 0: T["kModeCodes"][2],
          1: T["kModeCodes"][6], 2: T["kModeCodes"][7],
          3: T["kModeCodes"][8]}


# ---------------------------------------------------------------- CCITT

def span(run, black):
    """The codes of one run as libtiff's putspan writes them: 2560
    makeups while 2624 or more remain, a makeup for the multiple of 64,
    then the terminating code.  A list of code strings."""
    term = T["kBlackTerm"] if black else T["kWhiteTerm"]
    makeup = T["kBlackMakeup"] if black else T["kWhiteMakeup"]
    codes = []
    while run >= 2624:
        codes.append(T["kExtMakeup"][-1])
        run -= 2560
    if run >= 64:
        m = run // 64 * 64
        codes.append(makeup[m // 64 - 1] if m <= 1728
                     else T["kExtMakeup"][(m - 1792) // 64])
        run -= m
    return codes + [term[run]]


def _changes(row):
    """The positions where a row of pixels (1 black) changes colour, the
    pixel before the row taken as white."""
    r = np.asarray(row, np.int8)
    return np.flatnonzero(np.diff(np.concatenate([[0], r]))).tolist()


def row_1d(row):
    """(code, black) pairs of a row of pixels (1 black) in Modified
    Huffman: white and black runs alternating, white first."""
    edges = [0] + _changes(row) + [len(row)]
    out = []
    for k in range(len(edges) - 1):
        out += [(c, k & 1) for c in span(edges[k + 1] - edges[k], k & 1)]
    return out


def row_2d(row, ref):
    """The T.4 2-D / T.6 codes of a row against its reference row, as
    libtiff's Fax3Encode2DRow chooses them (horizontal mode when
    |b1 - a1| > 3); (code, table) pairs, table 'main', 'white' or
    'black'."""
    w = len(row)
    cur, prev = _changes(row), _changes(ref)

    def colour(ch, x):  # the pixel at x (0 past the row)
        return bisect.bisect_right(ch, x) & 1 if x < w else 0

    def finddiff(ch, s, c):  # the first position from s not of colour c
        if s >= w:
            return w
        if colour(ch, s) != c:
            return s
        i = bisect.bisect_right(ch, s)
        return ch[i] if i < len(ch) else w

    out = []
    a0 = 0
    a1 = finddiff(cur, 0, 0)
    b1 = finddiff(prev, 0, 0)
    while True:
        b2 = finddiff(prev, b1, colour(prev, b1))
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = finddiff(cur, a1, colour(cur, a1))
                out.append((HORIZ, "main"))
                first_black = not (a0 + a1 == 0 or colour(cur, a0) == 0)
                out += [(c, "black" if first_black else "white")
                        for c in span(a1 - a0, first_black)]
                out += [(c, "white" if first_black else "black")
                        for c in span(a2 - a1, not first_black)]
                a0 = a2
            else:
                out.append((VCODES[d], "main"))
                a0 = a1
        else:
            out.append((PASS, "main"))
            a0 = b2
        if a0 >= w:
            return out
        c = colour(cur, a0)
        a1 = finddiff(cur, a0, c)
        b1 = finddiff(prev, a0, 1 - c)
        b1 = finddiff(prev, b1, c)


def _bits_to_bytes(bits):
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _libtiff_row_end(pos, avail, codes):
    """libtiff's fax reader (NeedBits16 before each code: 12 bits for a
    white code, 13 for a black one, one byte or two loaded) after a
    row's codes read from bit `pos` with `avail` bits held: (bit
    position, bits held)."""
    for code, black in codes:
        n = 13 if black else 12
        if avail < n:
            avail += 8 if avail + 8 >= n else 16
        avail -= len(code)
        pos += len(code)
    return pos, avail


def fax_strip(rows, scheme, *, options=0, k=2, fill=False, rtc=True,
              first_eol=True, file_offset=8):
    """The CCITT data of a strip of `rows` ((h, w) pixels, 1 black):

    - 2: Modified Huffman, each row from a byte boundary;
    - 32771: the same, each row where libtiff's reader looks for it: past
      the row it drops the bits it holds below a multiple of 16, then a
      byte more when it holds none and stands at an odd byte of the file
      (`file_offset`: where the strip starts in the file);
    - 3: T.4, an EOL before each row (`fill`: zero bits so each EOL ends
      on a byte boundary, T4Options bit 2; `first_eol` False leaves the
      first row's out); with T4Options bit 0, each EOL followed by a tag
      bit, 1 for a 1-D row, 0 for a 2-D one, the first row and every
      k-th after it 1-D; RTC (six EOLs) after the last row unless `rtc`
      is False;
    - 4: T.6, every row 2-D, EOFB after the last.
    """
    rows = np.asarray(rows, np.uint8)
    h, w = rows.shape
    ref = np.zeros(w, np.uint8)
    two_d = scheme == 3 and options & 1
    bits = ""
    pos = avail = 0
    for y in range(h):
        row = rows[y]
        if scheme == 3 and (y or first_eol):
            if fill:
                bits += "0" * ((4 - len(bits)) % 8)
            bits += EOL
        one_d = scheme in (2, 32771) or (scheme == 3 and (
            not two_d or y % k == 0))
        if two_d:
            bits += "1" if one_d else "0"
        if one_d:
            codes = row_1d(row)
        else:
            codes = [(c, 0) for c, _ in row_2d(row, ref)]
        if scheme == 32771:
            start = len(bits)
            pos, avail = _libtiff_row_end(start, avail, codes)
            bits += "".join(c for c, _ in codes)
            drop = avail % 16
            pos += drop
            avail -= drop
            if avail == 0 and (file_offset * 8 + pos) % 16:
                pos += 8
            bits += "0" * (pos - len(bits))
        else:
            bits += "".join(c for c, _ in codes)
            if scheme == 2:
                bits += "0" * (-len(bits) % 8)
        ref = rows[y]
    if scheme == 3 and rtc:
        bits += (EOL + ("1" if two_d else "")) * 6
    if scheme == 4:
        bits += EOL * 2
    return _bits_to_bytes(bits)


def fax_tiff(rows, scheme, *, photometric=0, rows_per_strip=None,
             tile=None, options=0, fill_order=1, fill=False, k=2,
             orientation=None, extra_tags=()):
    """A bilevel TIFF of `rows` ((h, w), 1 for the coder's black runs,
    which photometric 0 shows black and 1 white) in CCITT `scheme` (2,
    3, 4, 32771), in strips or tiles (edge tiles padded with white);
    `options` goes in T4Options (scheme 3) or T6Options (4)."""
    rows = np.asarray(rows, np.uint8)
    h, w = rows.shape
    parts = []
    if tile is None:
        rps = rows_per_strip or h
        parts = [rows[y:y + rps] for y in range(0, h, rps)]
    else:
        th, tw = tile
        for y in range(0, h, th):
            for x in range(0, w, tw):
                t = np.zeros((th, tw), np.uint8)
                p = rows[y:y + th, x:x + tw]
                t[:p.shape[0], :p.shape[1]] = p
                parts.append(t)
    tags = list(extra_tags)
    if scheme == 3:
        tags.append((292, 4, [options | (4 if fill else 0)]))
    elif scheme == 4 and options:
        tags.append((293, 4, [options]))
    # the strips' file offsets, for 32771's alignment: each block starts
    # at an even offset in container_craft's layout
    blocks, at = [], 8
    for p in parts:
        b = fax_strip(p, scheme, options=options, k=k, fill=fill,
                      file_offset=at)
        blocks.append(b)
        at += len(b) + len(b) % 2
    if fill_order == 2:  # fax data is written in its fill order
        blocks = [cc._REVERSED[np.frombuffer(b, np.uint8)].tobytes()
                  for b in blocks]
        tags.append((266, 3, [2]))
    return cc.tiff_bytes(rows[..., None], bits=1, photometric=photometric,
                         compression=scheme, rows_per_strip=rows_per_strip,
                         tile=tile, orientation=orientation, blocks=blocks,
                         extra_tags=tags)


# ----------------------------------------------------------- ThunderScan

def thunder_row(rng, width):
    """Seeded ThunderScan codes of one row of `width` 4-bit pixels: runs,
    2- and 3-bit deltas and raw pixels, exactly `width` pixels."""
    out, n = [], 0
    while n < width:
        k, left = int(rng.integers(0, 4)), width - n
        if k == 0:
            r = int(rng.integers(1, min(63, left) + 1))
            out.append(r)
            n += r
        elif k == 1 and left >= 3:
            d = rng.integers(0, 4, 3)
            d[d == 2] = 1
            out.append(0x40 | int(d[0]) << 4 | int(d[1]) << 2 | int(d[2]))
            n += 3
        elif k == 2 and left >= 2:
            d = rng.integers(0, 8, 2)
            d[d == 4] = 1
            out.append(0x80 | int(d[0]) << 3 | int(d[1]))
            n += 2
        else:
            out.append(0xC0 | int(rng.integers(0, 16)))
            n += 1
    return bytes(out)


# ---------------------------------------------------------------- SGILog

def sgilog_strip(words, nbytes):
    """SGILog data (tif_luv.c) of rows of words ((rows, width) ints of
    `nbytes` bytes: 2 for LogL, 4 for LogLuv): each row's byte planes,
    high byte first, runs of 3 or more equal bytes as (126 + n, byte)
    (n up to 129), the rest as literals (a count below 128, then the
    bytes)."""
    out = bytearray()
    for row in np.asarray(words, np.int64):
        for k in range(nbytes - 1, -1, -1):
            plane = ((row >> (8 * k)) & 255).tolist()
            i, lit = 0, []

            def flush():
                for j in range(0, len(lit), 127):
                    out.append(len(lit[j:j + 127]))
                    out.extend(lit[j:j + 127])
                lit.clear()

            while i < len(plane):
                n = 1
                while i + n < len(plane) and plane[i + n] == plane[i] \
                        and n < 129:
                    n += 1
                if n >= 3:
                    flush()
                    out += bytes([126 + n, plane[i]])
                    i += n
                else:
                    lit.append(plane[i])
                    i += 1
            flush()
    return bytes(out)


# ------------------------------------------------------------ JPEG in TIFF

def jpeg_segments(stream):
    """([(marker, segment bytes)] before the first SOS, the rest from
    SOS on) of a JPEG stream."""
    out, p = [], 2
    while True:
        m = stream[p + 1]
        n = struct.unpack(">H", stream[p + 2:p + 4])[0]
        if m == 0xDA:
            return out, stream[p:]
        out.append((m, stream[p:p + 2 + n]))
        p += 2 + n


def split_tables(stream):
    """(tables-only stream: SOI, the DQT and DHT segments, EOI; the
    abbreviated stream without them) of a JPEG stream."""
    segs, rest = jpeg_segments(stream)
    tables = b"\xff\xd8" + b"".join(s for m, s in segs
                                    if m in (0xDB, 0xC4)) + b"\xff\xd9"
    abbreviated = b"\xff\xd8" + b"".join(s for m, s in segs
                                         if m not in (0xDB, 0xC4)) + rest
    return tables, abbreviated


def jpeg_tiff(streams, size, *, spp=3, photometric=6, subsampling=(2, 2),
              tables=False, rows_per_strip=None, tile=None, planar=1,
              orientation=None, extra_tags=()):
    """A JPEG-compressed TIFF (compression 7) of `size` (h, w) whose
    strips or tiles are the JPEG `streams`, in order; `tables` moves the
    first stream's DQT and DHT segments into a JPEGTables tag and drops
    them from every stream (all streams must share them).
    `subsampling` goes in YCbCrSubsampling (photometric 6; None leaves
    the tag out)."""
    h, w = size
    tags = list(extra_tags)
    if tables:
        tab = split_tables(streams[0])[0]
        streams = [split_tables(s)[1] for s in streams]
        tags.append((347, 7, list(tab)))
    if photometric == 6 and subsampling is not None:
        tags.append((530, 3, list(subsampling)))
    return cc.tiff_bytes(np.zeros((h, w, spp), np.uint8),
                         photometric=photometric, compression=7,
                         rows_per_strip=rows_per_strip, tile=tile,
                         planar=planar, orientation=orientation,
                         blocks=list(streams), extra_tags=tags)


def jpeg_size(stream):
    """(height, width) of a JPEG stream's frame."""
    p = 2
    while True:
        m = stream[p + 1]
        n = struct.unpack(">H", stream[p + 2:p + 4])[0]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return struct.unpack(">HH", stream[p + 5:p + 9])
        p += 2 + n
