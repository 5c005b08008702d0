"""AVIF files for the tests that hold the port's AVIF reader
(`mergenet_tpu_torch/data/avif.py`) to cv2's libavif: an ISOBMFF box
reader and writer (rewrap the AV1 payload that cv2 or Pillow wrote with
other boxes, properties and items), the OBU layer (split, join,
leb128), and a bit reader and writer over the sequence and frame
headers of an intra frame, so that a header field (the loop-filter
levels, the CDEF strengths) can be rewritten while the tile data stays
as the encoder wrote it.

Pure Python; the tests and `tests/make_avif_fixtures.py` use it, the
port never does."""

import struct

# ----------------------------------------------------------------- boxes

CONTAINERS = {b"meta": 4, b"iprp": 0, b"ipco": 0, b"dinf": 0, b"moov": 0,
              b"trak": 0, b"mdia": 0, b"minf": 0, b"stbl": 0, b"edts": 0}


def box(typ, payload, size=None):
    """A box; `size` overrides its size field."""
    n = 8 + len(payload) if size is None else size
    return struct.pack(">I", n) + typ + payload


def full(typ, version, flags, payload):
    return box(typ, bytes([version]) + flags.to_bytes(3, "big") + payload)


def boxes(data, start=0, end=None):
    """[(type, payload start, payload end)] of the boxes in data[start:end]
    (a size of 0 runs to the end; a 64-bit size is read)."""
    end = len(data) if end is None else end
    out, pos = [], start
    while pos + 8 <= end:
        (n,), typ = struct.unpack_from(">I", data, pos), data[pos + 4:pos + 8]
        head = 8
        if n == 1:
            (n,), head = struct.unpack_from(">Q", data, pos + 8), 16
        elif n == 0:
            n = end - pos
        out.append((typ, pos + head, min(pos + n, end)))
        pos += n
    return out


def tree(data, start=0, end=None):
    """{type: [payload bytes or subtree]}-like list of (type, payload or
    children) for the container boxes named in CONTAINERS."""
    out = []
    for typ, a, b in boxes(data, start, end):
        if typ in CONTAINERS:
            out.append((typ, tree(data, a + CONTAINERS[typ], b)))
        else:
            out.append((typ, data[a:b]))
    return out


def find(data, *path):
    """Payload bytes of the first box at `path` (types) in a file."""
    level = tree(data)
    for typ in path:
        level = next(v for t, v in level if t == typ)
    return level


# ------------------------------------------------------------- the model

def parse(data):
    """The still-image model of an AVIF file:

    {"brands": [major, minor, compatible...], "primary": id,
     "items": {id: {"type": b"av01", "data": bytes, "props": [(essential,
                    box bytes)], "name": b""}},
     "refs": [(type, from, [to...])]}

    Item data is gathered from its iloc extents (construction 0 from the
    file, 1 from idat)."""
    meta = find(data, b"meta")
    ftyp = find(data, b"ftyp")
    brands = [ftyp[i:i + 4] for i in range(0, len(ftyp), 4)]
    brands[1] = ftyp[4:8]
    items, refs, primary, idat = {}, [], None, b""
    props, assoc = [], {}
    for typ, val in meta:
        if typ == b"pitm":
            primary = (struct.unpack_from(">H", val, 4)[0] if val[0] == 0
                       else struct.unpack_from(">I", val, 4)[0])
        elif typ == b"idat":
            idat = val
        elif typ == b"iinf":
            n, pos = ((struct.unpack_from(">H", val, 4)[0], 6) if val[0] == 0
                      else (struct.unpack_from(">I", val, 4)[0], 8))
            for t, a, b in boxes(val, pos):
                v = val[a]
                iid, pos2 = ((struct.unpack_from(">H", val, a + 4)[0], a + 8)
                             if v < 3 else
                             (struct.unpack_from(">H", val, a + 4)[0]
                              if v == 2 else
                              struct.unpack_from(">I", val, a + 4)[0], None))
                if v == 2:
                    ityp = val[a + 8:a + 12]
                    name = val[a + 12:b].split(b"\0")[0]
                else:
                    ityp = val[a + 10:a + 14]
                    name = val[a + 14:b].split(b"\0")[0]
                items[iid] = {"type": ityp, "name": name, "props": [],
                              "data": b"", "extents": []}
            del n, pos2
        elif typ == b"iref":
            v = val[0]
            for t, a, b in boxes(val, 4):
                w = 2 if v == 0 else 4
                fmt = ">H" if w == 2 else ">I"
                frm = struct.unpack_from(fmt, val, a)[0]
                cnt = struct.unpack_from(">H", val, a + w)[0]
                to = [struct.unpack_from(fmt, val, a + w + 2 + w * k)[0]
                      for k in range(cnt)]
                refs.append((t, frm, to))
        elif typ == b"iprp":
            for t, v in val:
                if t == b"ipco":
                    props = [box(pt, pv if isinstance(pv, bytes) else b"")
                             for pt, pv in v]
                elif t == b"ipma":
                    assoc_v, flags = v[0], int.from_bytes(v[1:4], "big")
                    (cnt,), pos = struct.unpack_from(">I", v, 4), 8
                    for _ in range(cnt):
                        if assoc_v < 1:
                            iid, pos = struct.unpack_from(">H", v, pos)[0], \
                                pos + 2
                        else:
                            iid, pos = struct.unpack_from(">I", v, pos)[0], \
                                pos + 4
                        k, pos = v[pos], pos + 1
                        lst = []
                        for _ in range(k):
                            if flags & 1:
                                x, pos = struct.unpack_from(">H", v, pos)[0], \
                                    pos + 2
                                lst.append((x >> 15, x & 0x7FFF))
                            else:
                                x, pos = v[pos], pos + 1
                                lst.append((x >> 7, x & 0x7F))
                        assoc[iid] = lst
    iloc = next(v for t, v in meta if t == b"iloc")
    for iid, extents, method in _iloc(iloc):
        src = idat if method == 1 else data
        items[iid]["data"] = b"".join(src[o:o + n] for o, n in extents)
        items[iid]["extents"] = extents
    for iid, lst in assoc.items():
        items[iid]["props"] = [(e, props[i - 1]) for e, i in lst if i]
    return {"brands": brands, "primary": primary, "items": items,
            "refs": refs}


def _iloc(val):
    v = val[0]
    off_size, len_size = val[4] >> 4, val[4] & 15
    base_size, idx_size = val[5] >> 4, (val[5] & 15 if v in (1, 2) else 0)
    pos = 6
    if v < 2:
        (cnt,), pos = struct.unpack_from(">H", val, pos), pos + 2
    else:
        (cnt,), pos = struct.unpack_from(">I", val, pos), pos + 4

    def rd(n):
        nonlocal pos
        x = int.from_bytes(val[pos:pos + n], "big")
        pos += n
        return x
    out = []
    for _ in range(cnt):
        iid = rd(2 if v < 2 else 4)
        method = rd(2) & 15 if v in (1, 2) else 0
        rd(2)  # data reference index
        base = rd(base_size)
        (n,), pos = struct.unpack_from(">H", val, pos), pos + 2
        ext = []
        for _ in range(n):
            if idx_size:
                rd(idx_size)
            ext.append((base + rd(off_size), rd(len_size)))
        out.append((iid, ext, method))
    return out


def ftyp(major=b"avif", minor=0, compatible=(b"avif", b"mif1", b"miaf")):
    return box(b"ftyp", major + struct.pack(">I", minor)
               + b"".join(compatible))


def infe(iid, typ, name=b"", hidden=False):
    return full(b"infe", 2, int(hidden), struct.pack(">HH", iid, 0) + typ
                + name + b"\0")


def write(model, idat=False, split=None, ftyp_box=None, mdat_first=False,
          extra_meta=b"", ipma_flags=0, before_meta=b"", gap=0):
    """An AVIF file of `model` (as `parse` gives it): meta, then mdat
    holding each item's data (or idat, construction method 1, with
    `idat`), `gap` zero bytes first. `split` = {id: [n1, n2...]} cuts an
    item into extents of those lengths (the rest in a last extent)."""
    items = model["items"]
    ids = sorted(items)
    props, assoc = [], {}
    for iid in ids:
        lst = []
        for ess, p in items[iid]["props"]:
            if p not in props:
                props.append(p)
            lst.append((ess, props.index(p) + 1))
        assoc[iid] = lst
    ipco = box(b"ipco", b"".join(props))
    ent = b""
    for iid in ids:
        ent += struct.pack(">HB", iid, len(assoc[iid]))
        for ess, i in assoc[iid]:
            ent += (struct.pack(">H", ess << 15 | i) if ipma_flags & 1
                    else bytes([ess << 7 | i]))
    ipma = full(b"ipma", 0, ipma_flags, struct.pack(">I", len(ids)) + ent)
    iinf = full(b"iinf", 0, 0, struct.pack(">H", len(ids)) + b"".join(
        infe(i, items[i]["type"], items[i].get("name", b""))
        for i in ids))
    iref = b""
    if model.get("refs"):
        iref = full(b"iref", 0, 0, b"".join(
            box(t, struct.pack(">HH", f, len(to)) + b"".join(
                struct.pack(">H", x) for x in to))
            for t, f, to in model["refs"]))
    pitm = full(b"pitm", 0, 0, struct.pack(">H", model["primary"]))
    hdlr = full(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 12 + b"\0")
    ft = ftyp_box if ftyp_box is not None else ftyp(
        model["brands"][0], 0, model["brands"][2:])

    def extents(iid):
        d = items[iid]["data"]
        cuts = (split or {}).get(iid, [])
        out, pos = [], 0
        for n in cuts:
            out.append((pos, n))
            pos += n
        out.append((pos, len(d) - pos))
        return out

    def build(base):
        body, loc = b"\0" * gap, []
        for iid in ids:
            ex = []
            for o, n in extents(iid):
                ex.append((base + len(body), n))
                body += items[iid]["data"][o:o + n]
            loc.append((iid, ex))
        if idat:
            ent = b"".join(struct.pack(">HHHH", i, 1, 0, len(ex)) + b"".join(
                struct.pack(">II", o - base, n) for o, n in ex)
                for i, ex in loc)
            il = full(b"iloc", 1, 0, bytes([0x44, 0x00])
                      + struct.pack(">H", len(ids)) + ent)
        else:
            ent = b"".join(struct.pack(">HHH", i, 0, len(ex)) + b"".join(
                struct.pack(">II", o, n) for o, n in ex) for i, ex in loc)
            il = full(b"iloc", 0, 0, bytes([0x44, 0x00])
                      + struct.pack(">H", len(ids)) + ent)
        return body, il

    # two passes: the offsets' widths are fixed, so the sizes are known
    body, il = build(0)
    iprp = box(b"iprp", ipco + ipma)
    metalen = len(full(b"meta", 0, 0, hdlr + pitm + il + iinf + iref
                       + iprp + extra_meta + (box(b"idat", body)
                                              if idat else b"")))
    if idat:
        _, il = build(0)
        meta = full(b"meta", 0, 0, hdlr + pitm + il + iinf + iref + iprp
                    + extra_meta + box(b"idat", body))
        return ft + before_meta + meta
    if mdat_first:
        base = len(ft) + len(before_meta) + 8
        body, il = build(base)
        meta = full(b"meta", 0, 0, hdlr + pitm + il + iinf + iref + iprp
                    + extra_meta)
        return ft + before_meta + box(b"mdat", body) + meta
    base = len(ft) + len(before_meta) + metalen + 8
    body, il = build(base)
    meta = full(b"meta", 0, 0, hdlr + pitm + il + iinf + iref + iprp
                + extra_meta)
    assert len(meta) == metalen
    return ft + before_meta + meta + box(b"mdat", body)


# ------------------------------------------------------------ properties

def ispe(w, h):
    return full(b"ispe", 0, 0, struct.pack(">II", w, h))


def pixi(*depths):
    return full(b"pixi", 0, 0, bytes([len(depths), *depths]))


def colr_nclx(primaries=1, transfer=13, matrix=6, full_range=1):
    return box(b"colr", b"nclx" + struct.pack(">HHHB", primaries, transfer,
                                              matrix, full_range << 7))


def colr_icc(icc):
    return box(b"colr", b"prof" + icc)


def irot(angle):
    return box(b"irot", bytes([angle & 3]))


def imir(axis):
    return box(b"imir", bytes([axis & 1]))


def clap(w, h, hoff=(0, 1), voff=(0, 1)):
    return box(b"clap", struct.pack(">iIiIiIiI", w, 1, h, 1, hoff[0],
                                    hoff[1], voff[0], voff[1]))


def auxc(urn=b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"):
    return full(b"auxC", 0, 0, urn + b"\0")


def av1c(seq):
    """The av1C box of a sequence header (a parsed `SeqHeader`) and its
    OBU bytes as configOBUs."""
    b0 = 0x81
    b1 = seq["profile"] << 5 | seq["level"]
    b2 = (seq["tier"] << 7 | (seq["bit_depth"] > 8) << 6
          | (seq["bit_depth"] == 12) << 5 | seq["mono"] << 4
          | seq["ssx"] << 3 | seq["ssy"] << 2 | seq["csp"])
    return box(b"av1C", bytes([b0, b1, b2, 0]) + seq["obu"])


def grid(rows, cols, w, h):
    return bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", w, h)


# ------------------------------------------------------------------ OBUs

OBU_SEQUENCE_HEADER, OBU_TD, OBU_FRAME_HEADER, OBU_TILE_GROUP = 1, 2, 3, 4
OBU_METADATA, OBU_FRAME, OBU_PADDING = 5, 6, 15


def leb128(n):
    out = b""
    while True:
        b, n = n & 0x7F, n >> 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def read_leb128(data, pos):
    val = 0
    for i in range(8):
        b = data[pos + i]
        val |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return val, pos + i + 1
    raise ValueError("leb128 too long")


def obus(data):
    """[(type, extension byte or None, payload)] of a run of OBUs, each
    with its size field."""
    out, pos = [], 0
    while pos < len(data):
        h = data[pos]
        typ, ext, has_size = h >> 3 & 15, h >> 2 & 1, h >> 1 & 1
        pos += 1
        e = None
        if ext:
            e, pos = data[pos], pos + 1
        if has_size:
            n, pos = read_leb128(data, pos)
        else:
            n = len(data) - pos
        out.append((typ, e, data[pos:pos + n]))
        pos += n
    return out


def obu(typ, payload, ext=None):
    h = typ << 3 | 2 | (4 if ext is not None else 0)
    return bytes([h]) + (bytes([ext]) if ext is not None else b"") + \
        leb128(len(payload)) + payload


def join(units):
    return b"".join(obu(t, p, e) for t, e, p in units)


# ------------------------------------------------------------------ bits

class Bits:
    """MSB-first bit reader that records where it read each field."""

    def __init__(self, data, pos=0):
        self.data, self.pos = data, pos

    def f(self, n):
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3] if self.pos >> 3 < len(
                self.data) else 0
            v = v << 1 | (byte >> (7 - (self.pos & 7)) & 1)
            self.pos += 1
        return v

    def su(self, n):
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v

    def ns(self, n):
        w, x = 0, n
        while x:
            w, x = w + 1, x >> 1
        m = (1 << w) - n
        v = self.f(w - 1)
        return v if v < m else (v << 1) - m + self.f(1)

    def uvlc(self):
        lz = 0
        while not self.f(1):
            lz += 1
        return 0 if lz >= 32 else self.f(lz) + (1 << lz) - 1


class BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def su(self, n, v):
        self.f(n, v & ((1 << n) - 1))

    def copy(self, data, a, b):
        """Bits a..b (exclusive) of `data`."""
        r = Bits(data, a)
        self.bits += [r.f(1) for _ in range(b - a)]

    def bytes(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def seq_header(payload):
    """The fields of a sequence header OBU that the tests read."""
    r = Bits(payload)
    s = {"obu": obu(OBU_SEQUENCE_HEADER, payload)}
    s["profile"], s["still"], s["reduced"] = r.f(3), r.f(1), r.f(1)
    s["timing"] = s["decoder_model"] = 0
    s["tier"] = 0
    if s["reduced"]:
        s["level"] = r.f(5)
    else:
        s["timing"] = r.f(1)
        if s["timing"]:
            r.f(32), r.f(32)
            if r.f(1):
                r.uvlc()
            s["decoder_model"] = r.f(1)
            if s["decoder_model"]:
                s["buffer_delay_len"] = r.f(5) + 1
                r.f(32)
                s["removal_len"] = r.f(5) + 1
                s["presentation_len"] = r.f(5) + 1
        idd = r.f(1)
        s["ops"] = []
        for i in range(r.f(5) + 1):
            idc, lvl = r.f(12), r.f(5)
            tier = r.f(1) if lvl > 7 else 0
            if i == 0:
                s["level"], s["tier"] = lvl, tier
            dm = 0
            if s["decoder_model"]:
                dm = r.f(1)
                if dm:
                    r.f(s["buffer_delay_len"]), r.f(s["buffer_delay_len"])
                    r.f(1)
            if idd and r.f(1):
                r.f(4)
            s["ops"].append((idc, dm))
    wb, hb = r.f(4) + 1, r.f(4) + 1
    s["wbits"], s["hbits"] = wb, hb
    s["max_w"], s["max_h"] = r.f(wb) + 1, r.f(hb) + 1
    s["frame_ids"] = 0 if s["reduced"] else r.f(1)
    if s["frame_ids"]:
        s["id_len"] = r.f(4) + 2 + r.f(3) + 1
    s["sb128"], s["filter_intra"], s["edge_filter"] = r.f(1), r.f(1), r.f(1)
    s["screen"], s["int_mv"], s["order_bits"] = 2, 2, 0
    if not s["reduced"]:
        r.f(1), r.f(1), r.f(1), r.f(1)
        order = r.f(1)
        if order:
            r.f(1), r.f(1)
        s["screen"] = 2 if r.f(1) else r.f(1)
        if s["screen"]:
            s["int_mv"] = 2 if r.f(1) else r.f(1)
        if order:
            s["order_bits"] = r.f(3) + 1
    s["superres"], s["cdef"], s["restoration"] = r.f(1), r.f(1), r.f(1)
    hbd = r.f(1)
    s["bit_depth"] = (12 if r.f(1) else 10) if s["profile"] == 2 and hbd \
        else (10 if hbd else 8)
    s["mono"] = 0 if s["profile"] == 1 else r.f(1)
    s["cp"] = s["tc"] = s["mc"] = 2
    if r.f(1):
        s["cp"], s["tc"], s["mc"] = r.f(8), r.f(8), r.f(8)
    s["csp"], s["sep_uv"] = 0, 0
    if s["mono"]:
        s["range"], s["ssx"], s["ssy"] = r.f(1), 1, 1
    elif (s["cp"], s["tc"], s["mc"]) == (1, 13, 0):
        s["range"], s["ssx"], s["ssy"] = 1, 0, 0
    else:
        s["range"] = r.f(1)
        if s["profile"] == 0:
            s["ssx"] = s["ssy"] = 1
        elif s["profile"] == 1:
            s["ssx"] = s["ssy"] = 0
        elif s["bit_depth"] == 12:
            s["ssx"] = r.f(1)
            s["ssy"] = r.f(1) if s["ssx"] else 0
        else:
            s["ssx"], s["ssy"] = 1, 0
        if s["ssx"] and s["ssy"]:
            s["csp"] = r.f(2)
    if not s["mono"]:
        s["sep_uv"] = r.f(1)
    s["film_grain"] = r.f(1)
    s["planes"] = 1 if s["mono"] else 3
    return s


def _tile_log2(blk, target):
    k = 0
    while blk << k < target:
        k += 1
    return k


def frame_header(payload, s):
    """The fields of an intra frame header (an OBU_FRAME or
    OBU_FRAME_HEADER payload) that the tests read and rewrite, with the
    bit ranges [start, end) of the loop-filter and CDEF parameters and
    the header's length in bits (`end`, before the byte alignment)."""
    r = Bits(payload)
    h = {}
    if s["reduced"]:
        h["type"], show = 0, 1
    else:
        if r.f(1):
            raise ValueError("show_existing_frame")
        h["type"], show = r.f(2), r.f(1)
        if show and s["decoder_model"]:
            pass  # equal_picture_interval not kept: the tests' files lack it
        if not show:
            r.f(1)
        if not (h["type"] == 0 and show):
            r.f(1)
    if h["type"] not in (0, 2):
        raise ValueError("not an intra frame")
    h["disable_cdf_update"] = r.f(1)
    screen = r.f(1) if s["screen"] == 2 else s["screen"]
    if screen and s["int_mv"] == 2:
        r.f(1)
    if s["frame_ids"]:
        r.f(s["id_len"])
    override = 0 if s["reduced"] else r.f(1)
    r.f(s["order_bits"])
    if s["decoder_model"] and r.f(1):
        for idc, dm in s["ops"]:
            if dm:
                r.f(s["removal_len"])
    if not (h["type"] == 0 and show):
        r.f(8)
    w, hh = s["max_w"], s["max_h"]
    if override:
        w, hh = r.f(s["wbits"]) + 1, r.f(s["hbits"]) + 1
    h["superres"] = r.f(1) if s["superres"] else 0
    if h["superres"]:
        r.f(3)
    if r.f(1):
        r.f(16), r.f(16)
    h["intrabc"] = r.f(1) if screen else 0
    h["screen"] = screen
    h["w"], h["h"] = w, hh
    if not (s["reduced"] or h["disable_cdf_update"]):
        r.f(1)
    mi_cols, mi_rows = 2 * ((w + 7) >> 3), 2 * ((hh + 7) >> 3)
    sb_shift = 5 if s["sb128"] else 4
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_w_sb = 4096 >> sb_size
    max_area = (4096 * 2304) >> (2 * sb_size)
    min_cols = _tile_log2(max_w_sb, sb_cols)
    max_cols = _tile_log2(1, min(sb_cols, 64))
    max_rows = _tile_log2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, _tile_log2(max_area, sb_rows * sb_cols))
    if r.f(1):
        cl = min_cols
        while cl < max_cols and r.f(1):
            cl += 1
        tw = (sb_cols + (1 << cl) - 1) >> cl
        ncols = -(-sb_cols // tw)
        rl = max(min_tiles - cl, 0)
        while rl < max_rows and r.f(1):
            rl += 1
        th = (sb_rows + (1 << rl) - 1) >> rl
        nrows = -(-sb_rows // th)
    else:
        widest, start, ncols = 0, 0, 0
        while start < sb_cols:
            n = r.ns(min(sb_cols - start, max_w_sb)) + 1
            widest, start, ncols = max(widest, n), start + n, ncols + 1
        area = ((sb_rows * sb_cols) >> (min_tiles + 1) if min_tiles
                else sb_rows * sb_cols)
        maxh = max(area // widest, 1)
        start, nrows = 0, 0
        while start < sb_rows:
            start, nrows = start + r.ns(min(sb_rows - start, maxh)) + 1, \
                nrows + 1
        cl, rl = _tile_log2(1, ncols), _tile_log2(1, nrows)
    h["tile_cols"], h["tile_rows"] = ncols, nrows
    h["tile_size_bytes"] = 4
    if cl or rl:
        r.f(cl + rl)
        h["tile_size_bytes"] = r.f(2) + 1
    h["base_q_idx"] = r.f(8)
    dq = []

    def delta():
        return r.su(7) if r.f(1) else 0
    dq.append(delta())
    if s["planes"] > 1:
        diff = r.f(1) if s["sep_uv"] else 0
        dq += [delta(), delta()]
        if diff:
            dq += [delta(), delta()]
    h["delta_q"] = dq
    h["qm_start"] = r.pos
    h["qmatrix"] = r.f(1)
    if h["qmatrix"]:
        r.f(4), r.f(4)
        if s["sep_uv"]:
            r.f(4)
    h["qm_end"] = r.pos
    h["segmentation"] = r.f(1)
    if h["segmentation"]:
        for _ in range(8):
            for bits, signed in ((8, 1), (6, 1), (6, 1), (6, 1), (6, 1),
                                 (3, 0), (0, 0), (0, 0)):
                if r.f(1) and bits:
                    r.su(bits + 1) if signed else r.f(bits)
    h["delta_q_present"] = r.f(1) if h["base_q_idx"] else 0
    h["delta_lf_present"] = 0
    if h["delta_q_present"]:
        r.f(2)
        if not h["intrabc"]:
            h["delta_lf_present"] = r.f(1)
        if h["delta_lf_present"]:
            r.f(2), r.f(1)
    h["lossless"] = h["base_q_idx"] == 0 and not any(dq) and \
        not h["segmentation"]
    h["lf_start"] = r.pos
    h["lf"] = [0, 0, 0, 0]
    if not (h["lossless"] or h["intrabc"]):
        h["lf"][:2] = [r.f(6), r.f(6)]
        if s["planes"] > 1 and (h["lf"][0] or h["lf"][1]):
            h["lf"][2:] = [r.f(6), r.f(6)]
        h["sharpness"] = r.f(3)
        if r.f(1) and r.f(1):
            for _ in range(10):
                if r.f(1):
                    r.su(7)
    h["lf_end"] = h["cdef_start"] = r.pos
    h["cdef"] = []
    h["cdef_bits"] = 0
    if s["cdef"] and not (h["lossless"] or h["intrabc"]):
        r.f(2)
        h["cdef_bits"] = r.f(2)
        for _ in range(1 << h["cdef_bits"]):
            h["cdef"].append([r.f(4), r.f(2)] + ([r.f(4), r.f(2)]
                                                 if s["planes"] > 1 else []))
    h["cdef_end"] = r.pos
    h["lr"] = []
    if s["restoration"] and not (h["lossless"] or h["intrabc"]):
        h["lr"] = [r.f(2) for _ in range(s["planes"])]
        # the unit shifts that follow are not kept
    return h


def rewrite_filters(payload, s, lf=True, cdef=True, qm=False):
    """An OBU_FRAME payload with its loop-filter levels (`lf`) and CDEF
    strengths (`cdef`) set to 0, and with `qm` its quantizer matrices
    switched off.  The tile data does not read the levels (delta lf is
    read from its own flag) or the matrices, and reads `cdef_idx` with
    the unchanged `cdef_bits`, so the tile group is kept as it was."""
    h = frame_header(payload, s)
    total = _header_end(payload, s, h)
    w = BitWriter()
    if qm and h["qmatrix"]:
        w.copy(payload, 0, h["qm_start"])
        w.f(1, 0)
        w.copy(payload, h["qm_end"], h["lf_start"])
    else:
        w.copy(payload, 0, h["lf_start"])
    if h["lf_end"] > h["lf_start"]:
        if lf:
            w.f(6, 0), w.f(6, 0)
            r = Bits(payload, h["lf_start"] + 12 + (
                12 if s["planes"] > 1 and (h["lf"][0] or h["lf"][1]) else 0))
            w.copy(payload, r.pos, h["lf_end"])
        else:
            w.copy(payload, h["lf_start"], h["lf_end"])
    if h["cdef_end"] > h["cdef_start"]:
        w.copy(payload, h["cdef_start"], h["cdef_start"] + 4)
        if cdef:
            w.f((h["cdef_end"] - h["cdef_start"] - 4), 0)
        else:
            w.copy(payload, h["cdef_start"] + 4, h["cdef_end"])
    w.copy(payload, h["cdef_end"], total)
    head = w.bytes()
    return head + payload[(total + 7) >> 3:]


def _header_end(payload, s, h):
    """Bit length of the uncompressed header (up to the byte alignment
    before the tile group): the fields after CDEF."""
    r = Bits(payload, h["cdef_end"])
    lr = []
    if s["restoration"] and not (h["lossless"] or h["intrabc"]):
        lr = [r.f(2) for _ in range(s["planes"])]
        if any(lr):
            shift = r.f(1)
            if not s["sb128"] and shift:
                r.f(1)
            if s["ssx"] and s["ssy"] and any(lr[1:]):
                r.f(1)
    if not h["lossless"]:
        r.f(1)  # tx_mode_select
    r.f(1)  # reduced_tx_set
    if s["film_grain"]:
        if r.f(1):
            raise ValueError("film grain: header not kept")
    return r.pos


def strip_filters(data, lf=True, cdef=True, qm=False):
    """An AVIF file (one av01 primary item) with its frame header
    rewritten by `rewrite_filters`."""
    m = parse(data)
    it = m["items"][m["primary"]]
    units = obus(it["data"])
    seq = seq_header(next(p for t, e, p in units if t == OBU_SEQUENCE_HEADER))
    units = [(t, e, rewrite_filters(p, seq, lf, cdef, qm) if t == OBU_FRAME
              else p) for t, e, p in units]
    it["data"] = join(units)
    return write(m)


def split_tile_groups(data):
    """An AVIF file whose OBU_FRAME is rewritten as an OBU_FRAME_HEADER
    (the same header bits, then its trailing bits) and one OBU_TILE_GROUP
    per tile (tile_start_and_end_present_flag set, each tile's size field
    dropped for the group's last tile): the tile data as it was."""
    m = parse(data)
    it = m["items"][m["primary"]]
    units = obus(it["data"])
    seq = seq_header(next(p for t, e, p in units if t == OBU_SEQUENCE_HEADER))
    out = []
    for t, e, p in units:
        if t != OBU_FRAME:
            out.append((t, e, p))
            continue
        h = frame_header(p, seq)
        end = _header_end(p, seq, h)
        w = BitWriter()
        w.copy(p, 0, end)
        w.f(1, 1)  # trailing_one_bit, then zeros to the byte
        out.append((OBU_FRAME_HEADER, e, w.bytes()))
        n = h["tile_cols"] * h["tile_rows"]
        bits = _tile_log2(1, h["tile_cols"]) + _tile_log2(1, h["tile_rows"])
        pos = (end + 7) >> 3
        if n > 1:
            # the frame's own group: no start/end flag, then the tiles
            assert not Bits(p, pos * 8).f(1), "a frame with its own ranges"
            pos += 1
            size_bytes = h["tile_size_bytes"]
        tiles = []
        for k in range(n):
            if k == n - 1:
                tiles.append(p[pos:])
            else:
                sz = int.from_bytes(p[pos:pos + size_bytes], "little") + 1
                pos += size_bytes
                tiles.append(p[pos:pos + sz])
                pos += sz
        for k, tile in enumerate(tiles):
            g = BitWriter()
            if n > 1:
                g.f(1, 1)
                g.f(bits, k)
                g.f(bits, k)
            out.append((OBU_TILE_GROUP, e, g.bytes() + tile))
    it["data"] = join(out)
    return write(m)
