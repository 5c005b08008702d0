"""Writes the constant tables of the port's AV1 decoder
(`mergenet_tpu_torch/data/native/avif.cc`, the block between its
"tables" markers) out of the libaom that cv2 bundles, and confirms each
in a second binary (it needs cv2 and Pillow; it is not a test):

    python tests/make_avif_tables.py

- tables with a symbol in cv2's libaom (`nm -S`): the default CDFs of
  the key-frame y mode, the uv mode, partitions, the intra and inter
  (IntraBC) transform types, the palette colour indices, the MV context that IntraBC's DVs
  use, and every coefficient CDF of the four q contexts; the q lookups;
  the filter-intra taps, `dr_intra_derivative`, the smooth weights, the
  mode-to-angle map, the palette colour contexts, the scans, the
  transform-type sets and the cosine/sine tables.  Each is copied byte
  for byte, with the symbol and file offset in a comment;
- the small CDFs that libaom's compiler folded into unnamed constants
  (skip, IntraBC, delta q/lf, segment ids, filter intra, CfL, transform
  sizes and partitions, palette sizes and modes, angle deltas): their
  values are those of the AV1 specification's default CDF tables, and
  the script asserts that every row (its inverted probabilities and the
  terminating 0) lies in cv2's libaom;
- the base-context offsets (`av1_nz_map_ctx_offset_*`) are computed by
  libaom's own rule and asserted equal to the binary's arrays.

Each table is then searched in Pillow's libavif, which links aom 3.12.1
and dav1d 1.5.1 statically, and in the system's libdav1d; the counts go
to stdout (PERF.md keeps them).  `tests/test_torch_port_avif.py` finds
every table of the block in cv2's libaom again."""

import glob
import os
import re
import struct
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "mergenet_tpu_torch", "data",
                   "native", "avif.cc")
BEGIN = "// ---- tables (tests/make_avif_tables.py) ----\n"
END = "// ---- end of tables ----\n"


def cv2_libaom():
    import cv2
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    return sorted(glob.glob(os.path.join(libs, "libaom-*.so*")))[0]


def cv2_libavif():
    import cv2
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    return sorted(glob.glob(os.path.join(libs, "libavif-*.so*")))[0]


#: libyuv's YUV->RGB constant sets that cv2's libavif picks (BT.601 full
#: and limited, BT.709 full and limited, BT.2020 full and limited)
LIBYUV = ("kYuvJPEGConstants", "kYuvI601Constants", "kYuvF709Constants",
          "kYuvH709Constants", "kYuvV2020Constants", "kYuv2020Constants")


def libyuv_constants(path):
    """[(name, file offset, [UB, UG, VG, VR, YG, YB])] of libyuv's x86
    YuvConstants structs (kUVToB, kUVToG, kUVToR: 32 bytes each, then
    kYToRgb and kYBiasToRgb: 16 int16 each) in cv2's libavif."""
    syms = {}
    for line in subprocess.run(["nm", "-D", path], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        p = line.split()
        if len(p) == 3:
            syms[p[2]] = int(p[0], 16)
    data = open(path, "rb").read()
    out = []
    for name in LIBYUV:
        off = _file_offset(path, syms[name])
        raw = data[off:off + 160]
        yg, yb = struct.unpack_from("<hh", raw, 96)[0], struct.unpack_from(
            "<h", raw, 128)[0]
        out.append((name, off, [raw[0], raw[32], raw[33], raw[65], yg, yb]))
    return out


def _file_offset(path, addr):
    """File offset of a virtual address, from the ELF program headers."""
    data = open(path, "rb").read(1 << 16)
    phoff, = struct.unpack_from("<Q", data, 0x20)
    phentsize, phnum = struct.unpack_from("<HH", data, 0x36)
    for i in range(phnum):
        typ, flags, off, vaddr, paddr, filesz = struct.unpack_from(
            "<IIQQQQ", data, phoff + i * phentsize)
        if typ == 1 and vaddr <= addr < vaddr + filesz:
            return addr - vaddr + off
    raise ValueError("address 0x%x not in a load segment" % addr)


def pillow_libavif():
    import PIL
    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    return sorted(glob.glob(os.path.join(libs, "libavif-*.so*")))[0]


DAV1D = "/usr/lib/x86_64-linux-gnu/libdav1d.so.6.6.0"

CTYPES = {"u16": ("uint16_t", "<u2"), "i16": ("int16_t", "<i2"),
          "u8": ("uint8_t", "u1"), "i8": ("int8_t", "i1"),
          "i32": ("int32_t", "<i4")}

#: (C name, libaom symbol, element type, dims)
SYMBOLS = [
    ("kKfYModeCdf", "default_kf_y_mode_cdf", "u16", (5, 5, 14)),
    ("kUvModeCdf", "default_uv_mode_cdf", "u16", (2, 13, 15)),
    ("kPartitionCdf", "default_partition_cdf", "u16", (20, 11)),
    ("kIntraExtTxCdf", "default_intra_ext_tx_cdf", "u16", (3, 4, 13, 17)),
    ("kInterExtTxCdf", "default_inter_ext_tx_cdf", "u16", (4, 4, 17)),
    ("kPaletteYColorCdf", "default_palette_y_color_index_cdf", "u16",
     (7, 5, 9)),
    ("kPaletteUvColorCdf", "default_palette_uv_color_index_cdf", "u16",
     (7, 5, 9)),
    ("kNmvContext", "default_nmv_context", "u16", (143,)),
    ("kTxbSkipCdf", "av1_default_txb_skip_cdfs", "u16", (4, 5, 13, 3)),
    ("kEobExtraCdf", "av1_default_eob_extra_cdfs", "u16", (4, 5, 2, 9, 3)),
    ("kDcSignCdf", "av1_default_dc_sign_cdfs", "u16", (4, 2, 3, 3)),
    ("kEobMulti16Cdf", "av1_default_eob_multi16_cdfs", "u16", (4, 2, 2, 6)),
    ("kEobMulti32Cdf", "av1_default_eob_multi32_cdfs", "u16", (4, 2, 2, 7)),
    ("kEobMulti64Cdf", "av1_default_eob_multi64_cdfs", "u16", (4, 2, 2, 8)),
    ("kEobMulti128Cdf", "av1_default_eob_multi128_cdfs", "u16",
     (4, 2, 2, 9)),
    ("kEobMulti256Cdf", "av1_default_eob_multi256_cdfs", "u16",
     (4, 2, 2, 10)),
    ("kEobMulti512Cdf", "av1_default_eob_multi512_cdfs", "u16",
     (4, 2, 2, 11)),
    ("kEobMulti1024Cdf", "av1_default_eob_multi1024_cdfs", "u16",
     (4, 2, 2, 12)),
    ("kCoeffBaseEobCdf", "av1_default_coeff_base_eob_multi_cdfs", "u16",
     (4, 5, 2, 4, 4)),
    ("kCoeffBaseCdf", "av1_default_coeff_base_multi_cdfs", "u16",
     (4, 5, 2, 42, 5)),
    ("kCoeffBrCdf", "av1_default_coeff_lps_multi_cdfs", "u16",
     (4, 5, 2, 21, 5)),
    ("kDcQ8", "dc_qlookup_QTX", "i16", (256,)),
    ("kDcQ10", "dc_qlookup_10_QTX", "i16", (256,)),
    ("kDcQ12", "dc_qlookup_12_QTX", "i16", (256,)),
    ("kAcQ8", "ac_qlookup_QTX", "i16", (256,)),
    ("kAcQ10", "ac_qlookup_10_QTX", "i16", (256,)),
    ("kAcQ12", "ac_qlookup_12_QTX", "i16", (256,)),
    ("kFilterIntraTaps", "av1_filter_intra_taps", "i8", (5, 8, 8)),
    ("kDrIntraDerivative", "dr_intra_derivative", "i16", (90,)),
    ("kSmoothWeights", "smooth_weights", "u8", (124,)),
    ("kModeToAngle", "mode_to_angle_map", "u8", (13,)),
    ("kIntraModeContext", "intra_mode_context", "i32", (13,)),
    ("kPaletteColorContext", "av1_palette_color_index_context_lookup",
     "i32", (9,)),
    ("kNzMapCtxOffset1d", "nz_map_ctx_offset_1d", "i32", (32,)),
    ("kCospi", "av1_cospi_arr_data", "i32", (4, 64)),
    ("kSinpi", "av1_sinpi_arr_data", "i32", (4, 5)),
    ("kExtTxUsed", "av1_ext_tx_used", "i32", (6, 16)),
    ("kExtTxInv", "av1_ext_tx_inv", "i32", (6, 16)),
    ("kNumExtTxSet", "av1_num_ext_tx_set", "i32", (6,)),
    ("kExtTxSetIndex", "ext_tx_set_index", "i32", (2, 6)),
]
SCAN_SIZES = ("4x4", "8x8", "16x16", "32x32", "4x8", "8x4", "8x16", "16x8",
              "16x32", "32x16", "4x16", "16x4", "8x32", "32x8")
ONED_SIZES = ("4x4", "8x8", "16x16", "4x8", "8x4", "8x16", "16x8", "4x16",
              "16x4")
for _s in SCAN_SIZES:
    _w, _h = map(int, _s.split("x"))
    SYMBOLS.append(("kDefaultScan%s" % _s, "default_scan_" + _s, "i16",
                    (_w * _h,)))
for _s in ONED_SIZES:
    _w, _h = map(int, _s.split("x"))
    SYMBOLS.append(("kMrowScan%s" % _s, "mrow_scan_" + _s, "i16",
                    (_w * _h,)))
    SYMBOLS.append(("kMcolScan%s" % _s, "mcol_scan_" + _s, "i16",
                    (_w * _h,)))

#: the small CDFs, as the AV1 specification's tables give them (cumulative
#: probabilities out of 32768, the last, 32768, left out): (C name, dims of
#: the CDF array, symbols, rows)
DSPEC = 28160, 32120, 32677
MEMORY = [
    ("kSkipCdf", (3,), 2, [[31671], [16515], [4576]]),
    ("kIntrabcCdf", (1,), 2, [[30531]]),
    ("kDeltaQCdf", (1,), 4, [DSPEC]),
    ("kDeltaLfCdf", (1,), 4, [DSPEC]),
    ("kDeltaLfMultiCdf", (4,), 4, [DSPEC] * 4),
    ("kSpatialSegCdf", (3,), 8, [
        [5622, 7893, 16093, 18233, 27809, 28373, 32533],
        [14274, 18230, 22557, 24935, 29980, 30851, 32344],
        [27527, 28487, 28723, 28890, 32397, 32647, 32679]]),
    ("kFilterIntraCdf", (22,), 2, [[x] for x in (
        4621, 6743, 5893, 7866, 12551, 9394, 12408, 14301, 12756, 22343,
        16384, 16384, 16384, 16384, 16384, 16384, 12770, 10368, 20229,
        18101, 16384, 16384)]),
    ("kFilterIntraModeCdf", (1,), 5, [[8949, 12776, 17211, 29558]]),
    ("kCflSignCdf", (1,), 8, [[1418, 2123, 13340, 18405, 26972, 28343,
                               32294]]),
    ("kCflAlphaCdf", (6,), 16, [
        [7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704,
         32708, 32712, 32716, 32720, 32724],
        [14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620,
         32647, 32668, 32672, 32676, 32680, 32684],
        [11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673,
         32677, 32681, 32685, 32689, 32693, 32697],
        [26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708,
         32712, 32716, 32720, 32724, 32728, 32732],
        [17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394,
         32464, 32516, 32560, 32576, 32593, 32622],
        [14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144,
         32413, 32520, 32594, 32622, 32656, 32660]]),
    # [max tx category][context]: category 0 has two symbols
    ("kTxSizeCdf", (4, 3), 3, [
        [19968], [19968], [24320],
        [12272, 30172], [12272, 30172], [18677, 30848],
        [12986, 15180], [12986, 15180], [24302, 25602],
        [5782, 11475], [5782, 11475], [16803, 22759]]),
    ("kTxfmSplitCdf", (21,), 2, [[x] for x in (
        28581, 23846, 20847, 24315, 18196, 12133, 18791, 10887, 11005, 27179,
        20004, 11281, 26549, 19308, 14224, 28015, 21546, 14400, 28165, 22401,
        16088)]),
    ("kPaletteYSizeCdf", (7,), 7, [
        [7952, 13000, 18149, 21478, 25527, 29241],
        [7139, 11421, 16195, 19544, 23666, 28073],
        [7788, 12741, 17325, 20500, 24315, 28530],
        [8271, 14064, 18246, 21564, 25071, 28533],
        [12725, 19180, 21863, 24839, 27535, 30120],
        [9711, 14888, 16923, 21052, 25661, 27875],
        [14940, 20797, 21678, 24186, 27033, 28999]]),
    ("kPaletteUvSizeCdf", (7,), 7, [
        [8713, 19979, 27128, 29609, 31331, 32272],
        [5839, 15573, 23581, 26947, 29848, 31700],
        [4426, 11260, 17999, 21483, 25863, 29430],
        [3228, 9464, 14993, 18089, 22523, 27420],
        [3768, 8886, 13091, 17852, 22495, 27207],
        [2464, 8451, 12861, 21632, 25525, 28555],
        [1269, 5435, 10433, 18963, 21700, 25865]]),
    ("kPaletteYModeCdf", (7, 3), 2, [[x] for x in (
        31676, 3419, 1261, 31912, 2859, 980, 31823, 3400, 781, 32030, 3561,
        904, 32309, 7337, 1462, 32265, 4015, 1521, 32450, 7946, 129)]),
    ("kPaletteUvModeCdf", (2,), 2, [[32461], [21488]]),
    ("kAngleDeltaCdf", (8,), 7, [
        [2180, 5032, 7567, 22776, 26989, 30217],
        [2301, 5608, 8801, 23487, 26974, 30330],
        [3780, 11018, 13699, 19354, 23083, 31286],
        [4581, 11226, 15147, 17138, 21834, 28397],
        [1737, 10927, 14509, 19588, 22745, 28823],
        [2664, 10176, 12485, 17650, 21600, 30495],
        [2240, 11096, 15453, 20341, 22561, 28917],
        [3605, 10428, 12459, 17676, 21244, 30655]]),
]

TX_SIZES = ["4x4", "8x8", "16x16", "32x32", "64x64", "4x8", "8x4", "8x16",
            "16x8", "16x32", "32x16", "32x64", "64x32", "4x16", "16x4",
            "8x32", "32x8", "16x64", "64x16"]
def nz_map_offsets(w, h):
    """libaom's av1_nz_map_ctx_offset for a w x h transform, computed by
    its rule, in its column-major coefficient order (index = col * h' +
    row over the coded region of min(w, 32) x min(h, 32) = w' x h')."""
    out = []
    for col in range(min(w, 32)):
        for row in range(min(h, 32)):
            if row == 0 and col == 0:
                out.append(0)
            elif w < h and row < 2:
                out.append(11)
            elif w > h and col < 2:
                out.append(16)
            elif row + col < 2:
                out.append(1)
            elif row + col < 4:
                out.append(6)
            else:
                out.append(21)
    return out


def row_found(binary, row):
    """Whether a CDF row's inverted probabilities lie in `binary`: whole,
    or (where the compiler split the array into 16-byte constants) as
    consecutive pieces of at least three values each found there."""
    inv = [32768 - x for x in row]

    def has(a, b):
        return binary.count(struct.pack("<%dH" % (b - a), *inv[a:b])) > 0
    ok = [True] + [False] * len(inv)  # ok[i]: inv[:i] is covered
    for b in range(1, len(inv) + 1):
        ok[b] = any(ok[a] and (b - a >= 3 or (a, b) == (0, len(inv)))
                    and has(a, b) for a in range(b))
    return ok[-1]


def symbols(path):
    out = {}
    for line in subprocess.run(["nm", "-S", path], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        p = line.split()
        if len(p) == 4 and p[2] in "rR":
            out.setdefault(p[3], (int(p[0], 16), int(p[1], 16)))
    return out


def inv_rows(rows, nsym, pad):
    """libaom's layout of CDF rows: 32768 - p for each probability, then
    0 (32768 inverted) and the adaptation counter, padded to `pad`."""
    out = []
    for r in rows:
        v = [32768 - x for x in r] + [0, 0]
        assert len(v) <= nsym + 1, (r, nsym)
        out += v + [0] * (pad - len(v))
    return out


def c_array(name, ctype, dims, vals, comment):
    body = ", ".join(str(int(v)) for v in vals)
    lines, line = [], "    "
    for tok in body.split(" "):
        if len(line) + len(tok) + 1 > 78:
            lines.append(line.rstrip())
            line = "    "
        line += tok + " "
    lines.append(line.rstrip())
    return "// %s\nstatic const %s %s%s = {\n%s\n};\n" % (
        comment, ctype, name, "".join("[%d]" % d for d in dims),
        "\n".join(lines))


def main():
    aom_path = cv2_libaom()
    aom = open(aom_path, "rb").read()
    second = {"pillow": open(pillow_libavif(), "rb").read()}
    if os.path.exists(DAV1D):
        second["dav1d"] = open(DAV1D, "rb").read()
    syms = symbols(aom_path)
    base = os.path.basename(aom_path)
    blocks, report = [], []
    for cname, sym, et, dims in SYMBOLS:
        addr, size = syms[sym]
        ctype, dt = CTYPES[et]
        n = int(np.prod(dims))
        assert size == n * np.dtype(dt).itemsize, (sym, size, dims)
        raw = aom[addr:addr + size]
        vals = np.frombuffer(raw, dt)
        hits = {k: v.count(raw) for k, v in second.items()}
        blocks.append(c_array(cname, ctype, dims, vals,
                              "%s %s @0x%x (%d bytes)" % (base, sym, addr,
                                                          size)))
        report.append((cname, hits))
    for cname, dims, nsym, rows in MEMORY:
        pad = nsym + 1
        vals = inv_rows(rows, nsym, pad)
        found = {"aom": 0}
        for r in rows:
            assert row_found(aom, r), (cname, r)
        found = {k: sum(row_found(v, r) for r in rows)
                 for k, v in second.items()}
        blocks.append(c_array(cname, "uint16_t", dims + (pad,), vals,
                              "AV1 spec default CDF; every row found in %s"
                              % base))
        report.append((cname, {k: "%d/%d rows" % (v, len(rows))
                               for k, v in found.items()}))
    ls = libyuv_constants(cv2_libavif())
    blocks.append(c_array(
        "kLibyuvConstants", "int32_t", (6, 6), [v for _, _, c in ls for v in c],
        "UB, UG, VG, VR, YG, YB of %s in %s @%s" % (
            ", ".join(n for n, _, _ in ls),
            os.path.basename(cv2_libavif()),
            ", ".join("0x%x" % o for _, o, _ in ls))))
    checked = []
    for s in TX_SIZES:
        w, h = map(int, s.split("x"))
        sym = "av1_nz_map_ctx_offset_%s" % s
        if sym in syms:
            addr, size = syms[sym]
            assert list(np.frombuffer(aom[addr:addr + size], "i1")) == \
                nz_map_offsets(w, h), s
            checked.append("%s @0x%x" % (s, addr))
    blocks.append("// The base-context offsets (libaom's av1_nz_map_ctx_offset_*)"
                  " are computed by\n// nz_map_offset(); the rule equals %s's"
                  " arrays for\n// %s.\n" % (base, ", ".join(checked)))
    text = "".join(blocks)
    with open(SRC) as f:
        src = f.read()
    a, b = src.index(BEGIN) + len(BEGIN), src.index(END)
    with open(SRC, "w") as f:
        f.write(src[:a] + text + src[b:])
    for cname, hits in report:
        print(cname, hits)


if __name__ == "__main__":
    sys.exit(main())
