"""The port's JPEG 2000 reader (`mergenet_tpu_torch/data/jp2.py` over
`data/native/jp2.cc`, built with g++ at the first call) against
`cv2.imread` (OpenCV 5.0.0 over its bundled OpenJPEG 2.5.3), bit for
bit, and against cv2's refusals (cv2 returns None or raises; the port
raises ValueError naming the file):

- the committed `tests/fixtures/jp2` (`make_jp2_fixtures.py`) against
  cv2's digests, which are held to cv2 here too;
- the table of what cv2 does (PERF.md): precisions 1-16, signed,
  mixed; grey, sRGB, sYCC, CMYK, e-sYCC and unknown colour spaces, ICC
  profiles; 1-4 components in JP2 and raw J2K; subsampling; palettes
  (pclr/cmap, wide entries) and channel definitions (cdef orders,
  alpha, incomplete lists);
- tier 1: the six code-block styles alone and together, code-block
  sizes from 4x4 to 1024x4, RGN max-shift, 9/7 impulses in every band
  of three levels (OpenJPEG's lifting constants and step order);
- tier 2: the five progressions, POC in the main and tile headers,
  precincts, layers, tiles, tile-parts in any order, TNsot 0, PPM/PPT,
  SOP/EPH, up to 31 decomposition levels under position progressions;
- cv2's and Pillow's encoders at their options (rates, layers, tiles,
  RGBA, LA, 16-bit grey, PLT, comments);
- the Part 2 markers (MCT, MCC, MCO, CBD, Rsiz bit 15; ATK and DFS as
  OpenJPEG skips them), HTJ2K's CAP marker and style bit, 32 levels
  under RPCL/PCRL/CPRL and a POC that gives a top resolution no packet
  (HT code-blocks themselves: `test_torch_port_jp2_ht.py`);
- truncated and corrupt files (seeded; the all-variant sweep is marked
  slow, a faster twin runs);
- the JAX package's COCODataset item against the port's on a tiny COCO
  set of JP2 images (cv2.imread against imgproc.imread_rgb);
- the decoder source includes and links no library."""

import contextlib
import hashlib
import io as _io
import json
import os
import pathlib
import re
import struct
import subprocess
import tempfile

import cv2
import numpy as np
import pytest
from PIL import Image

import j2k_craft as jc
from mergenet_tpu_torch.data import imgproc, jp2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "jp2")
with open(os.path.join(FIX, "cv2_digests.json")) as _f:
    DIGESTS = json.load(_f)


def _both(data, tmp_path, name="c"):
    """(cv2's RGB or None, the port's RGB or its ValueError) of file
    bytes `data`."""
    ext = ".j2k" if data[:4] == jp2.J2K_SIGNATURE else ".jp2"
    path = str(tmp_path / (name + ext))
    with open(path, "wb") as f:
        f.write(data)
    try:
        ref = cv2.imread(path)
    except cv2.error:
        ref = None
    try:
        got = imgproc.imread_rgb(path)
    except ValueError as e:
        assert path in str(e), e
        got = e
    return (None if ref is None else ref[..., ::-1]), got


def _as_cv2(data, tmp_path, where="", refused=None):
    """The port reads `data` as cv2 does (or refuses it as cv2 does);
    `refused` pins which of the two cv2 does."""
    ref, got = _both(data, tmp_path)
    if refused is not None:
        assert (ref is None) == refused, (where, "cv2 refused: %s"
                                          % (ref is None))
    if ref is None:
        assert isinstance(got, ValueError), (where, "cv2 refuses, port reads")
        return None
    assert not isinstance(got, ValueError), (where, got)
    assert got.dtype == np.uint8 and got.shape == ref.shape, where
    np.testing.assert_array_equal(got, ref, err_msg=str(where))
    return got


def _digest(img):
    return [list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()]


def _crop():
    bgr = cv2.imread(os.path.join(ROOT, "tests", "fixtures",
                                  "certification512", "bench_img.png"))
    return np.ascontiguousarray(bgr[200:224, 424:461, ::-1])  # 24x37 RGB


CROP = _crop()
WIDE = np.ascontiguousarray(cv2.imread(os.path.join(
    ROOT, "tests", "fixtures", "certification512", "bench_img.png"))[
        192:256, 384:512, ::-1])
COMPS = [CROP[..., k].astype(np.int64) for k in range(3)]


def _pillow(arr, mode=None, **kw):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "p.j2k" if kw.get("no_jp2") else "p.jp2")
        im = Image.fromarray(arr)
        (im if mode is None else im.convert(mode)).save(path, "JPEG2000",
                                                        **kw)
        with open(path, "rb") as f:
            return f.read()


def _cv2_jp2(rgb, x1000):
    ok, buf = cv2.imencode(".jp2", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
    assert ok
    return bytes(buf)


# ------------------------------------------------------------ fixtures

def test_committed_digests_equal_cv2():
    """cv2 still reads (or refuses) every committed file as its digest
    says."""
    for rel, d in DIGESTS.items():
        img = cv2.imread(os.path.join(FIX, rel))
        if d.get("cv2", 1) is None:
            assert img is None, rel
            continue
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        assert _digest(img) == [d["shape"], d["sha256"]], rel


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_committed_file_reads_bit_equal(rel):
    d = DIGESTS[rel]
    path = os.path.join(FIX, rel)
    if d.get("cv2", 1) is None:
        with pytest.raises(ValueError) as e:
            imgproc.imread_rgb(path)
        assert path in str(e.value)
        return
    img = imgproc.imread_rgb(path)
    assert _digest(img) == [d["shape"], d["sha256"]]


def test_committed_lossless_files_are_their_pngs():
    """The lossless files' digests are those of the PNGs they came from
    (recorded by make_jp2_fixtures.py and make_htj2k_fixtures.py;
    chip_smoke.py holds the port's reads to the regenerated PNGs).  cv2's
    writer uses the 5/3 wavelet and no component transform, lossy or
    not; Pillow's files carry 9/7 + ICT and 5/3 + RCT; the HTJ2K files
    5/3 + RCT and 9/7 + ICT with HT code-blocks."""
    def cod(rel):
        with open(os.path.join(FIX, rel), "rb") as f:
            c = dict(jc.segments(jc.codestream(f.read()))[:-1])[0xff52]
        return c[4], c[9]  # MCT, wavelet (1: 5/3)
    lossless = {k: d for k, d in DIGESTS.items() if "png" in d}
    assert sorted(lossless) == ["ht/val_00000_53_rct_ht.jp2",
                                "lossless/val_00000.jp2",
                                "lossless/val_00001.jp2",
                                "pillow/val_00000_53_rct.jp2"]
    for rel, d in lossless.items():
        assert d["png"] == os.path.basename(rel)[:9] + ".png"
        assert d["shape"] == [512, 1024, 3]
    val = [k for k in DIGESTS if k.startswith("val/")]
    assert len(val) == 50
    assert {cod(k) for k in val + ["lossless/val_00000.jp2"]} == {(0, 1)}
    assert cod("pillow/val_00000_53_rct.jp2") == (1, 1)
    assert cod("pillow/val_00000_97_ict.jp2") == (1, 0)
    assert cod("ht/val_00000_53_rct_ht.jp2") == (1, 1)
    assert cod("ht/val_00000_97_ict_ht.jp2") == (1, 0)
    for rel in ("ht/val_00000_53_rct_ht.jp2", "ht/val_00000_97_ict_ht.jp2"):
        with open(os.path.join(FIX, rel), "rb") as f:
            c = dict(jc.segments(jc.codestream(f.read()))[:-1])[0xff52]
        assert c[8] == jc.HT, rel


# ------------------------------------------- what cv2 does (PERF.md table)

def _comp(rng, prec, signed=False, h=12, w=17):
    if signed:
        return rng.integers(-(1 << (prec - 1)), 1 << (prec - 1), (h, w))
    return rng.integers(0, 1 << prec, (h, w))


@pytest.mark.parametrize("space", [16, 17, 18])
@pytest.mark.parametrize("prec", [1, 4, 7, 8, 9, 12, 16])
def test_precision_and_colour_space(prec, space, tmp_path):
    """Precisions under 8 are refused; 9-16 bits shift to 8; grey
    repeats component 0, sYCC goes through cvtColor's YUV2BGR."""
    rng = np.random.default_rng(prec * 100 + space)
    cs = jc.encode([_comp(rng, prec) for _ in range(3)], prec=prec, levels=1)
    _as_cv2(jc.jp2(cs, enumcs=space), tmp_path, (prec, space),
            refused=prec < 8)


@pytest.mark.parametrize("precs", [(8, 12, 8), (8, 4, 8), (12, 8, 8),
                                   (8, 12, 12), (16, 9, 10)])
@pytest.mark.parametrize("space", [16, 18])
def test_mixed_precisions(precs, space, tmp_path):
    rng = np.random.default_rng(sum(precs) + space)
    cs = jc.encode([_comp(rng, p) for p in precs], prec=list(precs), levels=1)
    _as_cv2(jc.jp2(cs, enumcs=space), tmp_path, precs, refused=False)


@pytest.mark.parametrize("prec", [8, 12])
def test_signed_components_refused(prec, tmp_path):
    rng = np.random.default_rng(prec)
    cs = jc.encode([_comp(rng, prec, True) for _ in range(3)], prec=prec,
                   signed=True, levels=1)
    _as_cv2(jc.jp2(cs), tmp_path, prec, refused=True)
    cs = jc.encode([_comp(rng, 8), _comp(rng, 8, True), _comp(rng, 8)],
                   signed=[False, True, False], levels=1)
    _as_cv2(jc.jp2(cs), tmp_path, "one signed", refused=True)


@pytest.mark.parametrize("enumcs,refused", [(0, False), (3, False),
                                            (12, True), (14, False),
                                            (16, False), (17, False),
                                            (18, False), (20, False),
                                            (24, True)])
def test_enumerated_colour_spaces(enumcs, refused, tmp_path):
    """CMYK (12) and e-sYCC (24) are refused; spaces cv2 does not know
    read as sRGB."""
    rng = np.random.default_rng(enumcs)
    cs = jc.encode([_comp(rng, 8) for _ in range(3)], levels=1)
    _as_cv2(jc.jp2(cs, enumcs=enumcs), tmp_path, enumcs, refused=refused)


@pytest.mark.parametrize("ncomp", [1, 2, 3, 4])
@pytest.mark.parametrize("space", [None, 16, 17, 18])
def test_component_counts(ncomp, space, tmp_path):
    """1-4 components, raw J2K (space None) or JP2: sRGB and sYCC need 3;
    grey takes component 0."""
    rng = np.random.default_rng(ncomp * 7 + (space or 0))
    cs = jc.encode([_comp(rng, 8) for _ in range(ncomp)], levels=1)
    data = cs if space is None else jc.jp2(cs, enumcs=space)
    _as_cv2(data, tmp_path, (ncomp, space),
            refused=ncomp < 3 and space != 17)


def test_colour_specification_boxes(tmp_path):
    """ICC profiles (method 2), unknown methods, a second colr box, no
    colr box."""
    rng = np.random.default_rng(3)
    base = jc.jp2(jc.encode([_comp(rng, 8) for _ in range(3)], levels=1),
                  enumcs=17)
    cases = {
        "icc": jc.rebox(base, replace={b"colr": jc.colr(
            meth=2, icc=bytes(range(200)))}),
        "method 3": jc.rebox(base, replace={b"colr": jc.box(
            b"colr", bytes([3, 0, 0]) + struct.pack(">I", 17))}),
        "second colr": jc.rebox(base, add=[jc.colr(16)]),
        "no colr": jc.rebox(base, drop=(b"colr",)),
        "colr first": jc.rebox(base, header=[jc.colr(17), jc.ihdr(12, 17, 3)]),
        "short colr": jc.rebox(base, replace={b"colr": jc.box(
            b"colr", b"\1\0")}),
    }
    for name, data in cases.items():
        _as_cv2(data, tmp_path, name)


@pytest.mark.parametrize("sub", [(2, 1), (1, 2), (2, 2), (4, 4)])
@pytest.mark.parametrize("space", [16, 18])
def test_subsampled_components_refused(sub, space, tmp_path):
    rng = np.random.default_rng(sub[0] * 3 + sub[1])
    h, w = 12, 17
    c = [_comp(rng, 8, h=h, w=w)] + [
        _comp(rng, 8, h=-(-h // sub[1]), w=-(-w // sub[0])) for _ in range(2)]
    cs = jc.encode(c, sub=[(1, 1), sub, sub], levels=1)
    _as_cv2(jc.jp2(cs, enumcs=space), tmp_path, sub, refused=True)


def _palette_file(rng, entries, sizes, items, nc=1, space=16, iprec=8):
    h, w = 12, 17
    idx = rng.integers(0, entries.shape[0] + 4, (h, w)) % (1 << iprec)
    cs = jc.encode([idx] + [_comp(rng, 8) for _ in range(nc - 1)],
                   prec=[iprec] + [8] * (nc - 1), levels=1)
    header = [jc.ihdr(h, w, nc, iprec - 1), jc.colr(space)]
    if sizes is not None:
        header.append(jc.pclr(entries, sizes))
    if items is not None:
        header.append(jc.cmap(items))
    return jc.jp2(cs, header=header)


@pytest.mark.parametrize("sizes", [[8, 8, 8], [9, 9, 9], [12, 12, 12],
                                   [16, 16, 16], [16, 8, 4]])
@pytest.mark.parametrize("iprec", [8, 10])
def test_palette_entries(sizes, iprec, tmp_path):
    """Palette columns become the components (indices past the palette
    clamp to its last entry); cv2 keeps the low byte of entries wider
    than 8 bits after its shift."""
    rng = np.random.default_rng(sum(sizes) + iprec)
    ent = np.stack([rng.integers(0, 1 << s, 20) for s in sizes], 1)
    _as_cv2(_palette_file(rng, ent, sizes, [(0, 1, 0), (0, 1, 1), (0, 1, 2)],
                          iprec=iprec), tmp_path, sizes, refused=False)


def test_palette_mappings(tmp_path):
    """cmap direct use, one column for grey, a palette without cmap, cmap
    errors OpenJPEG refuses."""
    rng = np.random.default_rng(4)
    ent = rng.integers(0, 256, (16, 3))
    cases = {
        "direct": ([(0, 1, 0), (0, 1, 1), (0, 0, 0)], 1, 16, False),
        "all direct": ([(0, 0, 0), (0, 0, 0), (0, 0, 0)], 1, 16, False),
        "no cmap": (None, 1, 16, True),
        "mtyp 2": ([(0, 1, 0), (0, 2, 1), (0, 1, 2)], 1, 16, True),
        "pcol past": ([(0, 1, 0), (0, 1, 1), (0, 1, 5)], 1, 16, True),
        "twice": ([(0, 1, 0), (0, 1, 0), (0, 1, 2)], 1, 16, True),
        "cmp past": ([(0, 1, 0), (3, 1, 1), (0, 1, 2)], 1, 16, True),
        "two comps": ([(0, 1, 0), (0, 1, 1), (1, 0, 0)], 2, 16, False),
    }
    for name, (items, nc, space, refused) in cases.items():
        _as_cv2(_palette_file(rng, ent, [8, 8, 8], items, nc, space),
                tmp_path, name, refused=refused)
    grey = _palette_file(rng, ent[:, :1], [8], [(0, 1, 0)], 1, 17)
    _as_cv2(grey, tmp_path, "grey palette", refused=False)


CDEFS = [
    [(0, 0, 3), (1, 0, 2), (2, 0, 1)],
    [(0, 0, 1), (1, 0, 2), (2, 0, 3)],
    [(0, 0, 2), (1, 0, 1), (2, 0, 3)],
    [(0, 0, 3), (1, 0, 1), (2, 0, 2)],
    [(2, 0, 1), (0, 0, 3), (1, 0, 2)],
    [(0, 0, 1), (1, 0, 2)],
    [(0, 0, 1), (1, 0, 2), (2, 1, 0)],
    [(0, 1, 0), (1, 0, 2), (2, 0, 3)],
    [(0, 0, 1), (1, 0, 2), (2, 0, 3), (2, 0, 3)],
    [(0, 0, 1), (1, 0, 2), (2, 0, 5)],
    [(0, 0, 1), (1, 0, 2), (3, 0, 3)],
    [(0, 65535, 0), (1, 0, 2), (2, 0, 65535)],
]


@pytest.mark.parametrize("items", CDEFS, ids=lambda i: "-".join(
    "%d.%d.%d" % c for c in i))
def test_channel_definitions(items, tmp_path):
    rng = np.random.default_rng(len(items))
    base = jc.jp2(jc.encode([_comp(rng, 8) for _ in range(3)], levels=1))
    _as_cv2(jc.rebox(base, add=[jc.cdef(items)]), tmp_path, items)


@pytest.mark.parametrize("items", [
    [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)],
    [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)],
    [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 2, 0)]], ids=["rgba", "argb",
                                                        "bgra"])
def test_alpha_channels(items, tmp_path):
    rng = np.random.default_rng(len(items) + 10)
    base = jc.jp2(jc.encode([_comp(rng, 8) for _ in range(4)], levels=1))
    _as_cv2(jc.rebox(base, add=[jc.cdef(items)]), tmp_path, items,
            refused=False)
    grey = jc.jp2(jc.encode([_comp(rng, 8), _comp(rng, 8)], levels=1),
                  enumcs=17)
    _as_cv2(jc.rebox(grey, add=[jc.cdef([(0, 1, 0), (1, 0, 1)])]), tmp_path,
            "grey alpha first", refused=False)


# ------------------------------------------------------------ tier 1

STYLES = {"bypass": jc.LAZY, "reset": jc.RESET, "termall": jc.TERMALL,
          "vsc": jc.VSC, "pterm": jc.PTERM, "segsym": jc.SEGSYM,
          "bypass+termall": jc.LAZY | jc.TERMALL,
          "bypass+reset+vsc": jc.LAZY | jc.RESET | jc.VSC, "all": 63}


@pytest.mark.parametrize("name", sorted(STYLES))
def test_code_block_styles(name, tmp_path):
    """Each style round-trips through cv2 (the writer and both readers
    agree on the coefficients) and the port equals cv2; 4x4 and 8x4
    code-blocks with 12 coded bit-planes exercise the raw passes."""
    sty = STYLES[name]
    got = _as_cv2(jc.jp2(jc.encode(COMPS, levels=2, cblk=(3, 3), cblksty=sty,
                                   layers=3, mct=True)), tmp_path, name,
                  refused=False)
    np.testing.assert_array_equal(got, CROP)
    wide = [c[:16, :24] * 16 + (c[:16, :24] & 15) for c in COMPS]  # 12 bits
    _as_cv2(jc.jp2(jc.encode(wide, prec=12, levels=3, cblk=(2, 3),
                             cblksty=sty)), tmp_path, (name, 12),
            refused=False)


@pytest.mark.parametrize("shift", [1, 6, 12])
def test_rgn_max_shift(shift, tmp_path):
    _as_cv2(jc.jp2(jc.encode(COMPS, levels=2, roi=(1, shift,
                                                   (8, 4, 24, 16)))),
            tmp_path, shift, refused=False)


@pytest.mark.parametrize("levels", [1, 3])
def test_97_impulses(levels, tmp_path):
    """One non-zero coefficient in one band of one level, for every band
    and level, at three magnitudes, with and without the ICT: pins
    OpenJPEG's 9/7 constants (K, 2/K and the four lifting steps in their
    order), the dequantisation and lrintf's rounding."""
    zeros = [np.zeros((37, 45), np.int64)] * 3
    for res in range(levels + 1):
        for bandno in ([0] if res == 0 else [1, 2, 3]):
            for val, mct in ((1, False), (-37, True), (300, True)):
                def bands(k, r, b, shape):
                    a = np.zeros(shape, np.int64)
                    if r == res and b == bandno:
                        a[shape[0] // 2, shape[1] // 2] = val * (k + 1)
                    return a
                cs = jc.encode(zeros, levels=levels, reversible=False,
                               mct=mct, quant=(8, 1000), guard=3,
                               bands=bands)
                _as_cv2(jc.jp2(cs), tmp_path, (res, bandno, val),
                        refused=False)


def test_97_quantisation_styles(tmp_path):
    """Expounded steps per band (mantissas and exponents differ) and
    more bands than the QCD lists."""
    rng = np.random.default_rng(8)

    def bands(k, r, b, shape):
        return rng.integers(-40, 41, shape)
    quant = [(8 + (i % 3), (i * 347) % 2048) for i in range(7)]
    _as_cv2(jc.jp2(jc.encode([np.zeros((30, 41), np.int64)] * 3, levels=2,
                             reversible=False, mct=True, quant=quant,
                             bands=bands)), tmp_path, "expounded",
            refused=False)


# ------------------------------------------------------------ tier 2

@pytest.mark.parametrize("prg", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
def test_progressions_precincts_layers(prg, tmp_path):
    got = _as_cv2(jc.jp2(jc.encode(
        COMPS, levels=3, progression=prg, layers=3, cblk=(2, 2),
        precincts=[(2, 2), (2, 3), (3, 2), (3, 3)])), tmp_path, prg,
        refused=False)
    np.testing.assert_array_equal(got, CROP)


POCS = {
    "two orders": [(0, 0, 1, 4, 3, 0), (0, 0, 3, 4, 3, 1)],
    "positions": [(0, 0, 1, 3, 3, 2), (0, 0, 2, 2, 3, 4),
                  (0, 0, 3, 4, 3, 3)],
    "by component": [(0, 0, 3, 4, 1, 4), (0, 1, 3, 4, 3, 2)],
    "by resolution": [(0, 0, 3, 2, 3, 3), (2, 0, 3, 4, 3, 0)],
}


@pytest.mark.parametrize("in_tile", [False, True], ids=["main", "tile"])
@pytest.mark.parametrize("name", sorted(POCS))
def test_poc(name, in_tile, tmp_path):
    got = _as_cv2(jc.jp2(jc.encode(
        COMPS, levels=3, layers=3, pocs=POCS[name], poc_in_tile=in_tile,
        tile=(16, 16) if in_tile else None, cblk=(2, 2),
        precincts=[(2, 2), (2, 3), (3, 2), (3, 3)])), tmp_path, name,
        refused=False)
    np.testing.assert_array_equal(got, CROP)


TOP_SKIPPED = {
    "component 0": [(0, 0, 1, 2, 1, 0), (0, 1, 1, 3, 3, 0)],
    "all components": [(0, 0, 1, 2, 3, 0)],
    "two top resolutions": [(0, 0, 1, 1, 3, 0)],
    "component 1 at resolution 0": [(0, 0, 1, 3, 1, 0), (0, 1, 1, 1, 2, 0),
                                    (0, 2, 1, 3, 3, 0)],
}
#: components stopped at different resolutions: refused under the MCT
UNEQUAL = ("component 0", "component 1 at resolution 0")


def test_poc_leaving_a_top_resolution_is_not_yet_read(tmp_path):
    """OpenJPEG stops the inverse DWT at the highest resolution that had
    a packet (in any tile so far): that resolution's samples, shifted
    and clamped, fill the top left of the tile (a lone tile's whole
    buffer, else the resolution's place on the reduced grid) and the
    rest stays 0; under the MCT, components stopped at different
    resolutions are refused.  The port reads these files as cv2 does."""
    for name, pocs in TOP_SKIPPED.items():
        for mct in (False, True):
            for kw in ({}, dict(tile=(16, 16)),
                       dict(tile=(16, 8), poc_in_tile=True)):
                data = jc.jp2(jc.encode(COMPS, levels=2, pocs=pocs, mct=mct,
                                        **kw))
                got = _as_cv2(data, tmp_path, (name, mct, kw),
                              refused=mct and name in UNEQUAL)
                if got is not None:
                    assert not np.array_equal(got, CROP), (name, mct, kw)
    rng = np.random.default_rng(6)

    def bands(k, r, b, shape):
        return rng.integers(-40, 41, shape)
    for name, pocs in TOP_SKIPPED.items():
        _as_cv2(jc.jp2(jc.encode([np.zeros((24, 37), np.int64)] * 3,
                                 levels=2, reversible=False, mct=True,
                                 bands=bands, pocs=pocs)), tmp_path,
                ("9/7", name), refused=name in UNEQUAL)


PACKAGING = {
    "sop": dict(sop=True),
    "eph": dict(eph=True),
    "sop eph rpcl": dict(sop=True, eph=True, progression="RPCL"),
    "ppm": dict(packed="ppm", tile=(16, 16), tileparts=2),
    "ppm sop eph": dict(packed="ppm", sop=True, eph=True, tile=(16, 16)),
    "ppt": dict(packed="ppt", tile=(16, 16), tileparts=3),
    "ppt eph": dict(packed="ppt", eph=True),
    "tiles": dict(tile=(16, 8)),
    "tiles 1x1": dict(tile=(1, 1), levels=0),
    "tileparts 4": dict(tile=(16, 16), tileparts=4),
    "tnsot 0": dict(tile=(16, 16), tileparts=2, tnsot=False),
    "shuffled": dict(tile=(16, 16), tileparts=2, tile_order=[
        (4, 0), (1, 0), (4, 1), (0, 0), (5, 0), (2, 0), (0, 1), (3, 0),
        (5, 1), (1, 1), (3, 1), (2, 1)]),
    "comment": dict(comment=b"a comment"),
}


@pytest.mark.parametrize("name", sorted(PACKAGING))
def test_packaging(name, tmp_path):
    kw = dict(levels=2, layers=2)
    kw.update(PACKAGING[name])
    got = _as_cv2(jc.jp2(jc.encode(COMPS, **kw)), tmp_path, name,
                  refused=False)
    np.testing.assert_array_equal(got, CROP)


def test_tile_grid_and_image_origins_refused(tmp_path):
    """cv2 reads a component only from the image origin 0, so that a
    tile-grid origin (which cannot pass the image origin) or an image
    origin is refused."""
    for kw in (dict(origin=(5, 3)), dict(origin=(4, 4), tile=(8, 8),
                                         tile_origin=(3, 2))):
        _as_cv2(jc.jp2(jc.encode(COMPS, levels=1, **kw)), tmp_path, kw,
                refused=True)


@pytest.mark.parametrize("prg", ["LRCP", "RPCL", "PCRL", "CPRL"])
@pytest.mark.parametrize("levels", [16, 31])
def test_deep_decompositions(prg, levels, tmp_path):
    """Up to 31 levels (OpenJPEG tests precinct positions past 2^31 in
    64 bits)."""
    small = [c[:12, :17] for c in COMPS]
    _as_cv2(jc.encode(small, levels=levels, progression=prg), tmp_path,
            (prg, levels), refused=False)


def test_32_levels_by_position_not_yet_read(tmp_path):
    """32 levels under a position-driven order: OpenJPEG shifts the
    32-bit dx and dy by the level number, which C leaves undefined at
    32; cv2's x86-64 build shifts by 0 there, and the port does so on
    purpose.  Read as cv2 reads them, with tiles and precincts too, and
    under LRCP."""
    small = [c[:12, :17] for c in COMPS]
    for prg in ("RPCL", "PCRL", "CPRL", "LRCP"):
        _as_cv2(jc.encode(small, levels=32, progression=prg), tmp_path, prg,
                refused=False)
        _as_cv2(jc.encode(COMPS, levels=32, progression=prg, tile=(16, 8)),
                tmp_path, (prg, "tiles"), refused=False)
        _as_cv2(jc.encode(COMPS, levels=32, progression=prg, tile=(16, 16),
                          precincts=[(1, 1)] * 33), tmp_path,
                (prg, "tiles, precincts"), refused=False)


# ------------------------------------------------------- encoders' options

PILLOW = [
    dict(), dict(irreversible=True), dict(irreversible=True,
                                          quality_layers=[20]),
    dict(quality_layers=[40, 20, 5]), dict(irreversible=True, mct=0),
    dict(num_resolutions=1), dict(num_resolutions=5),
    dict(codeblock_size=(4, 4)), dict(codeblock_size=(1024, 4)),
    dict(codeblock_size=(4, 1024)), dict(precinct_size=(16, 16)),
    dict(tile_size=(16, 16)), dict(tile_size=(20, 12), irreversible=True),
    dict(plt=True), dict(comment="x"), dict(no_jp2=True)]


@pytest.mark.parametrize("kw", PILLOW, ids=lambda k: "-".join(
    "%s=%s" % i for i in sorted(k.items())) or "default")
def test_pillow_options(kw, tmp_path):
    _as_cv2(_pillow(CROP, **kw), tmp_path, kw)


@pytest.mark.parametrize("mode", ["RGBA", "LA", "L", "I;16"])
@pytest.mark.parametrize("raw", [False, True], ids=["jp2", "j2k"])
def test_pillow_modes(mode, raw, tmp_path):
    rng = np.random.default_rng(len(mode))
    if mode == "I;16":
        arr = rng.integers(0, 65536, (20, 30)).astype(np.uint16)
        data = _pillow(arr, mode, no_jp2=raw)
    else:
        arr = rng.integers(0, 256, (20, 30, 4)).astype(np.uint8)
        data = _pillow(arr, mode, no_jp2=raw)
    # a raw grey codestream has no colour space: cv2 assumes sRGB and
    # refuses 1 or 2 components
    _as_cv2(data, tmp_path, mode, refused=raw and mode != "RGBA")


@pytest.mark.parametrize("x1000", [1, 10, 50, 200, 1000])
def test_cv2_rates(x1000, tmp_path):
    _as_cv2(_cv2_jp2(WIDE, x1000), tmp_path, x1000, refused=False)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 3), (5, 33),
                                   (67, 3)])
@pytest.mark.parametrize("irreversible", [False, True])
def test_small_and_odd_sizes(shape, irreversible, tmp_path):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    arr = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    _as_cv2(_pillow(arr, irreversible=irreversible,
                    num_resolutions=1 + min(3, min(shape).bit_length() - 1)),
            tmp_path, shape, refused=False)


# ---------------------------------------------- Part 2, HTJ2K's markers

def _mct(z, imct, ymct, values, pack=">H"):
    """An MCT marker: Zmct, Imct, Ymct and the record's elements."""
    return 0xff74, struct.pack(">HHH", z, imct, ymct) + b"".join(
        struct.pack(pack, v) for v in values)


def _mcc(index, nc, deco, offset, shuffle=False, z=0, y=0, q=1, tail=b""):
    """An MCC marker of one array-based collection of nc components."""
    comps = bytes(range(nc))[::-1] if shuffle else bytes(range(nc))
    body = bytes([1]) + struct.pack(">H", nc) + comps
    body += struct.pack(">H", nc) + bytes(range(nc))
    body += ((1 << 16) | (offset << 8) | deco).to_bytes(3, "big")
    return 0xff75, struct.pack(">HBHH", z, index, y, q) + body + tail


def _imct(element, index, array=1):
    return (element << 10) | (array << 8) | index


def _mco(*stages):
    return 0xff77, bytes([len(stages)]) + bytes(stages)


_OFFSETS = _mct(0, _imct(0, 1), 0, [100, 40, 200])
#: name: (main header markers, cv2 refuses, the image differs from the
#: file without them)
PART2 = {
    "MCT Zmct 1": ([(0xff74, b"\0\1\0\0\0\0")], False, False),
    "MCT Ymct 1": ([_mct(0, _imct(0, 1), 1, [1, 2, 3])], False, False),
    "MCT short": ([(0xff74, b"\0\0\0\1\0\0")], True, False),
    "MCC Zmcc 1": ([(0xff75, b"\0\1\0")], False, False),
    "MCC short": ([(0xff75, b"\0\0\1\0\0\0")], True, False),
    "MCO alone": ([(0xff77, b"\0")], False, True),
    "MCO 2 stages": ([(0xff77, b"\2\1\2")], False, False),
    "MCO bad size": ([(0xff77, b"\1\1\2")], True, False),
    "offset int16": ([_OFFSETS, _mcc(5, 3, 0, 1), _mco(5)], False, True),
    "offset int32": ([_mct(0, _imct(1, 1), 0, [10, 200, 0xfffffffd], ">I"),
                      _mcc(5, 3, 0, 1), _mco(5)], False, True),
    "offset float32": ([_mct(0, _imct(2, 1), 0, [10.7, -20.2, 3.9], ">f"),
                        _mcc(5, 3, 0, 1), _mco(5)], False, True),
    "offset float64": ([_mct(0, _imct(3, 1), 0, [100.7, 64.2, -3.9], ">d"),
                        _mcc(5, 3, 0, 1), _mco(5)], False, True),
    "offset and matrix": ([_mct(0, _imct(2, 2, 0), 0, [1, 0, 0, 0, 1, 0, 0,
                                                       0, 1], ">f"),
                           _OFFSETS, _mcc(5, 3, 2, 1), _mco(5)], False, True),
    "matrix of a wrong size": ([_mct(0, _imct(2, 2, 0), 0, [1, 0, 0], ">f"),
                                _mcc(5, 3, 2, 0), _mco(5)], True, False),
    "offsets of a wrong size": ([_mct(0, _imct(0, 1), 0, [10, 20]),
                                 _mcc(5, 3, 0, 1), _mco(5)], True, False),
    "MCC naming no MCT": ([_mcc(5, 3, 0, 7), _mco(5)], True, False),
    "MCO naming no MCC": ([_OFFSETS, _mcc(5, 3, 0, 1), _mco(6)], False,
                          True),
    # opj_j2k_add_mct never looks past the first MCC record
    "MCO naming the second MCC": ([_OFFSETS, _mcc(4, 3, 0, 0),
                                   _mcc(5, 3, 0, 1), _mco(5)], False, True),
    "MCO naming the first MCC": ([_OFFSETS, _mcc(5, 3, 0, 1),
                                  _mcc(4, 3, 0, 0), _mco(5)], False, True),
    "MCC of 2 components": ([_mct(0, _imct(0, 1), 0, [10, 200]),
                             _mcc(5, 2, 0, 1), _mco(5)], False, True),
    "MCC shuffled": ([_OFFSETS, _mcc(5, 3, 0, 1, shuffle=True), _mco(5)],
                     False, True),
    "MCC no collection": ([(0xff75, struct.pack(">HBHH", 0, 5, 0, 0)),
                           _mco(5)], False, True),
    "MCC 2 collections": ([_mcc(5, 3, 0, 1, q=2), _mco(5)], False, True),
    "MCC trailing byte": ([_OFFSETS, _mcc(5, 3, 0, 1, tail=b"\0"), _mco(5)],
                          True, False),
    "MCT record replaced": ([_OFFSETS, _mcc(5, 3, 0, 1),
                             _mct(0, _imct(0, 1), 0, [50, 60, 70]), _mco(5)],
                            False, True),
    "MCO before MCC": ([_mco(5), _OFFSETS, _mcc(5, 3, 0, 1)], False, True),
    "CBD 8 bits": ([(0xff78, b"\0\3\7\7\7")], False, False),
    "CBD 12 10 8 bits": ([(0xff78, b"\0\3\x0b\x09\x07")], False, True),
    "CBD 4 bits": ([(0xff78, b"\0\3\3\3\3")], True, False),
    "CBD signed": ([(0xff78, b"\0\3\x87\7\7")], True, False),
    "CBD 32 bits": ([(0xff78, b"\0\3\x1f\7\7")], True, False),
    "CBD count": ([(0xff78, b"\0\2\7\7\7")], True, False),
    "CBD size": ([(0xff78, b"\0\3\7\7")], True, False),
    "CAP": ([(0xff50, struct.pack(">IH", 0x00020000, 0))], False, False),
    "CAP empty": ([(0xff50, b"")], False, False),
    "ATK": ([(0xff79, b"\0\1\2\3")], False, False),
    "DFS": ([(0xff72, b"\0\1\1\2")], False, False),
}


@pytest.mark.parametrize("name", sorted(PART2))
def test_htj2k_and_part2_not_yet_read(name, tmp_path):
    """The Part 2 markers as OpenJPEG 2.5.3 reads them (an MCC
    collection's offset array becomes the DC level shifts, MCO alone
    zeroes them, CBD sets the precisions), HTJ2K's CAP marker (read as
    nothing), ATK and DFS (skipped as unknown): each file read as cv2
    reads it, or refused where cv2 refuses it."""
    markers, refused, differs = PART2[name]
    base = jc.encode(COMPS, levels=1)
    got = _as_cv2(jc.jp2(jc.with_main_markers(base, add=markers)), tmp_path,
                  name, refused=refused)
    if got is not None:
        assert (not np.array_equal(got, CROP)) == differs, name


def test_part2_in_tile_headers_and_rsiz(tmp_path):
    """MCT/MCC/MCO in a tile header act on that tile; Rsiz bit 15 (and
    the HT bit 0x4000) change nothing; COD's MCT byte 2 (the array
    transform) and a COD transform of 2 (an ATK wavelet) are refused;
    an HT code-block style on a flat image (no code-block coded)."""
    for markers in ([(0xff77, b"\0")], [_OFFSETS, _mcc(5, 3, 0, 1),
                                        _mco(5)]):
        got = _as_cv2(jc.jp2(jc.encode(COMPS, levels=1, tile=(16, 16),
                                       tile_markers=markers)), tmp_path,
                      markers, refused=False)
        assert not np.array_equal(got, CROP)
    base = jc.encode(COMPS, levels=1)
    for rsiz in (0x8000, 0xc000, 0x4000):
        got = _as_cv2(jc.jp2(jc.set_rsiz(base, rsiz)), tmp_path, rsiz,
                      refused=False)
        np.testing.assert_array_equal(got, CROP)

    def cod(i, v):
        def ed(p):
            p = bytearray(p)
            p[i] = v
            return bytes(p)
        return {0xff52: ed}
    rct = jc.encode(COMPS, levels=1, mct=True)
    for edit in (cod(4, 2), cod(4, 3), cod(9, 2)):
        _as_cv2(jc.jp2(jc.with_main_markers(rct, edit=edit)), tmp_path, edit,
                refused=True)
    empty = jc.encode([np.full((12, 17), 128)] * 3, levels=1)
    cap = (0xff50, struct.pack(">IH", 0x00020000, 0))
    got = _as_cv2(jc.jp2(jc.with_main_markers(jc.set_rsiz(
        jc.set_cblksty(empty, 0x40), 0x4000), add=[cap])), tmp_path, "flat",
        refused=False)
    assert (got == 128).all()


# ------------------------------------------------------------ refusals

def _corruptions(rng, data, n_trunc, n_flip, n_len):
    cases = [("truncated %d" % k, data[:k]) for k in sorted(set(
        int(v) for v in rng.integers(1, len(data), n_trunc)))]
    cases += [("truncated -1", data[:-1]), ("truncated -2", data[:-2]),
              ("trailing bytes", data + b"\0" * 7)]
    for _ in range(n_flip):
        b = bytearray(data)
        i = int(rng.integers(0, len(b)))
        b[i] = int(rng.integers(0, 256))
        cases.append(("byte %d" % i, bytes(b)))
    # marker and box lengths that lie
    spots = [m.start() + 2 for m in re.finditer(b"\xff[\x51-\x64\x90]", data)]
    spots += [m.start() - 4 for m in re.finditer(b"jp2h|jp2c|ihdr|colr",
                                                 data)]
    for _ in range(n_len):
        if not spots:
            break
        i = spots[int(rng.integers(0, len(spots)))]
        b = bytearray(data)
        b[i + 1] ^= 1 << int(rng.integers(0, 8))
        cases.append(("length at %d" % i, bytes(b)))
    return cases


def _base_files():
    small = CROP[:16, :24]
    comps = [small[..., k].astype(np.int64) for k in range(3)]
    return {
        "lossless": _pillow(small),
        "lossy": _pillow(small, irreversible=True, quality_layers=[30]),
        "j2k tiles layers": _pillow(CROP, no_jp2=True, tile_size=(16, 16),
                                    quality_layers=[40, 10],
                                    progression="RPCL"),
        "styles": jc.jp2(jc.encode(comps, levels=2, cblksty=jc.LAZY
                                   | jc.RESET | jc.VSC | jc.SEGSYM,
                                   cblk=(3, 3), layers=2)),
        "termall": jc.jp2(jc.encode(comps, levels=2, cblksty=jc.TERMALL
                                    | jc.PTERM, cblk=(3, 3))),
        "ppm sop eph": jc.jp2(jc.encode(comps, levels=2, packed="ppm",
                                        sop=True, eph=True, layers=2,
                                        tile=(16, 8), tileparts=2)),
        "ppt": jc.jp2(jc.encode(comps, levels=2, packed="ppt", layers=2,
                                tile=(16, 8))),
        "ht": jc.jp2(jc.encode(comps, levels=2, cblksty=jc.HT, cblk=(3, 3))),
        "ht 3 passes": jc.jp2(jc.encode(comps, levels=2, mct=True,
                                        cblksty=jc.HT, ht_passes=3)),
        "palette cdef": jc.rebox(_palette_file(
            np.random.default_rng(2), np.random.default_rng(3).integers(
                0, 256, (16, 3)), [8, 8, 8],
            [(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
            add=[jc.cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])]),
    }


@pytest.mark.parametrize("kind", ["ht", "ht 3 passes", "j2k tiles layers",
                                  "lossless", "lossy", "palette cdef",
                                  "ppm sop eph", "ppt", "styles", "termall"])
def test_corrupt_files_as_cv2(kind, tmp_path):
    rng = np.random.default_rng(sum(map(ord, kind)))
    data = _base_files()[kind]
    for name, bad in _corruptions(rng, data, 10, 16, 4):
        _as_cv2(bad, tmp_path, (kind, name))


@pytest.mark.slow
def test_corrupt_files_as_cv2_all(tmp_path):
    rng = np.random.default_rng(17)
    for rep in range(3):
        for kind, data in _base_files().items():
            for name, bad in _corruptions(rng, data, 40, 120, 20):
                _as_cv2(bad, tmp_path, (rep, kind, name))


def test_box_walk_as_cv2(tmp_path):
    """The JP2 box walk: the signature and ftyp boxes first, jp2h before
    jp2c, misplaced image boxes, unknown boxes, XL lengths, jp2c to the
    end of the file, and boxes after it."""
    rng = np.random.default_rng(21)
    cs = jc.encode([_comp(rng, 8) for _ in range(3)], levels=1)
    ok = jc.jp2(cs)
    sig, ftyp = jc.JP2_SIG, jc.box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
    jp2h = jc.box(b"jp2h", jc.ihdr(12, 17, 3) + jc.colr(16))
    jp2c = jc.box(b"jp2c", cs)
    cases = {
        "plain": (ok, False),
        "unknown box first": (sig + ftyp + jc.box(b"uuid", b"\0" * 20)
                              + jp2h + jp2c, False),
        "xml after": (ok + jc.box(b"xml ", b"<a/>"), False),
        "jp2c length 0": (sig + ftyp + jp2h + jc.box(b"jp2c", cs, 0), False),
        "jp2c length short": (sig + ftyp + jp2h + jc.box(b"jp2c", cs, 20),
                              False),
        "XL box": (sig + ftyp + struct.pack(">I4sQ", 1, b"jp2h", 16 + len(
            jp2h) - 8) + jp2h[8:] + jp2c, False),
        "no jp2h": (sig + ftyp + jp2c, True),
        "jp2c before jp2h": (sig + ftyp + jp2c + jp2h, True),
        "ftyp second missing": (sig + jp2h + jp2c, True),
        "ftyp odd size": (sig + jc.box(b"ftyp", b"jp2 \0\0\0\0jp2") + jp2h
                          + jp2c, True),
        "ihdr size mismatch": (sig + ftyp + jc.box(b"jp2h", jc.ihdr(
            12, 18, 3) + jc.colr(16)) + jp2c, True),
        "misplaced colr after jp2h": (sig + ftyp + jp2h + jc.colr(17)
                                      + jp2c, False),
        "misplaced colr before jp2h": (sig + ftyp + jc.colr(17) + jp2h
                                       + jp2c, False),
        "bpcc": (sig + ftyp + jc.box(b"jp2h", jc.ihdr(12, 17, 3, 255)
                                     + jc.box(b"bpcc", b"\7\7\7")
                                     + jc.colr(16)) + jp2c, False),
        "bpcc short": (sig + ftyp + jc.box(b"jp2h", jc.ihdr(12, 17, 3, 255)
                                           + jc.box(b"bpcc", b"\7\7")
                                           + jc.colr(16)) + jp2c, True),
        "res box": (sig + ftyp + jc.box(b"jp2h", jc.ihdr(12, 17, 3)
                                        + jc.colr(16) + jc.box(
                                            b"res ", b"\0" * 18)) + jp2c,
                    False),
        "two ihdr": (sig + ftyp + jc.box(b"jp2h", jc.ihdr(12, 17, 3)
                                         + jc.ihdr(1, 1, 1) + jc.colr(16))
                     + jp2c, False),
        "jp2h box past its end": (sig + ftyp + jc.box(b"jp2h", jc.ihdr(
            12, 17, 3) + jc.colr(16)[:-2]) + jp2c, True),
    }
    for name, (data, refused) in cases.items():
        _as_cv2(data, tmp_path, name, refused=refused)


def test_dispatch_by_signature(tmp_path):
    """cv2 picks the reader by the first bytes, never by the name: a
    JP2 named .png and a raw codestream named .bmp read."""
    data = jc.jp2(jc.encode(COMPS, levels=1))
    for name, blob in (("x.png", data), ("y.bmp", jc.encode(COMPS, levels=1))):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(blob)
        np.testing.assert_array_equal(imgproc.imread_rgb(path),
                                      cv2.imread(path)[..., ::-1])
    assert jp2.is_jp2(data) and not jp2.is_jp2(data[1:])


# ------------------------------------------------------------ datasets

def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(_io.StringIO()):
        return fn(*a, **kw)


def test_coco_dataset_on_jp2_split_equals_reference(tmp_path):
    """The JAX package's COCODataset (AllDataset, reading with
    cv2.imread) against the port's on a tiny COCO split stored as JPEG
    2000 (lossy JP2, lossless JP2, a raw codestream)."""
    from mergenet_tpu.data import dataset as jdataset
    from mergenet_tpu_torch.data import COCODataset, synthetic
    src, dst = tmp_path / "png", tmp_path / "jp2"
    _quiet(synthetic.generate, str(src), 3, 0, 40, 40, 9, seed=4)
    os.makedirs(dst / "train")
    os.makedirs(dst / "annotations")
    ann = os.path.join("annotations", "instancesonly_train.json")
    with open(src / ann) as f:
        d = json.load(f)
    for k, im in enumerate(d["images"]):
        rgb = cv2.imread(str(src / "train" / im["file_name"]))[..., ::-1]
        if k == 2:
            data = _pillow(np.ascontiguousarray(rgb), no_jp2=True)
        else:
            data = _cv2_jp2(rgb, 1000 if k == 1 else 80)
        im["file_name"] = os.path.splitext(im["file_name"])[0] + (
            ".j2k" if k == 2 else ".jp2")
        with open(dst / "train" / im["file_name"], "wb") as f:
            f.write(data)
    with open(dst / ann, "w") as f:
        json.dump(d, f)
    offsets = ((1, 0), (0, 2), (-2, -1))
    for kw in ({}, dict(scale=2, crop=True, crop_size=16, seed=2)):
        ref = _quiet(jdataset.AllDataset, str(dst / "train"), str(dst / ann),
                     9, offsets, **kw)
        got = _quiet(COCODataset, str(dst / "train"), str(dst / ann), 9,
                     offsets, **kw)
        assert len(got) == len(ref) == 3
        for i in range(3):
            for a, b in zip(got[i], ref[i]):
                np.testing.assert_array_equal(a, b, err_msg="%s %d" % (kw, i))


# ------------------------------------------------------------ build

def test_jp2_decoder_links_no_library():
    """`native/jp2.cc` includes only the C++ standard library and links
    nothing: no OpenJPEG; its float code is not contracted into FMAs and
    targets no particular CPU."""
    src = pathlib.Path(jp2.SRC).read_text()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)", src, re.M)
    assert includes and all("/" not in h and "." not in h
                            for h in includes), includes
    assert not any(f.startswith("-l") for f in jp2.CXX_FLAGS)
    assert "-ffp-contract=off" in jp2.CXX_FLAGS
    assert not any(f.startswith("-march") for f in jp2.CXX_FLAGS)
    needed = subprocess.run(["ldd", jp2.build()], capture_output=True,
                            text=True)
    assert needed.returncode == 0 and "libstdc++" in needed.stdout
    assert "openjp" not in needed.stdout, needed.stdout
