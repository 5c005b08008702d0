"""HTJ2K (JPEG 2000 Part 15) code-blocks in the port's JPEG 2000 reader
(`mergenet_tpu_torch/data/jp2.py` over `data/native/jp2.cc`) against
`cv2.imread` (OpenCV 5.0.0 over its bundled OpenJPEG 2.5.3), bit for
bit, and against cv2's refusals, on files from `tests/j2k_craft.py`'s HT
encoder (cleanup, SigProp and MagRef passes, its VLC codewords built
from the decoder's tables):

- the two context VLC tables in `jp2.cc` are the ones in cv2's binary;
- 5/3 and 9/7 in 1, 2 and 3 passes (one pass of 5/3 is lossless);
- code-blocks from 4x4 to 64x64, 1024x4 and 4x1024;
- the five progressions with precincts, layers, tiles, PPM/PPT,
  SOP/EPH, VSC and the other style bits beside HT; HT on some
  components and Part 1 on the others;
- a flat image, noise, and MagSgn bytes of 0xFF (stuffing);
- what cv2 refuses: a block's passes over several layers, a fourth
  pass, the mixed HT bit, RGN, Mb over 30;
- corrupt HT data: the port reads what cv2 reads bit-equal or raises,
  and never returns another image (the all-case sweep is marked slow)."""

import collections
import os
import re

import cv2
import numpy as np
import pytest

import j2k_craft as jc
from test_torch_port_jp2 import COMPS, WIDE, _as_cv2, _both

WCOMPS = [WIDE[..., k].astype(np.int64) for k in range(3)]


def _ht(comps, **kw):
    k = dict(cblksty=jc.HT)
    k.update(kw)
    return jc.jp2(jc.encode(comps, **k))


def test_vlc_tables_are_cv2s():
    """`jp2.cc`'s VLC_TBL0 and VLC_TBL1 (as little-endian 16-bit words)
    lie in cv2's shared object, where its OpenJPEG keeps them; every
    codeword is 1-7 bits, and a quad without u_off has no EMB bits."""
    t0, t1 = jc.vlc_tables()
    here = os.path.dirname(cv2.__file__)
    so = [f for f in os.listdir(here) if f.startswith("cv2") and
          f.endswith(".so")]
    with open(os.path.join(here, so[0]), "rb") as f:
        blob = f.read()
    for t in (t0, t1):
        assert blob.find(np.asarray(t, "<u2").tobytes()) >= 0
        a = np.asarray(t)
        assert ((a & 7) >= 1).all()
        assert not ((((a >> 3) & 1) == 0) & ((a >> 12) != 0)).any()
        assert not (((a >> 8) & 15) & ~(a >> 12)).any()  # e_1 within e_k


@pytest.mark.parametrize("passes", [1, 2, 3])
@pytest.mark.parametrize("wavelet", ["53", "97"])
def test_ht_passes_and_wavelets(passes, wavelet, tmp_path):
    """5/3 with RCT, 9/7 with ICT, in 1-3 passes (cleanup, SigProp,
    MagRef); one pass of 5/3 reads back the image."""
    kw = dict(levels=2, mct=True, ht_passes=passes)
    if wavelet == "97":
        kw.update(reversible=False, quant=(9, 700))
    for comps in (COMPS, WCOMPS):
        got = _as_cv2(_ht(comps, **kw), tmp_path, (passes, wavelet),
                      refused=False)
        if passes == 1 and wavelet == "53":
            np.testing.assert_array_equal(
                got, np.dstack(comps).astype(np.uint8))


@pytest.mark.parametrize("cblk", [(2, 2), (3, 2), (2, 4), (4, 4), (5, 5),
                                  (6, 6), (10, 2), (2, 10)],
                         ids=lambda c: "%dx%d" % (1 << c[0], 1 << c[1]))
def test_ht_code_block_sizes(cblk, tmp_path):
    wide = [np.tile(c, (1, 5))[:, :300] for c in COMPS]
    for passes in (1, 3):
        _as_cv2(_ht(wide, levels=2, cblk=cblk, ht_passes=passes), tmp_path,
                (cblk, passes), refused=False)


@pytest.mark.parametrize("prg", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
def test_ht_progressions(prg, tmp_path):
    for passes, layers in ((3, 1), (1, 3)):
        _as_cv2(_ht(WCOMPS, levels=3, progression=prg, layers=layers,
                    cblk=(2, 2), precincts=[(2, 2), (3, 3), (3, 4), (4, 4)],
                    ht_passes=passes, tile=(48, 40)), tmp_path, prg,
                refused=False)


PACKAGING = {
    # a block's passes all in one layer: OpenJPEG reads them
    "layers one pass": (dict(layers=4), False),
    "ppm tileparts": (dict(packed="ppm", tile=(40, 32), tileparts=2,
                           ht_passes=3), False),
    "ppt sop eph": (dict(packed="ppt", sop=True, eph=True, tile=(40, 32),
                         ht_passes=3), False),
    "poc": (dict(pocs=[(0, 0, 1, 2, 3, 4), (0, 0, 1, 3, 3, 2)],
                 ht_passes=2), False),
    "termall layers": (dict(layers=3, ht_passes=3,
                            cblksty=jc.HT | jc.TERMALL), False),
    "vsc": (dict(ht_passes=3, cblksty=jc.HT | jc.VSC, cblk=(4, 2)), False),
    "all styles": (dict(ht_passes=3, cblksty=jc.HT | 63), False),
    "cap rsiz": (dict(ht_passes=3, rsiz=0x4000), False),
    # a later layer's pass joins the cleanup segment (no HT branch in
    # opj_t2_init_seg): Scup or a segment length is refused
    "passes over 2 layers": (dict(layers=2, ht_passes=2), True),
    "passes over 3 layers": (dict(layers=3, ht_passes=3), True),
    "passes over layers vsc": (dict(layers=3, ht_passes=3,
                                    cblksty=jc.HT | jc.VSC), True),
    "passes over layers bypass": (dict(layers=2, ht_passes=3,
                                       cblksty=jc.HT | jc.LAZY), True),
}


@pytest.mark.parametrize("name", sorted(PACKAGING))
def test_ht_packaging(name, tmp_path):
    kw, refused = PACKAGING[name]
    k = dict(levels=2)
    k.update(kw)
    _as_cv2(_ht(WCOMPS, **k), tmp_path, name, refused=refused)


@pytest.mark.parametrize("stys", [(jc.HT, 0, 0), (0, jc.HT, 0),
                                  (jc.HT, jc.HT | jc.VSC, 0),
                                  (jc.TERMALL, jc.HT, jc.LAZY)],
                         ids=lambda t: "-".join("%x" % v for v in t))
def test_ht_per_component_styles(stys, tmp_path):
    """HT on some components, Part 1 on the others (COC markers)."""
    for passes in (1, 3):
        _as_cv2(jc.jp2(jc.encode(COMPS, levels=2, cblk=(3, 3), cblksty=stys,
                                 ht_passes=passes, mct=True)), tmp_path,
                (stys, passes), refused=False)


def _magsgn_has_ff(segs):
    """Whether a code-block's cleanup segment holds a 0xFF in its
    MagSgn bytes."""
    seg = segs[0][0]
    scup = (seg[-1] << 4) + (seg[-2] & 0xf)
    return 0xff in seg[:len(seg) - scup]


def test_ht_flat_noise_and_stuffing(tmp_path):
    """A flat image (code-blocks left out), noise, and coefficients whose
    MagSgn bits are all 1 (0xFF bytes, each followed by a stuffed bit)."""
    _as_cv2(_ht([np.full((24, 37), 200)] * 3, levels=2, ht_passes=3),
            tmp_path, "flat", refused=False)
    rng = np.random.default_rng(11)
    noise = [rng.integers(0, 256, (40, 50)) for _ in range(3)]
    for passes in (1, 2, 3):
        got = _as_cv2(_ht(noise, levels=2, ht_passes=passes), tmp_path,
                      ("noise", passes), refused=False)
        if passes == 1:
            np.testing.assert_array_equal(got, np.dstack(noise))
    block = np.full((16, 16), -128, np.int64)
    block[::3, ::5] = 127
    assert _magsgn_has_ff(jc.encode_ht_cblk(block, 1)[0])

    def bands(k, r, b, shape):
        a = np.full(shape, -128, np.int64)
        a[::3, ::5] = 127
        return a
    for passes in (1, 2, 3):
        _as_cv2(jc.jp2(jc.encode(
            [np.zeros((24, 37), np.int64)] * 3, levels=2, reversible=False,
            mct=True, quant=(12, 0), bands=bands, cblksty=jc.HT,
            ht_passes=passes)), tmp_path, ("0xFF", passes), refused=False)


def test_ht_precisions(tmp_path):
    rng = np.random.default_rng(12)
    for prec in (12, 16):
        comps = [rng.integers(0, 1 << prec, (20, 30)) for _ in range(3)]
        for passes in (1, 3):
            _as_cv2(_ht(comps, prec=prec, levels=2, ht_passes=passes),
                    tmp_path, (prec, passes), refused=False)


def test_ht_refusals(tmp_path):
    """OpenJPEG's limits: more than 3 passes, RGN, Mb over 30, the mixed
    HT bit (0x80) with or without 0x40."""
    _as_cv2(_ht(COMPS, levels=1, ht_passes=3, ht_extra=1), tmp_path,
            "4 passes", refused=True)
    _as_cv2(_ht(COMPS, levels=1, ht_passes=1, ht_extra=3), tmp_path,
            "4 passes from 1", refused=True)
    _as_cv2(_ht(COMPS, levels=1, ht_passes=2, ht_extra=1), tmp_path,
            "3 passes", refused=False)
    _as_cv2(_ht(COMPS, levels=1, roi=(0, 3, (4, 4, 12, 12))), tmp_path,
            "rgn", refused=True)
    rng = np.random.default_rng(13)

    def bands(k, r, b, shape):
        return rng.integers(-3, 4, shape)
    zeros = [np.zeros((12, 17), np.int64)] * 3
    for expn, refused in ((24, False), (25, True)):  # Mb 30, 31
        _as_cv2(_ht(zeros, levels=1, reversible=False, quant=(expn, 0),
                    guard=7, bands=bands), tmp_path, expn, refused=refused)
    for sty in (0xc0, 0x80):
        _as_cv2(jc.jp2(jc.set_cblksty(jc.encode(COMPS, levels=1,
                                                cblksty=jc.HT), sty)),
                tmp_path, sty, refused=True)


# ------------------------------------------------------------ corrupt data

def _bases():
    small = [c[:16, :24] for c in COMPS]
    return {
        "p1": _ht(small, levels=2, cblk=(3, 3)),
        "p3": _ht(WCOMPS, levels=2, ht_passes=3, mct=True),
        "p2 vsc": _ht(small, levels=1, cblksty=jc.HT | jc.VSC, ht_passes=2),
        "97": _ht(small, levels=2, ht_passes=3, reversible=False, mct=True,
                  quant=(9, 100)),
    }


def _flips(data, rng, n):
    """`n` copies of `data` with 1-3 bytes of the tile data changed."""
    start = data.index(b"\xff\x93") + 2
    for _ in range(n):
        b = bytearray(data)
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(start, len(b) - 2))
            b[i] = int(rng.integers(0, 256)) if rng.random() < 0.7 else \
                b[i] ^ (1 << int(rng.integers(0, 8)))
        yield bytes(b)


def _corrupt_outcome(bad, tmp_path, where):
    """"equal", "both refuse" or "port refuses" for a corrupt file; fails
    where the port reads a file cv2 refuses, or reads another image."""
    ref, got = _both(bad, tmp_path)
    if ref is None:
        assert isinstance(got, ValueError), (where, "port reads")
        return "both refuse"
    if isinstance(got, ValueError):
        # OpenJPEG checks the MEL's first 1-4 bytes, as many as the
        # buffer's address leaves to a multiple of 4; the port checks 4
        assert "MEL" in str(got), (where, got)
        return "port refuses"
    np.testing.assert_array_equal(got, ref, err_msg=str(where))
    return "equal"


def _corrupt_tally(tmp_path, n):
    """Counts of each outcome over `n` corrupt copies of each base
    file."""
    tally = collections.Counter()
    for kind, data in _bases().items():
        rng = np.random.default_rng(7 + len(kind))
        for t, bad in enumerate(_flips(data, rng, n)):
            tally[_corrupt_outcome(bad, tmp_path, (kind, t))] += 1
    return tally


def test_ht_corrupt_files_as_cv2(tmp_path):
    tally = _corrupt_tally(tmp_path, 40)
    assert tally["equal"] and tally["both refuse"], tally


@pytest.mark.slow
def test_ht_corrupt_files_as_cv2_all(tmp_path):
    """The sweep `data/jp2.py`'s table counts (2,000 files)."""
    print(_corrupt_tally(tmp_path, 500))


def test_ht_stuffing_rules_on_planted_bytes(tmp_path):
    """Bytes no encoder writes, planted in one code-block's streams: a
    VLC byte after one over 0x8F set to 0xFF (7 bits by the low-7-bits
    rule, its MSB ORed into the next byte), a MagSgn byte after 0xFF with
    its MSB set, and a MEL byte after 0xFF over 0x8F; cv2 and the port
    read each file alike or both refuse it (or the port alone, on its MEL
    check)."""
    rng = np.random.default_rng(14)
    grey = rng.integers(0, 256, (32, 32))
    data = jc.jp2(jc.encode([grey], levels=0, cblksty=jc.HT, cblk=(5, 5)),
                  enumcs=17)
    seg = jc.encode_ht_cblk(grey - 128, 1)[0][0][0]
    at = data.find(seg)
    assert at > 0
    lcup, scup = len(seg), (seg[-1] << 4) + (seg[-2] & 0xf)
    planted = 0
    for k in range(lcup - 2, lcup - scup, -1):  # VLC, in reading order
        if seg[k] > 0x8f and seg[k - 1] != 0xff:
            b = bytearray(data)
            b[at + k - 1] = 0xff
            _corrupt_outcome(bytes(b), tmp_path, ("vlc", k))
            planted += 1
    for k in range(1, lcup - scup):  # MagSgn and MEL
        if seg[k - 1] == 0xff and not seg[k] & 0x80:
            b = bytearray(data)
            b[at + k] |= 0x80
            _corrupt_outcome(bytes(b), tmp_path, ("magsgn/mel", k))
            planted += 1
    assert planted >= 5, planted


def test_ht_truncated_and_lengths(tmp_path):
    """Truncations and lying marker lengths of an HT file."""
    data = _bases()["p3"]
    rng = np.random.default_rng(5)
    for k in sorted(set(int(v) for v in rng.integers(1, len(data), 25))):
        _as_cv2(data[:k], tmp_path, ("truncated", k))
    for m in re.finditer(b"\xff[\x51-\x64\x90]", data):
        b = bytearray(data)
        b[m.start() + 3] ^= 1 << int(rng.integers(0, 8))
        _as_cv2(bytes(b), tmp_path, ("length", m.start()))
