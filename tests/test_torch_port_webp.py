"""The port's WebP reader (`mergenet_tpu_torch/data/webp.py` over
`data/native/webp.cc`, built with g++ at the first call) against
`cv2.imread` (OpenCV 5.0.0 over its bundled libwebp), bit for bit, and
against cv2's refusals (cv2 returns None or raises; the port raises
ValueError naming the file):

- the committed `tests/fixtures/webp` (`make_webp_fixtures.py`) against
  cv2's digests, which are held to cv2 here too;
- VP8 (lossy): every quality band, sizes 1x1, odd and past 4096,
  libwebp's encoder options (segments, spatial noise shaping, simple
  and normal filters at each sharpness, methods), and frame headers
  rewritten by `webp_craft.vp8_rewrite` on the same tokens: 1/2/4/8
  token partitions, filter levels 0-63, sharpness 0-7, ref/mode
  deltas, segment ids dropped, segment data absent, absolute or
  relative, the scale, colour-space and clamping bits, profiles 0-7;
- VP8L (lossless): libwebp's encoder (methods, qualities, exact,
  near-lossless, palettes) and streams written by `webp_craft.vp8l`:
  each predictor mode (0-13 and the 14/15 sentinels) on tiles of 4 to
  512 pixels, cross-colour, subtract-green, colour indexing with 1 to
  256 colours (8/4/2/1 pixels a byte, indices past the palette), colour
  caches of 1-11 bits (0 and 12+ refused), simple codes of one or two
  symbols, meta codes, LZ77 with every plane code and plain distances,
  and what the decoder must refuse;
- VP8X: ALPH chunks (raw or lossless, filters 0-3, preprocessing, bad
  headers), ICCP, XMP and unknown chunks, odd padding, EXIF
  orientations 1-8 (II and MM) and which EXIF chunk counts;
- animations: the first frame on a canvas of zeros (smaller, offset,
  with alpha, lossy or lossless; background, blend and dispose bits),
  and the files WebPDemux refuses;
- truncated and corrupt files, RIFF and chunk sizes that lie (seeded;
  the all-variant sweep is marked slow, a faster twin runs);
- the JAX package's COCODataset item against the port's on a tiny COCO
  set of WebP images (cv2.imread against imgproc.imread_rgb);
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

import cv2
import numpy as np
import pytest

import webp_craft as wc
from mergenet_tpu_torch.data import imgproc, webp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "webp")
with open(os.path.join(FIX, "cv2_digests.json")) as _f:
    DIGESTS = json.load(_f)


def _both(data, tmp_path, name="c.webp"):
    """(cv2's RGB or None, the port's RGB or its ValueError) of file
    bytes `data`."""
    path = str(tmp_path / name)
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


def _scene(rng, h, w, smooth=True):
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    if smooth and min(h, w) > 4:
        img = cv2.GaussianBlur(img, (5, 5), 1.5)
        img[h // 3:2 * h // 3, w // 4:w // 2] = rng.integers(0, 256, 3)
    return img


def _cv2_webp(rgb, quality):
    ok, buf = cv2.imencode(".webp", np.ascontiguousarray(rgb[..., ::-1]),
                           [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return bytes(buf)


# ------------------------------------------------------------ fixtures

def test_committed_digests_equal_cv2():
    """cv2 still reads every committed file as its digest says."""
    for rel, d in DIGESTS.items():
        img = cv2.cvtColor(cv2.imread(os.path.join(FIX, rel)),
                           cv2.COLOR_BGR2RGB)
        assert _digest(img) == [d["shape"], d["sha256"]], rel


@pytest.mark.parametrize("rel", sorted(DIGESTS))
def test_committed_file_reads_bit_equal(rel):
    img = imgproc.imread_rgb(os.path.join(FIX, rel))
    assert _digest(img) == [DIGESTS[rel]["shape"], DIGESTS[rel]["sha256"]]


def test_committed_lossless_files_are_their_pngs():
    """The lossless files' digests are those of the PNGs they came from
    (recorded by make_webp_fixtures.py; chip_smoke.py holds the port's
    reads to the regenerated PNGs)."""
    lossless = {k: d for k, d in DIGESTS.items() if "png" in d}
    assert len(lossless) == 2
    for rel, d in lossless.items():
        assert d["png"] == os.path.basename(rel)[:-5] + ".png"
        assert d["shape"] == [512, 1024, 3]
        with open(os.path.join(FIX, rel), "rb") as f:
            assert wc.chunks(f.read())[0][0] == b"VP8L", rel


# ------------------------------------------------------------ VP8

@pytest.mark.parametrize("quality", [1, 5, 10, 20, 30, 40, 50, 60, 70, 80,
                                     90, 95, 100])
def test_vp8_quality(quality, tmp_path):
    rng = np.random.default_rng(quality)
    for h, w in ((1, 1), (3, 5), (17, 33), (48, 64), (37, 53)):
        _as_cv2(_cv2_webp(_scene(rng, h, w, quality % 2 == 0), quality),
                tmp_path, (quality, h, w), refused=False)


@pytest.mark.parametrize("shape", [(1, 17), (17, 1), (16, 15), (15, 16),
                                   (33, 31), (8, 4100), (4097, 3)],
                         ids=lambda s: "%dx%d" % s)
def test_vp8_sizes(shape, tmp_path):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    img = _scene(rng, *shape)
    for q in (50, 101):  # lossy and lossless
        _as_cv2(_cv2_webp(img, q), tmp_path, (shape, q), refused=False)


ENCODER_VP8 = [
    dict(segments=1), dict(segments=2), dict(segments=3), dict(segments=4),
    dict(sns_strength=0), dict(sns_strength=100),
    dict(filter_type=0, filter_strength=50),
    dict(filter_type=1, filter_strength=100),
    dict(filter_strength=0), dict(autofilter=1),
    dict(method=0), dict(method=3), dict(method=6, pass_=3),
    dict(preprocessing=1), dict(use_sharp_yuv=1), dict(quality=3),
] + [dict(filter_type=t, filter_strength=70, filter_sharpness=s)
     for t in (0, 1) for s in range(8)]


@pytest.mark.parametrize("opts", ENCODER_VP8, ids=lambda o: "-".join(
    "%s%s" % kv for kv in o.items()))
def test_vp8_encoder_options(opts, tmp_path):
    rng = np.random.default_rng(len(str(opts)))
    img = _scene(rng, 40, 56)
    _as_cv2(wc.encode(img, **opts), tmp_path, opts, refused=False)


REWRITES = (
    [dict(partitions=p) for p in range(4)]
    + [dict(level=v) for v in (0, 1, 9, 14, 15, 39, 40, 63)]
    + [dict(simple=s, level=30, sharpness=k) for s in (0, 1)
       for k in (0, 1, 4, 5, 7)]
    + [dict(level=20, deltas=([2, None, -3, 4], [4, -2, None, 1])),
       dict(level=5, deltas=([-20, 1, 1, 1], [-30, 0, 0, 0])),
       dict(level=60, deltas=([10, None, None, None], [20, None, None,
                                                       None])),
       dict(deltas=None), dict(drop_map=True), dict(seg_data=None),
       dict(seg_data=(1, [10, 60, None, 127], [0, 63, -10, None])),
       dict(seg_data=(0, [-20, 5, None, 30], [-63, 8, None, 63])),
       dict(colorspace=1), dict(clamp=1), dict(colorspace=1, clamp=1),
       dict(scale=(1, 0)), dict(scale=(3, 2))]
    + [dict(profile=p) for p in range(8)])


@pytest.mark.parametrize("kw", REWRITES, ids=lambda o: "-".join(
    "%s%s" % kv for kv in o.items()))
def test_vp8_rewritten_header(kw, tmp_path):
    """The same tokens under another frame header: libwebp reads every
    profile up to 3 (its filter follows the header's bit, not the
    profile) and refuses the rest."""
    rng = np.random.default_rng(5)
    lossy = wc.encode(_scene(rng, 70, 90), quality=60)
    vp8 = dict(wc.chunks(lossy))[b"VP8 "]
    data = wc.with_vp8(lossy, wc.vp8_rewrite(vp8, **kw))
    _as_cv2(data, tmp_path, kw, refused=kw.get("profile", 0) > 3)


def test_vp8_i4x4_and_i16x16_macroblocks(tmp_path):
    """A frame with both intra sizes (flat and busy areas), a skip
    probability and several segments decodes as cv2 decodes it."""
    rng = np.random.default_rng(8)
    img = _scene(rng, 96, 128)
    img[:48, :64] = 90
    data = wc.encode(img, quality=70, segments=4)
    _, hd, mbs = wc._parse_vp8(dict(wc.chunks(data))[b"VP8 "])
    kinds = {m["i4"] for row in mbs for m in row}
    assert kinds == {True, False} and hd["use_segment"]
    _as_cv2(data, tmp_path, refused=False)


def _random_vp8(rng):
    h, w = (int(v) for v in rng.integers(1, 90, 2))
    opts = dict(quality=float(rng.integers(0, 101)),
                segments=int(rng.integers(1, 5)),
                sns_strength=int(rng.integers(0, 101)),
                filter_type=int(rng.integers(0, 2)),
                filter_strength=int(rng.integers(0, 101)),
                filter_sharpness=int(rng.integers(0, 8)),
                method=int(rng.integers(0, 7)))
    data = wc.encode(_scene(rng, h, w, bool(rng.integers(0, 2))), **opts)
    if rng.integers(0, 2):
        kw = dict(partitions=int(rng.integers(0, 4)),
                  level=int(rng.integers(0, 64)),
                  sharpness=int(rng.integers(0, 8)),
                  simple=int(rng.integers(0, 2)))
        if rng.integers(0, 2):
            kw["deltas"] = tuple([int(v) for v in rng.integers(-63, 64, 4)]
                                 for _ in range(2))
        vp8 = dict(wc.chunks(data))[b"VP8 "]
        data = wc.with_vp8(data, wc.vp8_rewrite(vp8, **kw))
        opts.update(kw)
    return data, opts


@pytest.mark.parametrize("seed", range(4))
def test_vp8_seeded_variants(seed, tmp_path):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(6):
        data, opts = _random_vp8(rng)
        _as_cv2(data, tmp_path, opts, refused=False)


@pytest.mark.slow
def test_vp8_seeded_variants_all(tmp_path):
    rng = np.random.default_rng(2000)
    for _ in range(300):
        data, opts = _random_vp8(rng)
        _as_cv2(data, tmp_path, opts, refused=False)


# ------------------------------------------------------------ VP8L

ENCODER_VP8L = (
    [dict(method=m, quality=q) for m in (0, 2, 4, 6) for q in (0, 75, 100)]
    + [dict(exact=1), dict(near_lossless=0), dict(near_lossless=40),
       dict(near_lossless=80), dict(use_sharp_yuv=1)])


@pytest.mark.parametrize("opts", ENCODER_VP8L, ids=lambda o: "-".join(
    "%s%s" % kv for kv in o.items()))
def test_vp8l_encoder_options(opts, tmp_path):
    rng = np.random.default_rng(len(str(opts)) + 3)
    img = _scene(rng, 45, 67)
    img[:10] = (img[:10] // 64) * 64  # a few colours: caches and copies
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2], np.uint8)])
    for pix in (img, rgba):
        _as_cv2(wc.encode(pix, lossless=True, **opts), tmp_path, opts,
                refused=False)


@pytest.mark.parametrize("ncolors", [2, 3, 4, 5, 16, 17, 256])
def test_vp8l_encoder_palettes(ncolors, tmp_path):
    rng = np.random.default_rng(ncolors)
    pal = rng.integers(0, 256, (ncolors, 3), np.uint8)
    img = pal[rng.integers(0, ncolors, (23, 41))]
    _as_cv2(wc.encode(img, lossless=True), tmp_path, ncolors, refused=False)


def _lits(rng, n):
    return [("lit", int(v)) for v in rng.integers(0, 2 ** 32, n, np.uint64)]


@pytest.mark.parametrize("mode", range(16))
def test_vp8l_predictor_mode(mode, tmp_path):
    """Each predictor mode (14 and 15 as libwebp pads them) on random
    residuals, over tiles of 4 pixels and of more than the image."""
    rng = np.random.default_rng(mode)
    w, h = 19, 11
    for bits in (2, 9):
        tiles = -(-w // (1 << bits)) * -(-h // (1 << bits))
        data = wc.vp8l_file(wc.vp8l(w, h, _lits(rng, w * h), transforms=[
            ("predictor", bits, [mode] * tiles)]))
        _as_cv2(data, tmp_path, (mode, bits), refused=False)


def test_vp8l_predictor_modes_mixed_with_other_transforms(tmp_path):
    rng = np.random.default_rng(21)
    w, h = 37, 21
    for bits in (2, 3, 4):
        tiles = -(-w // (1 << bits)) * -(-h // (1 << bits))
        modes = [int(v) for v in rng.integers(0, 16, tiles)]
        mult = [int(v) for v in rng.integers(0, 2 ** 32, tiles, np.uint64)]
        for order in (("predictor", "cross", "green"),
                      ("green", "cross", "predictor"),
                      ("cross", "predictor")):
            ts = [{"predictor": ("predictor", bits, modes),
                   "cross": ("cross", bits, mult),
                   "green": ("green",)}[k] for k in order]
            data = wc.vp8l_file(wc.vp8l(w, h, _lits(rng, w * h),
                                        transforms=ts))
            _as_cv2(data, tmp_path, (bits, order), refused=False)


@pytest.mark.parametrize("ncolors", [1, 2, 3, 4, 5, 16, 17, 200, 256])
def test_vp8l_colour_indexing(ncolors, tmp_path):
    """Palettes of 1-256 colours (8, 4, 2 or 1 pixels a packed byte),
    indices past the palette (transparent black), alone and before a
    predictor on the packed image."""
    rng = np.random.default_rng(ncolors + 40)
    w, h = 23, 9
    pal = [int(v) for v in rng.integers(0, 2 ** 32, ncolors, np.uint64)]
    bits = 0 if ncolors > 16 else 1 if ncolors > 4 else 2 if ncolors > 2 \
        else 3
    packed_w = -(-w // (1 << bits))
    ops = [("lit", int(v) << 8) for v in rng.integers(0, 256, packed_w * h)]
    data = wc.vp8l_file(wc.vp8l(w, h, ops, transforms=[("palette", pal)]))
    _as_cv2(data, tmp_path, ncolors, refused=False)
    tiles = -(-packed_w // 4) * -(-h // 4)
    data = wc.vp8l_file(wc.vp8l(w, h, ops, transforms=[
        ("palette", pal), ("predictor", 2, [11] * tiles)]))
    _as_cv2(data, tmp_path, (ncolors, "predictor"), refused=False)


@pytest.mark.parametrize("cache_bits", range(13))
def test_vp8l_colour_cache(cache_bits, tmp_path):
    """Caches of 1-11 bits, hits from literals and copies; 0 means no
    cache; 12 and more are refused."""
    rng = np.random.default_rng(cache_bits)
    w, h = 17, 9
    lits = _lits(rng, 40)
    ops = lits[:20] + [("copy", 10, 120 + 5)] + lits[20:40]
    size = 1 << min(cache_bits, 11) if cache_bits else 0
    while sum(o[1] if o[0] == "copy" else 1 for o in ops) < w * h:
        ops.append(("cache", int(rng.integers(0, size))) if size
                   else lits[len(ops) % 40])
    if cache_bits > 11:
        payload = wc.vp8l(w, h, ops[:5], cache_bits=0)
        # rewrite the cache flag: 1, then 4 bits of 12
        data = wc.vp8l_file(_set_cache_bits(payload, 12))
        _as_cv2(data, tmp_path, cache_bits, refused=True)
        return
    data = wc.vp8l_file(wc.vp8l(w, h, ops, cache_bits=cache_bits))
    _as_cv2(data, tmp_path, cache_bits, refused=False)


def _set_cache_bits(payload, bits):
    """A header-only VP8L stream whose main image claims a colour cache
    of `bits` bits (5 header bytes, the transform bit 0, then the cache
    flag and its 4 bits)."""
    v = int.from_bytes(payload, "little")
    pos = 40 + 1
    v = (v & ((1 << pos) - 1)) | (1 << pos) | (bits << (pos + 1))
    return v.to_bytes(len(payload) + 1, "little")


def test_vp8l_simple_codes(tmp_path):
    """Simple prefix codes: one symbol (1- and 8-bit), two symbols in
    either order, a symbol repeated, a distance symbol past the
    alphabet of 40."""
    rng = np.random.default_rng(77)
    w, h = 11, 5
    cases = [{"red": wc._Code(256, simple=(1,))},
             {"red": wc._Code(256, simple=(200,)),
              "blue": wc._Code(256, simple=(0,))},
             {"alpha": wc._Code(256, simple=(255, 3))},
             {"blue": wc._Code(256, simple=(7, 7))},
             {"green": wc._Code(280, simple=(1, 9))}]
    for g in cases:
        used = {ch: sorted(c.codes) for ch, c in g.items()}
        ops = []
        for _ in range(w * h):
            px = {ch: int(rng.choice(used.get(ch, range(256))))
                  for ch in ("green", "red", "blue", "alpha")}
            ops.append(("lit", px["alpha"] << 24 | px["red"] << 16
                        | px["green"] << 8 | px["blue"]))
        data = wc.vp8l_file(wc.vp8l(w, h, ops, groups=[g]))
        _as_cv2(data, tmp_path, used, refused=False)
    # two distance symbols, one past the alphabet: a code of one symbol
    g = {"dist": wc._Code(40, simple=(3, 250))}
    g["dist"].codes = {3: (0, 0)}
    ops = _lits(rng, 10) + [("copy", w * h - 10, 4)]
    _as_cv2(wc.vp8l_file(wc.vp8l(w, h, ops, groups=[g])), tmp_path,
            "distance symbol past the alphabet", refused=False)


@pytest.mark.parametrize("bits", [2, 3, 5, 9])
def test_vp8l_meta_codes(bits, tmp_path):
    """An entropy image of prefix-code groups, each group its own codes
    (some simple), switching group at tile edges and after copies."""
    rng = np.random.default_rng(bits)
    w, h = 40, 13
    mx, my = -(-w // (1 << bits)), -(-h // (1 << bits))
    ngroups = min(mx * my, 5)
    tiles = [int(v) for v in rng.integers(0, ngroups, mx * my)]
    groups = [{} if k % 2 else {"alpha": wc._Code(256, simple=(k,))}
              for k in range(ngroups)]
    ops, pos, x, y = [], [], 0, 0
    while y < h:
        t = tiles[(y >> bits) * mx + (x >> bits)]
        g = groups[t]
        if x > 2 and rng.integers(0, 4) == 0:
            n = int(rng.integers(1, min(9, w * h - (y * w + x)) + 1))
            ops.append(("copy", n, 2 + 120))  # distance 2
        else:
            a = sorted(g["alpha"].codes)[0] if "alpha" in g else int(
                rng.integers(0, 256))
            ops.append(("lit", a << 24 | int(rng.integers(0, 2 ** 24))))
            n = 1
        pos.append((x, y))
        x += n
        while x >= w:
            x -= w
            y += 1
    data = wc.vp8l_file(wc.vp8l(w, h, ops, groups=groups,
                                meta=(bits, mx, tiles, pos)))
    _as_cv2(data, tmp_path, bits, refused=False)


@pytest.mark.parametrize("width", [1, 3, 8, 64])
def test_vp8l_distance_codes(width, tmp_path):
    """Copies through each of the 120 plane codes (their distance
    clamped to 1 where the image is too narrow for it) and plain
    distances, on images 1 to 64 pixels wide."""
    rng = np.random.default_rng(width)
    h = 1 + 600 // width + 2
    ops, done = _lits(rng, width * 9 + 9), width * 9 + 9
    for code in list(range(1, 121)) + [121, 125, 130]:
        n = int(rng.integers(1, 4))
        if done + n > width * h:
            break
        if code <= 120:
            dx, dy = _plane(code)
            dist = max(1, dy * width + dx)
        else:
            dist = code - 120
        if dist > done:
            continue
        ops.append(("copy", n, code))
        done += n
    while done < width * h:
        ops.append(("lit", int(rng.integers(0, 2 ** 32))))
        done += 1
    _as_cv2(wc.vp8l_file(wc.vp8l(width, h, ops)), tmp_path, width,
            refused=False)


def _plane(code):
    """(dx, dy) of a plane code, from the port's table."""
    v = wc._c_table("kCodeToPlane")[code - 1]
    return 8 - (v & 0xF), v >> 4


def test_vp8l_refusals(tmp_path):
    """What libwebp refuses: a copy before the first pixel or past the
    last, a transform sent twice, a version other than 0, a bad
    signature, an incomplete or over-full code, a stream cut short."""
    rng = np.random.default_rng(9)
    w, h = 9, 4
    lits = _lits(rng, w * h)
    cases = {
        "copy before the start": lits[:3] + [("copy", 5, 120 + 4)]
        + lits[8:],
        "copy past the end": lits[:w * h - 2] + [("copy", 5, 120 + 1)],
    }
    for name, ops in cases.items():
        _as_cv2(wc.vp8l_file(wc.vp8l(w, h, ops)), tmp_path, name,
                refused=True)
    good = wc.vp8l(w, h, lits)
    for name, payload in {
            "transform twice": wc.vp8l(w, h, lits, transforms=[
                ("green",), ("green",)]),
            "version 1": wc.vp8l(w, h, lits, version=1),
            "signature": b"\x2e" + good[1:],
            "cut short": good[:len(good) // 2]}.items():
        _as_cv2(wc.vp8l_file(payload), tmp_path, name, refused=True)
    for lens in ([1, 1, 1] + [0] * 253, [2, 2, 2] + [0] * 253):
        code = wc._Code(256)
        code.lens = lens
        code.codes = {0: (0, 1), 1: (1, 1)}
        data = wc.vp8l_file(wc.vp8l(w, h, [("lit", 0)] * (w * h),
                                    groups=[{"red": code}]))
        _as_cv2(data, tmp_path, lens[:3], refused=True)


# ------------------------------------------------------------ VP8X

def _rgba(rng, h=32, w=48):
    img = _scene(rng, h, w)
    a = rng.integers(0, 256, (h, w), np.uint8)
    a[: h // 2, : w // 3] = 0
    return np.dstack([img, a])


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("filtering", [0, 1, 2])
def test_alpha_chunk(compression, filtering, tmp_path):
    rng = np.random.default_rng(10 * compression + filtering)
    data = wc.encode(_rgba(rng), quality=70, alpha_compression=compression,
                     alpha_filtering=filtering)
    assert b"ALPH" in [t for t, _ in wc.chunks(data)]
    _as_cv2(data, tmp_path, refused=False)


def _with_alph(data, header=None, payload=None):
    """`data` (VP8X + ALPH + VP8) with its ALPH header byte or payload
    replaced."""
    out = b""
    for t, p in wc.chunks(data):
        if t == b"ALPH":
            p = (bytes([header]) + p[1:] if header is not None else p) \
                if payload is None else payload
        out += wc.chunk(t, p)
    return wc.riff(out)


def test_alpha_chunk_headers(tmp_path):
    """The ALPH header byte: every filter on raw alpha, the
    preprocessing bit, and the compression methods and reserved bits
    libwebp refuses; raw alpha too short, an empty chunk, two ALPH
    chunks (the last counts), ALPH without the VP8X alpha flag."""
    rng = np.random.default_rng(11)
    rgba = _rgba(rng)
    raw = wc.encode(rgba, quality=70, alpha_compression=0)
    for filt in range(4):
        for pre in (0, 1):
            _as_cv2(_with_alph(raw, header=filt << 2 | pre << 4), tmp_path,
                    (filt, pre), refused=False)
    for header in (2, 3, 0x20, 0x40, 0x80):
        _as_cv2(_with_alph(raw, header=header), tmp_path, header,
                refused=True)
    alph = dict(wc.chunks(raw))[b"ALPH"]
    _as_cv2(_with_alph(raw, payload=alph[:-1]), tmp_path, "short",
            refused=True)
    _as_cv2(_with_alph(raw, payload=b""), tmp_path, "empty", refused=True)
    vp8 = dict(wc.chunks(raw))[b"VP8 "]
    two = wc.riff(wc.vp8x(wc.ALPHA_FLAG, 48, 32) + wc.chunk(b"ALPH", b"\x03")
                  + wc.chunk(b"ALPH", alph) + wc.chunk(b"VP8 ", vp8))
    _as_cv2(two, tmp_path, "two ALPH", refused=False)
    bad_last = wc.riff(wc.vp8x(wc.ALPHA_FLAG, 48, 32)
                       + wc.chunk(b"ALPH", alph) + wc.chunk(b"ALPH", b"\x03")
                       + wc.chunk(b"VP8 ", vp8))
    _as_cv2(bad_last, tmp_path, "bad last ALPH", refused=True)
    _as_cv2(wc.extended(raw, flags=0), tmp_path, "no alpha flag",
            refused=False)


def test_extended_chunks(tmp_path):
    """ICCP, XMP and unknown chunks (odd sizes padded) before and after
    the image; an ALPH chunk before a VP8L one; what the decoder
    refuses: a VP8X chunk of another size, a canvas that is not the
    bitstream's size, a chunk running past the RIFF size."""
    rng = np.random.default_rng(12)
    img = _scene(rng, 30, 40)
    lossy, ll = wc.encode(img, quality=80), wc.encode(img, lossless=True)
    odd = [wc.chunk(b"ICCP", b"\x01" * 13), wc.chunk(b"ABCD", b"xyz")]
    for data in (lossy, ll):
        _as_cv2(wc.extended(data, before=odd), tmp_path, refused=False)
        _as_cv2(wc.extended(data, after=[wc.chunk(b"XMP ", b"<x/>" * 3),
                                         wc.chunk(b"zzzz", b"1")]),
                tmp_path, refused=False)
        _as_cv2(wc.extended(data, width=41), tmp_path, refused=True)
        ext = wc.extended(data)
        _as_cv2(ext[:12] + ext[12:16] + struct.pack("<I", 12) + ext[20:30]
                + b"\0\0" + ext[30:], tmp_path, "VP8X of 12", refused=True)
        _as_cv2(wc.extended(data, before=[wc.chunk(b"ICCP", b"\0" * 4,
                                                    size=1 << 20)]),
                tmp_path, "chunk past the RIFF", refused=True)
    alpha_then_ll = wc.riff(wc.vp8x(0, 40, 30) + wc.chunk(b"ALPH", b"\x00")
                            + wc.image_chunks(ll)
                            + wc.chunk(b"EXIF", wc.exif_payload(6)))
    _as_cv2(alpha_then_ll, tmp_path, "ALPH before VP8L", refused=False)


@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, big_endian, tmp_path):
    rng = np.random.default_rng(orientation)
    img = _scene(rng, 20, 30)
    for data in (wc.encode(img, lossless=True), wc.encode(img, quality=90)):
        exif = wc.chunk(b"EXIF", wc.exif_payload(orientation, big_endian))
        got = _as_cv2(wc.extended(data, after=[exif]), tmp_path,
                      orientation, refused=False)
        assert got.shape[:2] == ((30, 20) if orientation > 4 else (20, 30))


def test_exif_chunk_cv2_takes(tmp_path):
    """The first EXIF chunk, only with the VP8X EXIF flag, only in a file
    WebPDemux accepts, read from a TIFF header (no "Exif" prefix);
    orientations 0 and 9 and an empty chunk leave the image as it is;
    an animation is turned too."""
    rng = np.random.default_rng(13)
    img = _scene(rng, 20, 30)
    ll = wc.encode(img, lossless=True)
    E = lambda o, **kw: wc.chunk(b"EXIF", wc.exif_payload(o, **kw))  # noqa
    cases = {
        "after": (wc.extended(ll, after=[E(6)]), (30, 20)),
        "before": (wc.extended(ll, before=[E(7)]), (30, 20)),
        "two": (wc.extended(ll, after=[E(3), E(6)]), (20, 30)),
        "no flag": (wc.extended(ll, flags=0, after=[E(6)]), (20, 30)),
        "prefix": (wc.extended(ll, after=[wc.chunk(b"EXIF", wc.exif_payload(
            6, prefix=b"Exif\0\0"))]), (20, 30)),
        "simple file": (wc.riff(wc.image_chunks(ll) + E(6)), (20, 30)),
        "unknown flag": (wc.extended(ll, flags=wc.EXIF_FLAG | 1,
                                     after=[E(6)]), (20, 30)),
        "orientation 0": (wc.extended(ll, after=[E(0)]), (20, 30)),
        "orientation 9": (wc.extended(ll, after=[E(9)]), (20, 30)),
        "empty": (wc.extended(ll, after=[wc.chunk(b"EXIF", b"")]), (20, 30)),
        "past the RIFF": (wc.riff(wc.vp8x(wc.EXIF_FLAG, 30, 20)
                                  + wc.image_chunks(ll)) + E(6), (20, 30)),
        "animation": (wc.animation([wc.anmf(ll)], (30, 20),
                                   flags=wc.ANIMATION_FLAG | wc.EXIF_FLAG,
                                   after=[E(5)]), (30, 20)),
    }
    for name, (data, shape) in cases.items():
        got = _as_cv2(data, tmp_path, name, refused=False)
        assert got.shape[:2] == shape, name


# ------------------------------------------------------------ animation

def test_animation_first_frame(tmp_path):
    """The first frame alone on a canvas of zeros: smaller than the
    canvas and offset, lossy with alpha or lossless, whatever the
    background colour, blend and dispose bits, the ANMF's own size
    fields, or the frames after it."""
    rng = np.random.default_rng(14)
    small_rgba, full = _rgba(rng, 10, 14), _scene(rng, 20, 30)
    frames = {"lossy alpha": wc.encode(small_rgba, quality=80),
              "lossless alpha": wc.encode(small_rgba, lossless=True,
                                          exact=1),
              "lossy": wc.encode(small_rgba[..., :3], quality=50)}
    second = wc.anmf(wc.encode(full, lossless=True))
    for name, f in frames.items():
        for bg, blend, dispose in ((0, True, False),
                                   (0xFF00FF00, False, True)):
            data = wc.animation([wc.anmf(f, x=6, y=4, blend=blend,
                                         dispose=dispose), second], (30, 20),
                                background=bg)
            got = _as_cv2(data, tmp_path, (name, bg), refused=False)
            assert not got[:4].any() and not got[:, :6].any()
        data = wc.animation([wc.anmf(f, x=16, y=10, width=3, height=3)],
                            (30, 20), flags=wc.ANIMATION_FLAG)
        _as_cv2(data, tmp_path, (name, "ANMF size fields"), refused=False)


def test_animation_refused_as_cv2(tmp_path):
    """What WebPDemux refuses, and cv2 with it: no frame, a frame past
    the canvas, ANMF before ANIM, a broken later frame, an unknown VP8X
    flag, a still image among the frames, ANIM without the animation
    flag (the decoder finds no bitstream)."""
    rng = np.random.default_rng(15)
    f1 = wc.encode(_scene(rng, 10, 14), lossless=True)
    f2 = wc.encode(_scene(rng, 20, 30), quality=70)
    cases = {
        "no frame": wc.animation([], (30, 20)),
        "past the canvas": wc.animation([wc.anmf(f2, x=2, y=2)], (30, 20)),
        "ANMF before ANIM": wc.riff(wc.vp8x(wc.ANIMATION_FLAG, 30, 20)
                                    + wc.anmf(f1) + wc.anim()),
        "broken later frame": wc.animation([wc.anmf(f1), wc.anmf(f2)[:40]
                                            + b"\0" * 10], (30, 20)),
        "unknown flag": wc.animation([wc.anmf(f1)], (30, 20),
                                     flags=wc.ANIMATION_FLAG | 0x40),
        "still among frames": wc.animation([wc.anmf(f1)], (30, 20),
                                           after=[wc.image_chunks(f2)]),
        "no animation flag": wc.animation([wc.anmf(f2)], (30, 20), flags=0),
    }
    for name, data in cases.items():
        _as_cv2(data, tmp_path, name, refused=True)
    _as_cv2(wc.animation([wc.anmf(f1, x=2, y=2)], (1 << 21, 1)), tmp_path,
            "canvas past cv2's width", refused=True)


# ------------------------------------------------------------ refusals

def _corruptions(rng, data, n_trunc, n_flip, n_size):
    cases = [("truncated %d" % k, data[:k]) for k in sorted(set(
        int(v) for v in rng.integers(1, len(data), n_trunc)))]
    for _ in range(n_flip):
        b = bytearray(data)
        i = int(rng.integers(0, len(b)))
        b[i] = int(rng.integers(0, 256))
        cases.append(("byte %d" % i, bytes(b)))
    for _ in range(n_size):
        b = bytearray(data)
        i = int(rng.integers(4, len(b) - 4))
        b[i:i + 4] = struct.pack("<I", int(rng.integers(0, 2 * len(data))))
        cases.append(("size at %d" % i, bytes(b)))
    cases += [("RIFF +8", data[:4] + struct.pack("<I", len(data)) + data[8:]),
              ("RIFF -6", data[:4] + struct.pack("<I", len(data) - 14)
               + data[8:]),
              ("trailing bytes", data + b"\0" * 7)]
    return cases


def _base_files(rng):
    img = _scene(rng, 33, 47)
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2], np.uint8)])
    return {"lossy": wc.encode(img), "lossless": wc.encode(img, lossless=True),
            "alpha": wc.encode(rgba),
            "alpha raw": wc.encode(rgba, alpha_compression=0),
            "exif": wc.extended(wc.encode(img), after=[
                wc.chunk(b"EXIF", wc.exif_payload(6))]),
            "animation": wc.animation([wc.anmf(wc.encode(img[:20, :30]), 4, 2),
                                       wc.anmf(wc.encode(img, lossless=True))],
                                      (47, 33))}


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "alpha raw",
                                  "exif", "animation"])
def test_corrupt_files_as_cv2(kind, tmp_path):
    rng = np.random.default_rng(sum(map(ord, kind)))
    data = _base_files(np.random.default_rng(16))[kind]
    for name, bad in _corruptions(rng, data, 10, 12, 4):
        _as_cv2(bad, tmp_path, (kind, name))


@pytest.mark.slow
def test_corrupt_files_as_cv2_all(tmp_path):
    rng = np.random.default_rng(17)
    for seed in range(3):
        for kind, data in _base_files(np.random.default_rng(seed)).items():
            for name, bad in _corruptions(rng, data, 40, 80, 20):
                _as_cv2(bad, tmp_path, (seed, kind, name))


def test_dispatch_as_cv2(tmp_path):
    """cv2 takes a file as WebP by WebPGetFeatures on its first 32
    bytes: a raw VP8L bitstream is read, a RIFF WebP shorter than 32
    bytes or with an unknown first chunk is not."""
    rng = np.random.default_rng(18)
    ll = wc.encode(_scene(rng, 20, 30), lossless=True)
    _as_cv2(dict(wc.chunks(ll))[b"VP8L"], tmp_path, "raw VP8L",
            refused=False)
    _as_cv2(ll[:31], tmp_path, "31 bytes", refused=True)
    _as_cv2(wc.riff(wc.chunk(b"EXIF", b"\0" * 20) + wc.image_chunks(ll)),
            tmp_path, "EXIF first", refused=True)
    assert webp.is_webp(ll) and not webp.is_webp(ll[:31])


# ------------------------------------------------------------ datasets

def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(_io.StringIO()):
        return fn(*a, **kw)


def test_coco_dataset_on_webp_split_equals_reference(tmp_path):
    """The JAX package's COCODataset (AllDataset, reading with
    cv2.imread) against the port's on a tiny COCO split stored as WebP
    (lossy and lossless, one file EXIF-turned on a square image)."""
    from mergenet_tpu.data import dataset as jdataset
    from mergenet_tpu_torch.data import COCODataset, synthetic
    src, dst = tmp_path / "png", tmp_path / "webp"
    _quiet(synthetic.generate, str(src), 3, 0, 40, 40, 9, seed=4)
    os.makedirs(dst / "train")
    os.makedirs(dst / "annotations")
    ann = os.path.join("annotations", "instancesonly_train.json")
    with open(src / ann) as f:
        d = json.load(f)
    for k, im in enumerate(d["images"]):
        rgb = cv2.imread(str(src / "train" / im["file_name"]))[..., ::-1]
        im["file_name"] = os.path.splitext(im["file_name"])[0] + ".webp"
        data = wc.encode(rgb, lossless=k == 1, quality=85)
        if k == 2:
            data = wc.extended(data, after=[wc.chunk(b"EXIF",
                                                     wc.exif_payload(3))])
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

def test_webp_decoder_links_no_library():
    """`native/webp.cc` includes only the C++ standard library and links
    nothing: no libwebp."""
    src = pathlib.Path(webp.SRC).read_text()
    includes = re.findall(r"^\s*#\s*include\s*[<\"]([^>\"]+)", src, re.M)
    assert includes and all("/" not in h and "." not in h
                            for h in includes), includes
    assert not any(f.startswith("-l") for f in webp.CXX_FLAGS)
    needed = subprocess.run(["ldd", webp.build()], capture_output=True,
                            text=True)
    assert needed.returncode == 0 and "libstdc++" in needed.stdout
    assert "webp" not in needed.stdout, needed.stdout
