"""Writes `tests/fixtures/jp2/`, the JPEG 2000 files the port's reader is
held to, with cv2, Pillow's OpenJPEG and `j2k_craft` (it needs cv2 and
Pillow; it is not a test):

    python tests/make_jp2_fixtures.py     # ~75 s (with make_htj2k_fixtures)

- `val/`: the 50 val images of the certification workload (the
  reference generator's 512x1024 scenes, seed 100, C=9: what
  `mergenet_tpu_torch.certify.regenerate` writes), each written by
  `cv2.imencode('.jp2', ..., [IMWRITE_JPEG2000_COMPRESSION_X1000, 100])`
  (5/3, no component transform, the layers cut at 1/10 of the raw
  size), under its PNG name with `.jp2`;
- `lossless/`: val images 0 and 1 at X1000=1000, equal to the PNGs they
  came from (cv2's writer uses the 5/3 wavelet without a component
  transform at every rate, the val files too);
- `pillow/`: val image 0 from Pillow's OpenJPEG with the component
  transforms: 9/7 + ICT at about the val files' size, and 5/3 + RCT
  lossless (equal to its PNG);
- `matrix/`: crops of `certification512/bench_img.png` (rows 192-255,
  columns 384-511 of its 512x1024, as `tests/fixtures/webp/`) written by
  cv2 and by Pillow (the five progressions, tiles, precincts, layers,
  resolutions, code-block sizes, a raw J2K, RGBA, LA, L, 16-bit grey,
  PLT, a comment, a signed file and an image origin cv2 refuses) and
  by `j2k_craft` on 24x37 crops (the six code-block styles and all of
  them, RGN, POC in the main and the tile headers, PPM, PPT, SOP/EPH,
  tile-parts shuffled, TNsot 0, precisions 4/9/12 and mixed, sYCC 4:4:4
  and 4:2:0, a palette and one of 16-bit entries, cdef orders and
  alpha, CMYK, an unknown colour space, an ICC profile, 9/7 impulses,
  20 decomposition levels, an HT code-block style on a flat image, an
  MCT marker and Rsiz bit 15);
- then `make_htj2k_fixtures.py`'s HT and Part 2 files (`ht/` and more of
  `matrix/`);
- `cv2_digests.json`: per file (path under `fixtures/jp2/`), the shape
  and the SHA-256 of `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`
  or `"cv2": null` where cv2 returns None, and for the lossless files
  the PNG they came from (`png`).

`tests/test_torch_port_jp2.py` checks the digests against cv2 and the
port's reader against the digests; `chip_smoke.py`'s "jp2" phase checks
the port's reader against the digests on the GPU machine and scores
procedure (c) from `val/`."""

import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT = os.path.join(HERE, "fixtures", "jp2")
BENCH = os.path.join(HERE, "fixtures", "certification512", "bench_img.png")
sys.path.insert(0, HERE)

import j2k_craft as jc  # noqa: E402
import make_htj2k_fixtures  # noqa: E402

VAL_X1000 = 100
LOSSLESS_X1000 = 1000
LOSSLESS = ("val_00000", "val_00001")


def rgb_digest(path):
    """(shape, SHA-256) of the RGB array cv2 reads from `path`, or None."""
    img = cv2.imread(path)
    if img is None:
        return None
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()


def cv2_jp2(bgr, x1000):
    ok, buf = cv2.imencode(".jp2", bgr, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                         x1000])
    assert ok
    return bytes(buf)


def pillow(arr, mode=None, **kw):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "p.j2k" if kw.get("no_jp2") else "p.jp2")
        (Image.fromarray(arr) if mode is None else
         Image.fromarray(arr).convert(mode)).save(path, "JPEG2000", **kw)
        with open(path, "rb") as f:
            return f.read()


def impulse(res, bandno, value):
    def bands(k, r, b, shape):
        a = np.zeros(shape, np.int64)
        if r == res and b == bandno and k == 0:
            a[shape[0] // 2, shape[1] // 2] = value
        return a
    return bands


def matrix():
    """{name: file bytes} of the format matrix."""
    bgr = cv2.imread(BENCH)[192:256, 384:512]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    out = {"cv2_x1000_10.jp2": cv2_jp2(bgr, 10),
           "cv2_x1000_300.jp2": cv2_jp2(bgr, 300),
           "cv2_lossless.jp2": cv2_jp2(bgr, 1000),
           "cv2_grey.jp2": cv2_jp2(np.ascontiguousarray(bgr[..., 1]), 100),
           "cv2_63x127.jp2": cv2_jp2(np.ascontiguousarray(bgr[:63, :127]),
                                     100)}
    for prg in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out["pil_%s.jp2" % prg.lower()] = pillow(
            rgb, progression=prg, precinct_size=(32, 32),
            quality_layers=[40, 10, 2], num_resolutions=4)
    out["pil_97_layers.jp2"] = pillow(rgb, irreversible=True,
                                      quality_layers=[60, 20, 5])
    out["pil_tiles.jp2"] = pillow(rgb, tile_size=(48, 40))
    out["pil_precincts_cblk8.jp2"] = pillow(
        rgb, precinct_size=(16, 16), codeblock_size=(8, 8), irreversible=True)
    out["pil_res1.jp2"] = pillow(rgb, num_resolutions=1)
    out["pil_res6_cblk4.jp2"] = pillow(rgb, num_resolutions=6,
                                       codeblock_size=(4, 4))
    out["pil_cblk_1024x4.jp2"] = pillow(rgb, codeblock_size=(1024, 4))
    out["pil_mct0.jp2"] = pillow(rgb, mct=0, irreversible=True)
    out["pil_raw.j2k"] = pillow(rgb, no_jp2=True)
    out["pil_raw_grey.j2k"] = pillow(rgb[..., 0].copy(), no_jp2=True)
    rgba = np.dstack([rgb, np.broadcast_to(
        np.arange(128, dtype=np.uint8) * 2, rgb.shape[:2])])
    out["pil_rgba.jp2"] = pillow(rgba)
    out["pil_la.jp2"] = pillow(rgba, mode="LA")
    out["pil_l.jp2"] = pillow(rgb, mode="L")
    out["pil_i16.jp2"] = pillow(rgb[..., 0].astype(np.uint16) * 257 + 3,
                                mode="I;16")
    out["pil_plt_comment.jp2"] = pillow(rgb, plt=True, comment="port")
    out["pil_signed.jp2"] = pillow(rgb, signed=True)
    out["pil_origin.jp2"] = pillow(rgb, offset=(5, 7), tile_size=(64, 64),
                                   tile_offset=(3, 2))
    # the craft encoder on a 24x37 crop
    small = rgb[8:32, 40:77].astype(np.int64)
    comps = [small[..., k] for k in range(3)]
    for name, sty in (("bypass", jc.LAZY), ("reset", jc.RESET),
                      ("termall", jc.TERMALL), ("vsc", jc.VSC),
                      ("pterm", jc.PTERM), ("segsym", jc.SEGSYM),
                      ("all", 63)):
        out["craft_sty_%s.jp2" % name] = jc.jp2(jc.encode(
            comps, levels=2, cblk=(3, 3), cblksty=sty, layers=2, mct=True))
    out["craft_rgn.jp2"] = jc.jp2(jc.encode(comps, levels=2,
                                            roi=(0, 10, (8, 4, 24, 16))))
    pocs = [(0, 0, 1, 3, 3, 2), (0, 0, 2, 2, 3, 4), (0, 0, 2, 3, 3, 3)]
    out["craft_poc_main.jp2"] = jc.jp2(jc.encode(
        comps, levels=2, layers=2, pocs=pocs, precincts=[(2, 2)] * 3,
        cblk=(2, 2)))
    out["craft_poc_tile.jp2"] = jc.jp2(jc.encode(
        comps, levels=2, layers=2, pocs=pocs, poc_in_tile=True,
        tile=(16, 16), precincts=[(3, 3)] * 3, cblk=(2, 2)))
    out["craft_ppm.jp2"] = jc.jp2(jc.encode(
        comps, levels=2, layers=2, packed="ppm", tile=(16, 16), tileparts=2))
    out["craft_ppt.jp2"] = jc.jp2(jc.encode(
        comps, levels=2, layers=2, packed="ppt", tile=(16, 16), tileparts=2))
    out["craft_sop_eph.jp2"] = jc.jp2(jc.encode(
        comps, levels=2, layers=3, sop=True, eph=True, progression="RPCL",
        precincts=[(2, 2), (3, 3), (3, 3)], cblk=(2, 2)))
    out["craft_tileparts_shuffled.jp2"] = jc.jp2(jc.encode(
        comps, levels=1, tile=(16, 16), tileparts=2, tile_order=[
            (4, 0), (1, 0), (4, 1), (0, 0), (5, 0), (2, 0), (0, 1), (3, 0),
            (5, 1), (1, 1), (3, 1), (2, 1)]))
    out["craft_tnsot0.jp2"] = jc.jp2(jc.encode(comps, levels=1, tile=(16, 16),
                                               tileparts=2, tnsot=False))
    out["craft_levels20_rpcl.j2k"] = jc.encode(comps, levels=20,
                                               progression="RPCL")
    rng = np.random.default_rng(19)
    h, w = small.shape[:2]
    for prec in (4, 9, 12):
        out["craft_prec%d.jp2" % prec] = jc.jp2(jc.encode(
            [rng.integers(0, 1 << prec, (h, w)) for _ in range(3)], prec=prec,
            levels=2))
    out["craft_prec_8_12_8.jp2"] = jc.jp2(jc.encode(
        [comps[0], rng.integers(0, 4096, (h, w)), comps[2]], prec=[8, 12, 8],
        levels=2))
    out["craft_signed12.jp2"] = jc.jp2(jc.encode(
        [rng.integers(-2048, 2048, (h, w)) for _ in range(3)], prec=12,
        signed=True, levels=2))
    out["craft_sycc.jp2"] = jc.jp2(jc.encode(comps, levels=2), enumcs=18)
    out["craft_sycc420.jp2"] = jc.jp2(jc.encode(
        [comps[0], comps[1][::2, ::2], comps[2][::2, ::2]],
        sub=[(1, 1), (2, 2), (2, 2)], levels=2), enumcs=18)
    out["craft_cmyk.jp2"] = jc.jp2(jc.encode(comps + [comps[0]], levels=1),
                                   enumcs=12)
    out["craft_enumcs0.jp2"] = jc.jp2(jc.encode(comps, levels=1), enumcs=0)
    out["craft_icc.jp2"] = jc.rebox(jc.jp2(jc.encode(comps, levels=1)),
                                    replace={b"colr": jc.colr(
                                        meth=2, icc=bytes(range(128)))})
    idx = (small.sum(-1) * 24) // (3 * 256)
    pal = rng.integers(0, 256, (24, 3))
    out["craft_palette.jp2"] = jc.jp2(jc.encode([idx], levels=2), header=[
        jc.ihdr(h, w, 1, 7), jc.colr(16), jc.pclr(pal, [8, 8, 8]),
        jc.cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])])
    out["craft_palette16.jp2"] = jc.jp2(jc.encode([idx], levels=2), header=[
        jc.ihdr(h, w, 1, 7), jc.colr(16),
        jc.pclr(rng.integers(0, 1 << 16, (24, 3)), [16, 16, 16]),
        jc.cmap([(0, 1, 0), (0, 1, 1), (0, 1, 2)])])
    base = jc.jp2(jc.encode(comps, levels=2))
    out["craft_cdef_bgr.jp2"] = jc.rebox(base, add=[jc.cdef(
        [(0, 0, 3), (1, 0, 2), (2, 0, 1)])])
    four = jc.jp2(jc.encode(comps + [comps[1]], levels=2))
    out["craft_cdef_alpha_first.jp2"] = jc.rebox(four, add=[jc.cdef(
        [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])])
    out["craft_cdef_incomplete.jp2"] = jc.rebox(base, add=[jc.cdef(
        [(0, 0, 1), (1, 0, 2)])])
    zeros = [np.zeros((37, 45), np.int64)] * 3
    for name, (res, bandno, val) in (("ll", (0, 0, 300)),
                                     ("hl1", (3, 1, -77)),
                                     ("lh2", (2, 2, 55)),
                                     ("hh3", (1, 3, 21))):
        out["craft_97_impulse_%s.jp2" % name] = jc.jp2(jc.encode(
            zeros, levels=3, reversible=False, mct=True, quant=(8, 1000),
            bands=impulse(res, bandno, val)))
    empty = jc.encode([np.full((h, w), 128)] * 3, levels=1)
    cap = (0xff50, struct.pack(">IH", 0x00020000, 0))
    out["craft_htj2k.jp2"] = jc.jp2(jc.with_main_markers(
        jc.set_rsiz(jc.set_cblksty(empty, 0x40), 0x4000), add=[cap]))
    out["craft_part2_mct.jp2"] = jc.jp2(jc.with_main_markers(
        jc.encode(comps, levels=1), add=[(0xff74, b"\0\1\0\0\0\0")]))
    out["craft_rsiz_part2.jp2"] = jc.jp2(jc.set_rsiz(
        jc.encode(comps, levels=1), 0x8000))
    return out


def main():
    digests = {}
    for sub in ("matrix", "val", "lossless", "pillow"):
        os.makedirs(os.path.join(OUT, sub), exist_ok=True)
    for name, data in matrix().items():
        with open(os.path.join(OUT, "matrix", name), "wb") as f:
            f.write(data)
    pngs = {}
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([sys.executable, os.path.join(
            REPO, "egs", "cityscape", "local", "make_synthetic_data.py"),
            "--out-dir", tmp, "--train-images", "0", "--val-images", "50",
            "--height", "512", "--width", "1024", "--num-classes", "9",
            "--seed", "100"], env=dict(os.environ, PYTHONPATH=REPO),
            check=True, stdout=subprocess.DEVNULL)
        for fname in sorted(os.listdir(os.path.join(tmp, "val"))):
            img = cv2.imread(os.path.join(tmp, "val", fname))
            stem = os.path.splitext(fname)[0]
            with open(os.path.join(OUT, "val", stem + ".jp2"), "wb") as f:
                f.write(cv2_jp2(img, VAL_X1000))
            if stem in LOSSLESS:
                with open(os.path.join(OUT, "lossless", stem + ".jp2"),
                          "wb") as f:
                    f.write(cv2_jp2(img, LOSSLESS_X1000))
                sha = hashlib.sha256(np.ascontiguousarray(
                    img[..., ::-1]).tobytes()).hexdigest()
                pngs["lossless/%s.jp2" % stem] = (fname, sha)
            if stem == LOSSLESS[0]:
                rgb = np.ascontiguousarray(img[..., ::-1])
                for name, kw in (("val_00000_97_ict.jp2", dict(
                        irreversible=True, mct=1, quality_layers=[10])),
                        ("val_00000_53_rct.jp2", dict(mct=1))):
                    with open(os.path.join(OUT, "pillow", name), "wb") as f:
                        f.write(pillow(rgb, **kw))
                pngs["pillow/val_00000_53_rct.jp2"] = (fname, sha)
    for sub in ("matrix", "val", "lossless", "pillow"):
        for name in sorted(os.listdir(os.path.join(OUT, sub))):
            d = rgb_digest(os.path.join(OUT, sub, name))
            key = "%s/%s" % (sub, name)
            digests[key] = ({"cv2": None} if d is None else
                            {"shape": d[0], "sha256": d[1]})
    for key, (png, sha) in pngs.items():
        assert digests[key]["sha256"] == sha, key
        digests[key]["png"] = png
    with open(os.path.join(OUT, "cv2_digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print("%d files, %.1f MB" % (len(digests), sum(
        os.path.getsize(os.path.join(OUT, k)) for k in digests) / 1e6))
    make_htj2k_fixtures.main()


if __name__ == "__main__":
    main()
