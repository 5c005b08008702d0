"""Writes `tests/fixtures/avif/`, the AVIF files the port's reader is
held to, with cv2 and Pillow (their libavif, libaom and libyuv; it needs
both; it is not a test):

    python tests/make_avif_fixtures.py     # ~1 min

- `lossless/`: val images 0 and 1 of the certification workload (the
  reference generator's 512x1024 scenes, seed 100, C=9, as
  `make_webp_fixtures.py` regenerates them) encoded by `cv2.imencode`
  at quality 100 (AV1 lossless, identity matrix, 4:4:4), equal to the
  PNGs they came from;
- `val/`: val image 0 written by Pillow lossless (BT.601 4:2:0), by
  Pillow with the in-loop filters off at qualities 70 and 30 (4:2:0),
  and by cv2 at 10 bits, quality 60, its header rewritten by
  `avif_craft.strip_filters` (loop filter, CDEF and quantizer matrices
  off; the tile data as libaom wrote it) - the 512x1024 files whose
  read time `chip_smoke.py`'s avif phase reports;
- `matrix/`: crops of `certification512/bench_img.png` (rows 192-255,
  columns 384-511, as `tests/fixtures/images/`; larger crops where a
  tool needs room) written by cv2 and by Pillow with libaom options
  (speeds 0-10, screen content, IntraBC, 128 superblocks, tiles, delta
  q, the reduced transform set), 8, 10 and 12 bits, every subsampling,
  the four q contexts, and `avif_craft`'s rewraps of them: a frame
  header OBU and one tile group per tile, alpha, Exif
  orientations, irot/imir/clap, ICC colr, a grid, an avis sequence,
  idat and split extents, the colour matrices cv2 converts by different
  routes, odd and tiny sizes; the files cv2 refuses, and the files with
  a tool read after reconstruction (cv2's own quality-90 file among
  them), which the port refuses as not yet read;
- `cv2_digests.json`: per file (path under `fixtures/avif/`), the shape
  and the SHA-256 of `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`
  (`sha256` null where cv2 returns None), `not_yet` (the tools the port
  names) where the port does not read the file yet, and for the lossless
  val files the PNG they came from (`png`) and its pixel SHA-256.

`tests/test_torch_port_avif.py` checks the digests against cv2 and the
port's reader against the digests; `chip_smoke.py`'s "avif" phase checks
the port's reader against the digests on the GPU machine."""

import hashlib
import io as _io
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
OUT = os.path.join(HERE, "fixtures", "avif")
BENCH = os.path.join(HERE, "fixtures", "certification512", "bench_img.png")
sys.path.insert(0, HERE)

import avif_craft as ac  # noqa: E402
import webp_craft as wc  # noqa: E402

LOSSLESS = ("val_00000", "val_00001")
#: libaom options that switch the in-loop filters off
NF = {"enable-cdef": "0", "enable-restoration": "0", "loopfilter-control": "0"}
#: what the port names for the files it does not read yet
NOT_YET = {
    "cv2_q90.avif": "quantizer matrices, the deblocking filter",
    "cv2_q50_cdef.avif": "CDEF",
    "pil_q60_filters.avif": "the deblocking filter, CDEF",
    "ispe_rescaled.avif": "ispe 130x64 other than the AV1 frame's 128x64",
}


def rgb_digest(path):
    """(shape, SHA-256) of the RGB array cv2 reads from `path`, or
    (None, None) where cv2 returns None."""
    img = cv2.imread(path)
    if img is None:
        return None, None
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()


def cv2_avif(bgr, quality, depth=8):
    prm = [cv2.IMWRITE_AVIF_QUALITY, quality]
    if depth > 8:
        prm += [cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", bgr, prm)
    assert ok
    return bytes(buf)


def pil_avif(rgb, **kw):
    f = _io.BytesIO()
    mode = "RGBA" if rgb.ndim == 3 and rgb.shape[2] == 4 else "RGB"
    Image.fromarray(np.ascontiguousarray(rgb), mode).save(f, "AVIF", **kw)
    return f.getvalue()


def deep(bgr, depth):
    return bgr.astype(np.uint16) * (1 << (depth - 8)) + (1 << (depth - 9))


def rewrap(data, drop=(), add=(), **kw):
    """`data` with the primary item's properties of the types in `drop`
    removed and (essential, box) `add` appended."""
    m = ac.parse(data)
    it = m["items"][m["primary"]]
    it["props"] = [(e, p) for e, p in it["props"] if p[4:8] not in drop]
    it["props"] += list(add)
    return ac.write(m, **kw)


def with_exif(data, payload):
    """`data` with an Exif item (placed first) describing its image."""
    m = ac.parse(data)
    av = m["items"][m["primary"]]
    m["items"] = {1: {"type": b"Exif", "name": b"", "props": [],
                      "data": payload}, 2: av}
    m["primary"] = 2
    m["refs"] = [(b"cdsc", 1, [2])]
    return ac.write(m)


def grid(bgr, n):
    """A 2x2 grid (descriptor and tiles in idat) of n x n Pillow tiles."""
    tiles = [ac.parse(pil_avif(np.ascontiguousarray(bgr[r:r + n, c:c + n,
                                                         ::-1]),
                               quality=90, advanced=NF))["items"][1]
             for r in (0, n) for c in (0, n)]
    items = {1: {"type": b"grid", "name": b"", "data": ac.grid(2, 2, 2 * n,
                                                               2 * n),
                 "props": [(0, ac.ispe(2 * n, 2 * n)),
                           (0, ac.pixi(8, 8, 8))]}}
    for i, t in enumerate(tiles):
        items[2 + i] = dict(t)
    return ac.write({"brands": [b"avif", b"\0" * 4, b"avif", b"mif1",
                                b"miaf"], "primary": 1, "items": items,
                     "refs": [(b"dimg", 1, [2, 3, 4, 5])]}, idat=True)


def matrix():
    """{name: AVIF bytes} of the format matrix."""
    big = cv2.imread(BENCH)
    bgr = big[192:256, 384:512]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    wide = big[128:256, 256:512]
    wide_rgb = np.ascontiguousarray(wide[..., ::-1])
    out = {}
    # cv2's own files: lossless at 8/10/12 bits and grey; lossy (not yet
    # read) and the same with the later tools switched off in the header
    out["cv2_q100.avif"] = cv2_avif(bgr, 100)
    out["cv2_q100_10bit.avif"] = cv2_avif(deep(bgr, 10), 100, 10)
    out["cv2_q100_12bit.avif"] = cv2_avif(deep(bgr, 12), 100, 12)
    out["cv2_grey_q100.avif"] = cv2_avif(bgr[..., 1], 100)
    out["cv2_q100_63x127.avif"] = cv2_avif(bgr[:63, :127], 100)
    out["cv2_q100_1x1.avif"] = cv2_avif(bgr[:1, :1], 100)
    out["cv2_q90.avif"] = cv2_avif(bgr, 90)
    out["cv2_q90_stripped.avif"] = ac.strip_filters(out["cv2_q90.avif"],
                                                    qm=True)
    q50 = cv2_avif(wide, 50)
    out["cv2_q50_cdef.avif"] = ac.strip_filters(q50, cdef=False, qm=True)
    out["cv2_q50_stripped.avif"] = ac.strip_filters(q50, qm=True)
    out["cv2_10bit_q60_stripped.avif"] = ac.strip_filters(
        cv2_avif(deep(wide, 10), 60, 10), qm=True)
    out["cv2_12bit_q40_stripped.avif"] = ac.strip_filters(
        cv2_avif(deep(wide, 12), 40, 12), qm=True)
    out["cv2_grey_q70_stripped.avif"] = ac.strip_filters(
        cv2_avif(wide[..., 1], 70), qm=True)
    # Pillow: lossless (BT.601 4:2:0 and 4:4:4) and lossy with the
    # filters off in each q context, subsampling and range
    out["pil_q100.avif"] = pil_avif(rgb, quality=100)
    out["pil_q100_444.avif"] = pil_avif(rgb, quality=100,
                                        subsampling="4:4:4")
    for q, sp in ((97, 0), (88, 6), (62, 10), (25, 3)):
        out["pil_q%d_s%d.avif" % (q, sp)] = pil_avif(
            wide_rgb, quality=q, speed=sp, advanced=NF)
    for ss in ("4:2:2", "4:4:4", "4:0:0"):
        out["pil_%s_q80.avif" % ss.replace(":", "")] = pil_avif(
            rgb, quality=80, subsampling=ss, advanced=NF)
    out["pil_limited_q80.avif"] = pil_avif(rgb, quality=80, range="limited",
                                           advanced=NF)
    out["pil_q60_filters.avif"] = pil_avif(wide_rgb, quality=60, advanced={
        "enable-cdef": "1", "loopfilter-control": "1"})
    out["pil_q90_63x127.avif"] = pil_avif(rgb[:63, :127], quality=90,
                                          advanced=NF)
    # the tools: screen content (palette, IntraBC), 128 superblocks,
    # tiles, delta q, the reduced transform set
    pal = np.random.default_rng(5).integers(0, 256, (6, 3), np.uint8)
    screen = pal[(wide_rgb.astype(np.int64).sum(-1) * 6) // 766]
    out["pil_screen_palette.avif"] = pil_avif(
        screen, quality=85, speed=2, advanced=dict(NF, **{
            "tune-content": "screen"}))
    tiled = np.tile(rgb[8:40, 24:56], (4, 8, 1))
    for ss in ("4:2:0", "4:4:4"):
        out["pil_intrabc_%s.avif" % ss.replace(":", "")] = pil_avif(
            tiled, quality=90, subsampling=ss, advanced=dict(NF, **{
                "tune-content": "screen", "enable-intrabc": "1",
                "deltaq-mode": "2"}))
    out["pil_sb128.avif"] = pil_avif(
        np.ascontiguousarray(big[:256, :512, ::-1]), quality=50, speed=1,
        advanced=dict(NF, **{"sb-size": "128"}))
    out["pil_tiles_2x2.avif"] = pil_avif(
        np.ascontiguousarray(big[:, :, ::-1]), quality=40, speed=8,
        tile_rows=1, tile_cols=1, advanced=NF)
    out["tile_groups_split.avif"] = ac.split_tile_groups(
        out["pil_tiles_2x2.avif"])
    out["pil_deltaq.avif"] = pil_avif(wide_rgb, quality=60, advanced=dict(
        NF, **{"deltaq-mode": "2"}))
    out["pil_reduced_tx.avif"] = pil_avif(wide_rgb, quality=75, advanced=dict(
        NF, **{"reduced-tx-type-set": "1"}))
    out["pil_cdf_update_off.avif"] = pil_avif(wide_rgb, quality=50, advanced=dict(
        NF, **{"cdf-update-mode": "0"}))
    out["pil_delta_lf.avif"] = pil_avif(wide_rgb, quality=50, advanced=dict(
        NF, **{"deltaq-mode": "2", "delta-lf-mode": "1"}))
    out["pil_intrabc_wide.avif"] = pil_avif(
        np.tile(rgb[8:40, 24:56], (2, 32, 1)), quality=90, advanced=dict(
            NF, **{"tune-content": "screen", "enable-intrabc": "1"}))
    out["pil_s0_q70.avif"] = pil_avif(
        np.ascontiguousarray(big[:256, :512, ::-1]), quality=70, speed=0,
        advanced=NF)
    odd = np.tile(rgb[10:43, 20:53], (4, 8, 1))
    out["pil_intrabc_odd_period.avif"] = pil_avif(odd, quality=90, advanced=dict(
        NF, **{"tune-content": "screen", "enable-intrabc": "1"}))
    # stripes that make libaom pick 64x32, 32x64 and 32x8 blocks
    yy, xx = np.mgrid[0:256, 0:512]
    for name, per_y, per_x, q, sb in (("h32", 32, 1000, 30, "128"),
                                      ("v32", 1000, 32, 30, "128"),
                                      ("h8", 8, 1000, 40, "64")):
        img = np.zeros((256, 512, 3), np.uint8)
        img[(yy // per_y) % 2 == 1] = (200, 60, 20)
        img[(xx // per_x) % 2 == 1] = (20, 160, 220)
        img = (img.astype(int) + ((xx + yy) % 7)[..., None]).astype(np.uint8)
        out["pil_stripes_%s.avif" % name] = pil_avif(
            img, quality=q, speed=0, advanced=dict(NF, **{"sb-size": sb}))
    # the container
    base = pil_avif(rgb, quality=90, advanced=NF)
    rgba = np.dstack([rgb, np.broadcast_to(np.arange(128, dtype=np.uint8)
                                           * 2, rgb.shape[:2])])
    out["alpha.avif"] = pil_avif(rgba, quality=90, advanced=NF)
    for o, mm in ((6, False), (3, False), (8, True)):
        out["exif%d%s.avif" % (o, "_mm" if mm else "")] = with_exif(
            base, struct.pack(">I", 0) + wc.exif_payload(o, big_endian=mm))
    exif = Image.Exif()
    exif[0x0112] = 5
    out["pil_exif5_irot_imir.avif"] = pil_avif(rgb, quality=90, exif=exif,
                                               advanced=NF)
    out["clap.avif"] = rewrap(base, add=[(1, ac.clap(64, 32))])
    out["icc.avif"] = rewrap(base, drop=(b"colr",),
                             add=[(0, ac.colr_icc(b"\0" * 64))])
    out["no_pixi_no_colr.avif"] = rewrap(base, drop=(b"pixi", b"colr"))
    out["idat_extents.avif"] = ac.write(ac.parse(base), idat=True,
                                        split={1: [100, 7]})
    out["grid_2x2.avif"] = grid(big, 64)
    out["avis.avif"] = pil_avif(rgb, quality=90, advanced=NF, save_all=True,
                                append_images=[Image.fromarray(
                                    np.ascontiguousarray(rgb[::-1]))])
    # the colour matrices cv2 converts by different routes
    for cp, mc, full in ((1, 1, 1), (1, 1, 0), (1, 5, 1), (9, 9, 1),
                         (9, 9, 0), (1, 8, 1), (1, 4, 0), (9, 12, 1)):
        out["nclx_%d_%d_%s.avif" % (cp, mc, "full" if full else "lim")] = \
            rewrap(base, drop=(b"colr",),
                   add=[(0, ac.colr_nclx(cp, 13, mc, full))])
    out["nclx_1_0_lim_444.avif"] = rewrap(
        pil_avif(rgb, quality=90, subsampling="4:4:4", advanced=NF),
        drop=(b"colr",), add=[(0, ac.colr_nclx(1, 13, 0, 0))])
    # files cv2 refuses
    out["refused_no_ispe.avif"] = rewrap(base, drop=(b"ispe",))
    out["refused_pixi10.avif"] = rewrap(base, drop=(b"pixi",),
                                        add=[(0, ac.pixi(10, 10, 10))])
    out["refused_irot_nonessential.avif"] = rewrap(base,
                                                   add=[(0, ac.irot(1))])
    out["refused_unknown_essential.avif"] = rewrap(
        base, add=[(1, ac.box(b"xxxx", b"abcd"))])
    out["refused_meta_past_500.avif"] = ac.write(
        ac.parse(base), before_meta=ac.box(b"free", b"\0" * 600))
    out["refused_exif_offset.avif"] = with_exif(
        base, struct.pack(">I", 9) + wc.exif_payload(6))
    out["refused_nclx_3.avif"] = rewrap(base, drop=(b"colr",),
                                        add=[(0, ac.colr_nclx(1, 13, 3, 1))])
    out["refused_truncated.avif"] = base[:len(base) - 40]
    out["ispe_rescaled.avif"] = rewrap(base, drop=(b"ispe",),
                                       add=[(0, ac.ispe(130, 64))])
    return out


def val_images(tmp):
    subprocess.run([sys.executable, os.path.join(
        REPO, "egs", "cityscape", "local", "make_synthetic_data.py"),
        "--out-dir", tmp, "--train-images", "0", "--val-images", "2",
        "--height", "512", "--width", "1024", "--num-classes", "9",
        "--seed", "100"], env=dict(os.environ, PYTHONPATH=REPO),
        check=True, stdout=subprocess.DEVNULL)
    return {os.path.splitext(f)[0]: cv2.imread(os.path.join(tmp, "val", f))
            for f in sorted(os.listdir(os.path.join(tmp, "val")))}


def main():
    for sub in ("matrix", "val", "lossless"):
        os.makedirs(os.path.join(OUT, sub), exist_ok=True)
    files = {"matrix/" + k: v for k, v in matrix().items()}
    pngs = {}
    with tempfile.TemporaryDirectory() as tmp:
        val = val_images(tmp)
    for stem in LOSSLESS:
        files["lossless/%s.avif" % stem] = cv2_avif(val[stem], 100)
        pngs["lossless/%s.avif" % stem] = (stem + ".png", hashlib.sha256(
            np.ascontiguousarray(val[stem][..., ::-1]).tobytes()).hexdigest())
    v0 = np.ascontiguousarray(val["val_00000"][..., ::-1])
    files["val/pil_lossless_420.avif"] = pil_avif(v0, quality=100)
    for q in (70, 30):
        files["val/pil_q%d_nofilter.avif" % q] = pil_avif(v0, quality=q,
                                                          advanced=NF)
    files["val/cv2_10bit_q60_stripped.avif"] = ac.strip_filters(
        cv2_avif(deep(val["val_00000"], 10), 60, 10), qm=True)
    digests = {}
    for key, data in sorted(files.items()):
        path = os.path.join(OUT, key)
        with open(path, "wb") as f:
            f.write(data)
        shape, sha = rgb_digest(path)
        digests[key] = {"shape": shape, "sha256": sha}
        name = os.path.basename(key)
        if name in NOT_YET:
            digests[key]["not_yet"] = NOT_YET[name]
    for key, (png, sha) in pngs.items():
        assert digests[key]["sha256"] == sha, key
        digests[key]["png"] = png
    with open(os.path.join(OUT, "cv2_digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print("%d files, %.2f MB" % (len(digests), sum(
        os.path.getsize(os.path.join(OUT, k)) for k in digests) / 1e6))


if __name__ == "__main__":
    main()
