"""Writes `tests/fixtures/images/`, the TIFF, BMP, PxM, PAM, PFM, Sun
raster, Radiance HDR and GIF files the port's readers are held to, with
cv2 (it needs cv2; it is not a test):

    python tests/make_container_fixtures.py     # ~2 s

Every file is a crop of `certification512/bench_img.png` (rows 192-255,
columns 384-511 of its 512x1024), each written once:

- by cv2 (`cv2_*`): TIFF with each compression cv2 writes and reads
  back (none, LZW, LZW with predictor 2, Deflate, Adobe Deflate,
  PackBits), 16-bit grey and RGB TIFF; 24-bit and 8-bit grey BMP; binary
  and ASCII PPM, PGM, PBM; PAM; PFM; Sun raster; run-length and flat HDR;
  GIF;
- by `container_craft` (cv2 writes none of them): TIFF tiled, planar,
  palette, 1-bit min-is-white, CMYK, unassociated alpha, big-endian
  BigTIFF, orientation 3 over several strips, 16-bit grey tiles with a
  clipped edge, old-style LZW; BMP RLE8 and RLE4 with deltas, 5-6-5
  bitfields, V5 channel masks, a core header, an OS/2 2.x header,
  top-down 32-bit; P1, P2 with comments and maxval 1000, P3 with maxval
  100, P4; Sun raster with an 8-bit colour map and 1-bit; HDR with
  old-style runs; GIF interlaced, transparent, smaller than its screen,
  with a local table;
- `cv2_digests.json`: per file (path under `fixtures/images/`), the
  shape and the SHA-256 of `cv2.cvtColor(cv2.imread(path),
  cv2.COLOR_BGR2RGB)`.

`tests/test_torch_port_containers.py` checks the digests against cv2
and the port's reader against the digests; `chip_smoke.py`'s
"containers" phase checks the port's reader against the digests on the
GPU machine."""

import hashlib
import json
import os
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "fixtures", "images")
BENCH = os.path.join(HERE, "fixtures", "certification512", "bench_img.png")
sys.path.insert(0, HERE)

import container_craft as cc  # noqa: E402


def rgb_digest(path):
    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()


def crop():
    return cv2.cvtColor(cv2.imread(BENCH), cv2.COLOR_BGR2RGB)[192:256,
                                                              384:512]


def cv2_files(rgb):
    """{name: (array to write, imwrite params)} for cv2's writers."""
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    grey = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    C = cv2.IMWRITE_TIFF_COMPRESSION
    wide = bgr.astype(np.uint16) * 257 + np.arange(128, dtype=np.uint16)[
        None, :, None]
    return {
        "tiff/cv2_none.tif": (bgr, [C, 1]),
        "tiff/cv2_lzw.tif": (bgr, [C, 5]),
        "tiff/cv2_lzw_pred2.tif": (bgr, [C, 5, cv2.IMWRITE_TIFF_PREDICTOR,
                                         2]),
        "tiff/cv2_deflate.tif": (bgr, [C, 8]),
        "tiff/cv2_adobe_deflate.tif": (bgr, [C, 32946]),
        "tiff/cv2_packbits.tif": (bgr, [C, 32773]),
        "tiff/cv2_grey16.tif": (wide[..., 1], [C, 5]),
        "tiff/cv2_rgb16.tif": (wide, [C, 8]),
        "bmp/cv2_24.bmp": (bgr, []),
        "bmp/cv2_grey8.bmp": (grey, []),
        "pxm/cv2.ppm": (bgr, []),
        "pxm/cv2_ascii.ppm": (bgr, [cv2.IMWRITE_PXM_BINARY, 0]),
        "pxm/cv2.pgm": (grey, []),
        "pxm/cv2_ascii.pgm": (grey, [cv2.IMWRITE_PXM_BINARY, 0]),
        "pxm/cv2.pbm": ((grey > 127).astype(np.uint8) * 255, []),
        "pxm/cv2.pam": (bgr, []),
        "pxm/cv2.pfm": (bgr.astype(np.float32) * np.float32(0.75), []),
        "sunras/cv2_24.ras": (bgr, []),
        "sunras/cv2_grey8.ras": (grey, []),
        "hdr/cv2_rle.hdr": (bgr.astype(np.float32) / 255,
                            [cv2.IMWRITE_HDR_COMPRESSION,
                             cv2.IMWRITE_HDR_COMPRESSION_RLE]),
        "hdr/cv2_flat.hdr": (bgr.astype(np.float32) / 255,
                             [cv2.IMWRITE_HDR_COMPRESSION,
                              cv2.IMWRITE_HDR_COMPRESSION_NONE]),
        "gif/cv2.gif": (bgr, []),
    }


def crafted(rgb):
    """{name: file bytes} written by container_craft."""
    rng = np.random.default_rng(17)
    h, w = rgb.shape[:2]
    grey = (rgb.astype(np.int64) @ [77, 150, 29] >> 8).astype(np.uint8)
    idx8 = (grey // 16).astype(np.uint8)  # 16 levels
    pal16 = rng.integers(0, 256, (16, 3))
    alpha = np.concatenate([rgb, (np.arange(w)[None, :, None] * 2).repeat(
        h, 0)], -1)
    cmyk = np.concatenate([255 - rgb, rng.integers(0, 64, (h, w, 1))], -1)
    rle_ops = []
    for r in range(h):
        rle_ops += [("run", 20, int(idx8[r, 0])), ("abs", idx8[r, 20:40]),
                    ("delta", 8, 0), ("run", 60, 3), ("eol",)]
        if r == 10:
            rle_ops += [("delta", 4, 2)]
    rle_ops.append(("eob",))
    big = rgb.astype(np.int64) * 257
    out = {
        "tiff/tiled_lzw_pred2.tif": cc.tiff_bytes(
            rgb, compression=5, predictor=2, tile=(32, 48)),
        "tiff/planar_deflate.tif": cc.tiff_bytes(
            rgb, planar=2, compression=8, rows_per_strip=20),
        "tiff/palette4_packbits.tif": cc.tiff_bytes(
            idx8, bits=4, photometric=3, compression=32773,
            colormap=pal16 * 257),
        "tiff/bilevel_miniswhite.tif": cc.tiff_bytes(
            (grey > 127).astype(np.uint8), bits=1, photometric=0),
        "tiff/cmyk.tif": cc.tiff_bytes(cmyk, photometric=5,
                                       compression=5),
        "tiff/rgba_unassociated.tif": cc.tiff_bytes(
            alpha, extra_samples=[2], rows_per_strip=16),
        "tiff/bigtiff_mm_rgb16.tif": cc.tiff_bytes(
            big, bits=16, big_endian=True, bigtiff=True, compression=32946,
            predictor=2),
        "tiff/orientation3_strips.tif": cc.tiff_bytes(
            rgb, orientation=3, rows_per_strip=24, pages=2),
        "tiff/grey16_tiles_clipped.tif": cc.tiff_bytes(
            big[..., :1], bits=16, tile=(48, 80)),
        "tiff/lzw_old_style.tif": cc.tiff_bytes(rgb, compression=6005,
                                                rows_per_strip=32),
        "bmp/rle8_deltas.bmp": cc.bmp_bytes(
            idx8, 8, compression=1, palette=pal16, rle_ops=rle_ops),
        "bmp/rle4.bmp": cc.bmp_bytes(idx8, 4, compression=2, palette=pal16),
        "bmp/bitfields565.bmp": cc.bmp_bytes(
            ((rgb[..., 0].astype(np.uint16) >> 3) << 11)
            | ((rgb[..., 1].astype(np.uint16) >> 2) << 5)
            | (rgb[..., 2] >> 3), 16, compression=3,
            masks=(0xF800, 0x7E0, 0x1F)),
        "bmp/v5_masks32.bmp": cc.bmp_bytes(
            np.concatenate([rgb, np.zeros((h, w, 1), np.uint8)],
                           -1).view("<u4")[..., 0], 32, header=124,
            compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0)),
        "bmp/core_palette8.bmp": cc.bmp_bytes(idx8, 8, header=12,
                                              palette=pal16.repeat(16, 0)),
        "bmp/os2_24.bmp": cc.bmp_bytes(rgb[..., ::-1], 24, header=64),
        "bmp/topdown32.bmp": cc.layout_bytes(rgb, "bmp32_topdown"),
        "pxm/p1.pbm": cc.pnm_bytes((grey < 128).astype(np.uint8), 1),
        "pxm/p2_comments_maxval1000.pgm": cc.pnm_bytes(
            grey.astype(np.int64) * 1000 // 255, 2, 1000,
            comments=(("magic", "a comment"), ("maxval", "another"))),
        "pxm/p3_maxval100.ppm": cc.pnm_bytes(
            rgb.astype(np.int64) * 100 // 255, 3, 100),
        "pxm/p4.pbm": cc.pnm_bytes((grey < 128).astype(np.uint8), 4),
        "sunras/colormap8.ras": cc.sunras_bytes(idx8, 8, colormap=pal16),
        "sunras/bilevel1.ras": cc.sunras_bytes(
            (grey > 127).astype(np.uint8), 1),
        "hdr/old_rle.hdr": cc.hdr_bytes(
            cc.float_to_rgbe(rgb.astype(np.float32) / 64), encoding="old"),
        "gif/interlaced_transparent.gif": cc.gif_bytes(
            [dict(indices=idx8[:60, :120], left=4, top=2, interlace=True,
                  transparent=5, table=pal16)], screen=(w, h),
            global_table=pal16[::-1], background=3),
    }
    return out


def main():
    rgb = crop()
    digests = {}
    for rel, (img, params) in cv2_files(rgb).items():
        path = os.path.join(OUT, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not cv2.imwrite(path, img, params):
            raise RuntimeError("cv2 could not write %s" % rel)
    for rel, data in crafted(rgb).items():
        path = os.path.join(OUT, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    for rel in sorted(list(cv2_files(rgb)) + list(crafted(rgb))):
        path = os.path.join(OUT, rel)
        if cv2.imread(path) is None:
            raise RuntimeError("cv2 does not read %s" % rel)
        shape, sha = rgb_digest(path)
        digests[rel] = {"shape": shape, "sha256": sha}
    with open(os.path.join(OUT, "cv2_digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
    print("%d files, %.2f MB" % (len(digests), sum(
        os.path.getsize(os.path.join(OUT, k)) for k in digests) / 1e6))


if __name__ == "__main__":
    main()
