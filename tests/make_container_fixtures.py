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
- by `tiff_craft` and `container_craft` with cv2's JPEG encoder and
  `jpeg_craft` for the JPEG strips: TIFF with FillOrder 2 (LZW with
  predictor 2, bilevel PackBits), CCITT (Modified Huffman, its
  word-aligned variant, T.4 1-D with fill bits and 2-D, T.6 in tiles and
  in FillOrder 2), JPEG (YCbCr 4:2:0 in one strip, 4:2:2 strips with
  JPEGTables, RGB 4:4:4 tiles, grey, CMYK, planar YCbCr), YCbCr without
  JPEG (2x2 LZW, 4x4 tiles, 4x1 PackBits, planar Deflate, 1x2 with
  Rec. 709 coefficients and a studio-range ReferenceBlackWhite),
  CIELab (8-bit strips, 16-bit LZW tiles with a WhitePoint), SGILog
  (LogL, LogLuv and LogLuv24), a ThunderScan palette image;
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
import jpeg_craft as jc  # noqa: E402
import tiff_craft as tc  # noqa: E402


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
    out.update(tiff_codecs(rgb))
    return out


def _jpeg(img, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420):
    a = img[..., ::-1] if img.ndim == 3 else img
    ok, enc = cv2.imencode(".jpg", np.ascontiguousarray(a), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        sampling])
    assert ok
    return enc.tobytes()


def _sgilog(data, compression=34676):
    """`data` (little-endian, compression 1) marked SGILog (34676) or
    SGILog24 (34677)."""
    return data.replace(b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                        b"\x03\x01\x03\x00\x01\x00\x00\x00"
                        + compression.to_bytes(2, "little"))


def tiff_codecs(rgb):
    """{name: file bytes} of the TIFF codecs and interpretations read
    since the containers slice: FillOrder 2, CCITT, JPEG, YCbCr without
    JPEG, CIELab, SGILog, ThunderScan."""
    h, w = rgb.shape[:2]
    grey = (rgb.astype(np.int64) @ [77, 150, 29] >> 8).astype(np.uint8)
    bilevel = (grey < 128).astype(np.uint8)
    ycc = cv2.cvtColor(np.ascontiguousarray(rgb), cv2.COLOR_RGB2YCrCb)[
        ..., [0, 2, 1]]
    s444 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444
    s422 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422
    strips16 = [_jpeg(rgb[y:y + 16], s422) for y in range(0, h, 16)]
    tiles = [_jpeg(rgb[y:y + 32, x:x + 64], s444)
             for y in range(0, h, 32) for x in range(0, w, 64)]
    cmyk = np.concatenate([255 - rgb, grey[..., None] // 4], -1)
    comps = [(1, 1, 0)] * 4
    cmyk_jpeg = jc.write_jpeg(comps, w, h, [jc.dct_blocks(
        cmyk[..., c], jc.blocks_shape(comps, c, w, h), np.full(64, 6))
        for c in range(4)], {0: np.full(64, 6)}, jfif=False, adobe=0)
    rng = np.random.default_rng(20)
    cmap = rng.integers(0, 65536, (16, 3))
    thunder = [b"".join(tc.thunder_row(rng, w) for _ in range(16))
               for _ in range(h // 16)]
    idx4 = np.zeros((h, w, 1), np.uint8)
    lab = cv2.cvtColor(np.ascontiguousarray(rgb), cv2.COLOR_RGB2Lab)
    lab = np.concatenate([lab[..., :1], (lab[..., 1:].astype(np.int64)
                                         - 128) % 256], -1)
    lum = np.maximum(grey.astype(np.float64) / 255, 1e-3) ** 2
    le = np.round(256 * (np.log2(lum) + 64)).astype(np.int64)
    uv = ((rgb[..., 0].astype(np.int64) // 4 + 60) << 8) | (
        rgb[..., 2].astype(np.int64) // 4 + 110)
    return {
        "tiff/fill_order2_lzw_pred2.tif": cc.tiff_bytes(
            rgb, compression=5, predictor=2, rows_per_strip=16,
            fill_order=2),
        "tiff/fill_order2_bilevel_packbits.tif": cc.tiff_bytes(
            bilevel, bits=1, photometric=0, compression=32773,
            fill_order=2),
        "tiff/ccitt_mh.tif": tc.fax_tiff(bilevel, 2),
        "tiff/ccitt_mh_word.tif": tc.fax_tiff(bilevel, 32771,
                                              rows_per_strip=24),
        "tiff/ccitt_t4_1d_fill.tif": tc.fax_tiff(bilevel, 3, fill=True,
                                                 photometric=1),
        "tiff/ccitt_t4_2d.tif": tc.fax_tiff(bilevel, 3, options=1, k=4,
                                            rows_per_strip=32),
        "tiff/ccitt_t6_tiles.tif": tc.fax_tiff(bilevel, 4, tile=(32, 48)),
        "tiff/ccitt_t6_fill_order2.tif": tc.fax_tiff(bilevel, 4,
                                                     fill_order=2),
        "tiff/jpeg_ycbcr420.tif": tc.jpeg_tiff([_jpeg(rgb)], (h, w)),
        "tiff/jpeg_ycbcr422_tables_strips.tif": tc.jpeg_tiff(
            strips16, (h, w), subsampling=(2, 1), tables=True,
            rows_per_strip=16),
        "tiff/jpeg_rgb444_tiles.tif": tc.jpeg_tiff(
            tiles, (h, w), photometric=2, tile=(32, 64)),
        "tiff/jpeg_grey.tif": tc.jpeg_tiff([_jpeg(grey)], (h, w), spp=1,
                                           photometric=1),
        "tiff/jpeg_cmyk.tif": tc.jpeg_tiff([cmyk_jpeg], (h, w), spp=4,
                                           photometric=5),
        "tiff/jpeg_planar_ycbcr.tif": tc.jpeg_tiff(
            [_jpeg(np.ascontiguousarray(ycc[..., c])) for c in range(3)],
            (h, w), planar=2, subsampling=(1, 1)),
        "tiff/ycbcr22_lzw.tif": cc.tiff_bytes(
            ycc, photometric=6, subsampling=(2, 2), compression=5,
            rows_per_strip=15),
        "tiff/ycbcr44_tiles.tif": cc.tiff_bytes(
            ycc, photometric=6, subsampling=(4, 4), tile=(48, 80)),
        "tiff/ycbcr41_packbits.tif": cc.tiff_bytes(
            ycc, photometric=6, subsampling=(4, 1), compression=32773),
        "tiff/ycbcr_planar_deflate.tif": cc.tiff_bytes(
            ycc, photometric=6, planar=2, compression=8,
            extra_tags=[(530, 3, [1, 1])]),
        "tiff/ycbcr12_rec709.tif": cc.tiff_bytes(
            ycc, photometric=6, subsampling=(1, 2), extra_tags=[
                (529, 5, [(2126, 10000), (7152, 10000), (722, 10000)]),
                (532, 5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                          (240, 1)])]),
        "tiff/cielab8.tif": cc.tiff_bytes(lab, photometric=8,
                                          rows_per_strip=16),
        "tiff/cielab16_lzw_tiles.tif": cc.tiff_bytes(
            lab * 257, bits=16, photometric=8, compression=5,
            tile=(32, 64), extra_tags=[(318, 5, [(3127, 10000),
                                                 (3290, 10000)])]),
        "tiff/sgilog_logl.tif": _sgilog(cc.tiff_bytes(
            np.zeros((h, w, 1), np.uint8), bits=16, photometric=32844,
            blocks=[tc.sgilog_strip(le, 2)])),
        "tiff/sgilog_logluv.tif": _sgilog(cc.tiff_bytes(
            np.zeros((h, w, 3), np.uint8), bits=16, photometric=32845,
            blocks=[tc.sgilog_strip(le << 16 | uv, 4)])),
        "tiff/sgilog24_logluv.tif": _sgilog(cc.tiff_bytes(
            np.zeros((h, w, 3), np.uint8), bits=16, photometric=32845,
            blocks=[(((le >> 6).clip(1, 1023) << 14) | (uv & 0x3fff)).astype(
                ">u4").view(np.uint8).reshape(h, w, 4)[..., 1:].tobytes()]),
            34677),
        "tiff/thunderscan_palette.tif": cc.tiff_bytes(
            idx4, bits=4, photometric=3, colormap=cmap, rows_per_strip=16,
            blocks=thunder).replace(
                b"\x03\x01\x03\x00\x01\x00\x00\x00\x01\x00",
                b"\x03\x01\x03\x00\x01\x00\x00\x00\x29\x80"),
    }


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
