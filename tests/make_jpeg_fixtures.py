"""Writes `tests/fixtures/jpeg/`, the JPEG files the port's decoder is
held to, with cv2 (it needs cv2; it is not a test):

    python tests/make_jpeg_fixtures.py     # ~20 s

- `val/`: the 50 val images of the certification workload (the
  reference generator's 512x1024 scenes, seed 100, C=9: what
  `mergenet_tpu_torch.certify.regenerate` writes), each encoded by
  `cv2.imencode` at quality 90, 4:2:0, baseline, under its PNG name with
  `.jpg`;
- `matrix/`: `certification512/bench_img.png` encoded at 4:4:4, 4:2:2,
  4:2:0, 4:4:0 and 4:1:1 (quality 90), grey, progressive, optimised
  Huffman tables, a restart interval of 1 MCU, quality 100, a
  1023x511 crop, and with an EXIF orientation 6 APP1 segment; and,
  written by `jpeg_craft` (cv2 writes none of them): the coefficients
  of `val/val_00000.jpg` and `val/val_00001.jpg` arithmetic-coded,
  sequential (the second with a restart interval of 8 MCUs and DAC
  conditioning tables) and progressive (`arith_*.jpg`), a 128x256
  lossless RGB crop of bench_img (predictor 6, restarts every 4 rows),
  and bench_img as Adobe CMYK (4:4:4, 512x1024, K falling from 255 to
  192 down the image) and YCCK (a 256x512 crop, Y and K at 2x2) at
  quality 90 with Annex K's Huffman tables;
- `png/adam7.png`: a 128x256 crop of bench_img as an Adam7-interlaced
  RGB PNG, each scanline's filter drawn from a seeded generator;
- `cv2_digests.json`: per file (path under `fixtures/jpeg/`), the shape
  and the SHA-256 of `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`,
  and for the arithmetic transcodings the Huffman file they came from
  (`transcoded_from`).

`tests/test_torch_port_jpeg.py` checks the digests against cv2 and the
port's decoder against the digests; `chip_smoke.py`'s "jpeg" phase
checks the port's decoder against the digests on the GPU machine."""

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import cv2

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT = os.path.join(HERE, "fixtures", "jpeg")
BENCH = os.path.join(HERE, "fixtures", "certification512", "bench_img.png")
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
from jpeg_craft import (dct_blocks, exif_app1, insert_after_soi,  # noqa: E402
                        read_coefficients, write_jpeg, write_jpeg_arith,
                        write_lossless)
from png_craft import write_png  # noqa: E402

Q = cv2.IMWRITE_JPEG_QUALITY
S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
VAL_PARAMS = [Q, 90, S, SAMPLING["420"]]


def rgb_digest(path):
    """(shape, SHA-256) of the RGB array cv2 reads from `path`."""
    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()


def encode(img, params):
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return bytes(buf)


def matrix():
    """{name: JPEG bytes} of the format matrix."""
    img = cv2.imread(BENCH)
    out = {"s%s.jpg" % k: encode(img, [Q, 90, S, v])
           for k, v in SAMPLING.items()}
    out["grey.jpg"] = encode(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), [Q, 90])
    out["progressive.jpg"] = encode(img, [Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE,
                                          1])
    out["optimized.jpg"] = encode(img, [Q, 90, cv2.IMWRITE_JPEG_OPTIMIZE, 1])
    out["rst1.jpg"] = encode(img, [Q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    out["q100.jpg"] = encode(img, [Q, 100])
    out["crop1023x511.jpg"] = encode(img[:511, :1023], [Q, 90])
    out["exif6.jpg"] = insert_after_soi(encode(img, [Q, 90]),
                                        exif_app1(6, big_endian=True))
    return out


#: the arithmetic transcodings: name -> (source, write_jpeg_arith options)
ARITH = {
    "arith_seq_val_00000.jpg": ("val/val_00000.jpg", {}),
    "arith_prog_val_00000.jpg": ("val/val_00000.jpg", dict(progressive=True)),
    "arith_seq_rst8_dac_val_00001.jpg": ("val/val_00001.jpg", dict(
        restart=8, dac={(0, 0): (1, 4), (0, 1): (0, 2), (1, 0): 3,
                        (1, 1): 12})),
    "arith_prog_val_00001.jpg": ("val/val_00001.jpg", dict(progressive=True)),
}


def quality_table(q, chroma=False):
    """libjpeg's Annex K table scaled to quality q (jpeg_quality_scaling),
    natural order."""
    base = np.array([
        16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103,
        99] if not chroma else [
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
        + [99] * 32)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def crafted():
    """{name: bytes} of the files jpeg_craft writes: the arithmetic
    transcodings, the lossless crop, CMYK and YCCK."""
    out = {}
    for name, (src, opts) in ARITH.items():
        with open(os.path.join(OUT, src), "rb") as f:
            comps, w, h, coefs, qt, ids = read_coefficients(f.read())
        out[name] = write_jpeg_arith(comps, w, h, coefs, qt, ids=ids, **opts)
    rgb = cv2.cvtColor(cv2.imread(BENCH), cv2.COLOR_BGR2RGB).astype(np.int64)
    crop = rgb[128:256, 256:512]
    out["lossless_rgb_crop.jpg"] = write_lossless(
        [(1, 1, 0)] * 3, 256, 128, [crop[..., k] for k in range(3)],
        predictor=6, restart=4 * 256, jfif=False, adobe=0)
    # CMYK as Adobe writes it (inverted: cv2 shows R = about C * K / 255),
    # K falling from 255 to 192 down the image
    k = np.broadcast_to(255 - np.arange(512)[:, None] // 8, (512, 1024))
    cmyk = np.concatenate([np.minimum(255, (rgb * 255 + k[..., None] // 2)
                                      // k[..., None]), k[..., None]], -1)
    q = {0: quality_table(90), 1: quality_table(90, chroma=True)}
    comps = [(1, 1, 0)] * 4
    out["cmyk_444.jpg"] = write_jpeg(comps, 1024, 512, [
        dct_blocks(cmyk[..., c], (64, 128), q[0]) for c in range(4)], q,
        jfif=False, adobe=0, annex_k=True)
    part = cmyk[:256, :512].astype(np.float64)
    r, g, b = (255 - part[..., c] for c in range(3))  # YCCK's "RGB"
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128,
              part[..., 3]]
    planes[1:3] = [p.reshape(128, 2, 256, 2).mean((1, 3)) for p in planes[1:3]]
    comps = [(2, 2, 0), (1, 1, 1), (1, 1, 1), (2, 2, 0)]
    out["ycck_crop.jpg"] = write_jpeg(comps, 512, 256, [
        dct_blocks(np.clip(np.round(p), 0, 255),
                   (p.shape[0] // 8, p.shape[1] // 8), q[comps[c][2]])
        for c, p in enumerate(planes)], q, jfif=False, adobe=2, annex_k=True)
    return out


def main():
    digests = {}
    os.makedirs(os.path.join(OUT, "matrix"), exist_ok=True)
    os.makedirs(os.path.join(OUT, "val"), exist_ok=True)
    os.makedirs(os.path.join(OUT, "png"), exist_ok=True)
    for name, data in matrix().items():
        with open(os.path.join(OUT, "matrix", name), "wb") as f:
            f.write(data)
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
            with open(os.path.join(OUT, "val", stem + ".jpg"), "wb") as f:
                f.write(encode(img, VAL_PARAMS))
    for name, data in crafted().items():
        with open(os.path.join(OUT, "matrix", name), "wb") as f:
            f.write(data)
    bench = cv2.cvtColor(cv2.imread(BENCH), cv2.COLOR_BGR2RGB)
    write_png(os.path.join(OUT, "png", "adam7.png"), bench[128:256, 256:512],
              2, 8, interlace=True, rng=np.random.default_rng(16))
    for sub in ("matrix", "val", "png"):
        for name in sorted(os.listdir(os.path.join(OUT, sub))):
            shape, sha = rgb_digest(os.path.join(OUT, sub, name))
            digests["%s/%s" % (sub, name)] = {"shape": shape, "sha256": sha}
    for name, (src, _) in ARITH.items():
        digests["matrix/" + name]["transcoded_from"] = src
    with open(os.path.join(OUT, "cv2_digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print("%d files, %.1f MB" % (len(digests), sum(
        os.path.getsize(os.path.join(OUT, k)) for k in digests) / 1e6))


if __name__ == "__main__":
    main()
