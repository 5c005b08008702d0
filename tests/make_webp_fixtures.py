"""Writes `tests/fixtures/webp/`, the WebP files the port's reader is
held to, with cv2 and Pillow's libwebp (it needs both; it is not a
test):

    python tests/make_webp_fixtures.py     # ~40 s

- `val/`: the 50 val images of the certification workload (the
  reference generator's 512x1024 scenes, seed 100, C=9: what
  `mergenet_tpu_torch.certify.regenerate` writes), each encoded by
  `cv2.imencode` at quality 90 (lossy VP8), under its PNG name with
  `.webp`;
- `lossless/`: val images 0 and 1 encoded lossless by cv2 (quality 101,
  VP8L), equal to the PNGs they came from;
- `matrix/`: crops of `certification512/bench_img.png` (rows 192-255,
  columns 384-511 of its 512x1024, as `tests/fixtures/images/`) written
  by cv2 (quality 1, 50, 100, lossless, an odd 63x127 crop, 1x1) and by
  `webp_craft` (cv2 writes none of them): eight token partitions, the
  simple loop filter at sharpness 7, loop-filter deltas, one segment at
  method 0, segment ids dropped, the scale and colour-space bits set,
  VP8L at methods 0 and 6, near-lossless, 16- and 2-colour palettes,
  alpha kept exactly, lossy alpha compressed and raw, EXIF orientations
  6 (II) and 8 (MM), and an animation whose first frame is smaller than
  its canvas and offset on it;
- `cv2_digests.json`: per file (path under `fixtures/webp/`), the shape
  and the SHA-256 of `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`,
  and for the lossless files the PNG they came from (`png`, its name in
  the regenerated val split) and that PNG's pixel SHA-256.

`tests/test_torch_port_webp.py` checks the digests against cv2 and the
port's reader against the digests; `chip_smoke.py`'s "webp" phase checks
the port's reader against the digests on the GPU machine and scores
procedure (c) from `val/`."""

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
OUT = os.path.join(HERE, "fixtures", "webp")
BENCH = os.path.join(HERE, "fixtures", "certification512", "bench_img.png")
sys.path.insert(0, HERE)

import webp_craft as wc  # noqa: E402

VAL_QUALITY = 90
LOSSLESS = ("val_00000", "val_00001")


def rgb_digest(path):
    """(shape, SHA-256) of the RGB array cv2 reads from `path`."""
    img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    return list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()


def cv2_webp(bgr, quality):
    ok, buf = cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return bytes(buf)


def matrix():
    """{name: WebP bytes} of the format matrix."""
    bgr = cv2.imread(BENCH)[192:256, 384:512]
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    out = {"cv2_q%d.webp" % q: cv2_webp(bgr, q) for q in (1, 50, 100)}
    out["cv2_lossless.webp"] = cv2_webp(bgr, 101)
    out["cv2_q75_63x127.webp"] = cv2_webp(bgr[:63, :127], 75)
    out["cv2_q75_1x1.webp"] = cv2_webp(bgr[:1, :1], 75)
    lossy = wc.encode(rgb, quality=75)
    vp8 = dict(wc.chunks(lossy))[b"VP8 "]
    for name, kw in (("partitions8", dict(partitions=3)),
                     ("lf_deltas", dict(level=40, deltas=([3, None, -2, 5],
                                                          [6, -4, None, 2]))),
                     ("segment_ids_dropped", dict(drop_map=True)),
                     ("scale_colorspace", dict(scale=(2, 1), colorspace=1,
                                               clamp=1))):
        out[name + ".webp"] = wc.with_vp8(lossy, wc.vp8_rewrite(vp8, **kw))
    out["simple_sharp7.webp"] = wc.encode(rgb, quality=60, filter_type=0,
                                          filter_strength=80,
                                          filter_sharpness=7)
    out["segments1_method0.webp"] = wc.encode(rgb, quality=40, segments=1,
                                              method=0)
    out["ll_method0.webp"] = wc.encode(rgb, lossless=True, quality=0,
                                       method=0)
    out["ll_method6.webp"] = wc.encode(rgb, lossless=True, quality=100,
                                       method=6)
    out["near_lossless60.webp"] = wc.encode(rgb, lossless=True,
                                            near_lossless=60)
    for n in (16, 2):
        pal = np.random.default_rng(n).integers(0, 256, (n, 3), np.uint8)
        idx = (rgb.astype(np.int64).sum(-1) * n) // (3 * 256)
        out["palette%d.webp" % n] = wc.encode(pal[idx], lossless=True)
    alpha = np.broadcast_to(np.arange(128, dtype=np.uint8) * 2,
                            rgb.shape[:2]).copy()
    alpha[:16, :16] = 0
    rgba = np.dstack([rgb, alpha])
    out["ll_alpha_exact.webp"] = wc.encode(rgba, lossless=True, exact=1)
    out["alpha_lossy.webp"] = wc.encode(rgba, quality=75, alpha_filtering=2)
    out["alpha_raw.webp"] = wc.encode(rgba, quality=75, alpha_compression=0)
    ll = wc.encode(rgb, lossless=True)
    out["exif6_ii.webp"] = wc.extended(ll, after=[
        wc.chunk(b"EXIF", wc.exif_payload(6))])
    out["exif8_mm.webp"] = wc.extended(lossy, before=[
        wc.chunk(b"EXIF", wc.exif_payload(8, big_endian=True))])
    small = wc.encode(rgba[8:40, 16:80], quality=80)
    out["anim_offset.webp"] = wc.animation(
        [wc.anmf(small, x=20, y=10), wc.anmf(ll)], (128, 64))
    return out


def main():
    digests = {}
    for sub in ("matrix", "val", "lossless"):
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
            with open(os.path.join(OUT, "val", stem + ".webp"), "wb") as f:
                f.write(cv2_webp(img, VAL_QUALITY))
            if stem in LOSSLESS:
                with open(os.path.join(OUT, "lossless", stem + ".webp"),
                          "wb") as f:
                    f.write(cv2_webp(img, 101))
                pngs["lossless/%s.webp" % stem] = (fname, hashlib.sha256(
                    np.ascontiguousarray(img[..., ::-1]).tobytes())
                    .hexdigest())
    for sub in ("matrix", "val", "lossless"):
        for name in sorted(os.listdir(os.path.join(OUT, sub))):
            shape, sha = rgb_digest(os.path.join(OUT, sub, name))
            digests["%s/%s" % (sub, name)] = {"shape": shape, "sha256": sha}
    for key, (png, sha) in pngs.items():
        assert digests[key]["sha256"] == sha, key
        digests[key]["png"] = png
    with open(os.path.join(OUT, "cv2_digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print("%d files, %.1f MB" % (len(digests), sum(
        os.path.getsize(os.path.join(OUT, k)) for k in digests) / 1e6))


if __name__ == "__main__":
    main()
