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
  1023x511 crop, and with an EXIF orientation 6 APP1 segment;
- `cv2_digests.json`: per file (path under `fixtures/jpeg/`), the shape
  and the SHA-256 of `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`.

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

from jpeg_craft import exif_app1, insert_after_soi  # noqa: E402

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


def main():
    digests = {}
    os.makedirs(os.path.join(OUT, "matrix"), exist_ok=True)
    os.makedirs(os.path.join(OUT, "val"), exist_ok=True)
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
    for sub in ("matrix", "val"):
        for name in sorted(os.listdir(os.path.join(OUT, sub))):
            shape, sha = rgb_digest(os.path.join(OUT, sub, name))
            digests["%s/%s" % (sub, name)] = {"shape": shape, "sha256": sha}
    with open(os.path.join(OUT, "cv2_digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print("%d files, %.1f MB" % (len(digests), sum(
        os.path.getsize(os.path.join(OUT, k)) for k in digests) / 1e6))


if __name__ == "__main__":
    main()
