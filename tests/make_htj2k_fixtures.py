"""Writes the HTJ2K (JPEG 2000 Part 15) and Part 2 files of
`tests/fixtures/jp2/` and their cv2 digests, with `j2k_craft`'s HT
encoder (it needs cv2; it is not a test):

    python tests/make_htj2k_fixtures.py     # ~40 s

- `ht/val_00000_53_rct_ht.jp2`: val image 0 (decoded from the committed
  `lossless/val_00000.jp2`, which equals its PNG) as HT code-blocks, the
  5/3 wavelet with RCT, 5 levels, 64x64 code-blocks, one cleanup pass
  per block (lossless: its digest carries the PNG);
- `ht/val_00000_97_ict_ht.jp2`: the same image, the 9/7 wavelet with ICT,
  every band quantised by the step 2^(8 - HT97_EXPN), three HT passes
  per block (cleanup, SigProp, MagRef);
- `matrix/craft_ht_*`, `matrix/craft_p2_*` and the two edge cases, on
  the 24x37 crop of `make_jp2_fixtures.py`: HT in 1-3 passes, 5/3 and
  9/7, VSC, 4x4 and 1024x4 code-blocks, RPCL with precincts and tiles,
  TERMALL layers, and what cv2 refuses (passes split over layers, a
  fourth pass, the mixed HT bit); the MCT/MCC/MCO offset array, MCO
  alone, CBD, COD's MCT byte 2; 32 levels under CPRL; a POC that gives
  the top resolution no packet.

The digests of these files are merged into `cv2_digests.json` (the
rest of it is left as it is); `make_jp2_fixtures.py` ends by running
this script."""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "fixtures", "jp2")
BENCH = os.path.join(HERE, "fixtures", "certification512", "bench_img.png")
sys.path.insert(0, HERE)

import j2k_craft as jc  # noqa: E402

HT97_EXPN = 7
LOSSLESS_HT = "ht/val_00000_53_rct_ht.jp2"


def _mct_record(index, values, element=0, array=1):
    """An MCT marker with record `index` of int16 (element 0) values."""
    imct = (element << 10) | (array << 8) | index
    return 0xff74, struct.pack(">HHH", 0, imct, 0) + b"".join(
        struct.pack(">H", v & 0xffff) for v in values)


def _mcc(index, nc, deco, offset):
    """An MCC marker: one array-based collection of components 0..nc-1."""
    body = bytes([1]) + struct.pack(">H", nc) + bytes(range(nc))
    body += struct.pack(">H", nc) + bytes(range(nc))
    body += ((1 << 16) | (offset << 8) | deco).to_bytes(3, "big")
    return 0xff75, struct.pack(">HBHH", 0, index, 0, 1) + body


def matrix():
    """{name under matrix/: file bytes}."""
    rgb = cv2.imread(BENCH)[192:256, 384:512][..., ::-1]
    small = rgb[8:32, 40:77].astype(np.int64)
    comps = [small[..., k] for k in range(3)]
    ht = jc.HT
    out = {
        "craft_ht_53_p1.jp2": jc.jp2(jc.encode(
            comps, levels=2, mct=True, cblksty=ht)),
        "craft_ht_53_p3.jp2": jc.jp2(jc.encode(
            comps, levels=2, mct=True, cblksty=ht, ht_passes=3, cblk=(3, 3))),
        "craft_ht_97_p3.jp2": jc.jp2(jc.encode(
            comps, levels=2, mct=True, reversible=False, quant=(7, 300),
            cblksty=ht, ht_passes=3)),
        "craft_ht_vsc_p2.jp2": jc.jp2(jc.encode(
            comps, levels=1, cblksty=ht | jc.VSC, ht_passes=2, cblk=(3, 3))),
        "craft_ht_cblk_4x4.jp2": jc.jp2(jc.encode(
            comps, levels=2, cblksty=ht, ht_passes=3, cblk=(2, 2))),
        "craft_ht_cblk_1024x4.jp2": jc.jp2(jc.encode(
            comps, levels=1, cblksty=ht, ht_passes=3, cblk=(10, 2))),
        "craft_ht_rpcl_tiles.jp2": jc.jp2(jc.encode(
            comps, levels=2, cblksty=ht, ht_passes=3, progression="RPCL",
            precincts=[(2, 2), (3, 3), (3, 3)], cblk=(2, 2), tile=(16, 16))),
        "craft_ht_termall_layers.jp2": jc.jp2(jc.encode(
            comps, levels=2, cblksty=ht | jc.TERMALL, ht_passes=3, layers=3)),
        "craft_ht_layers_split.jp2": jc.jp2(jc.encode(
            comps, levels=2, cblksty=ht, ht_passes=3, layers=3)),
        "craft_ht_4_passes.jp2": jc.jp2(jc.encode(
            comps, levels=1, cblksty=ht, ht_passes=3, ht_extra=1)),
        "craft_ht_mixed.jp2": jc.jp2(jc.set_cblksty(jc.encode(
            comps, levels=1, cblksty=ht), 0xc0)),
    }
    base = jc.encode(comps, levels=1)
    out["craft_p2_mco_offset.jp2"] = jc.jp2(jc.with_main_markers(base, add=[
        _mct_record(1, [100, 40, 200]), _mcc(5, 3, 0, 1),
        (0xff77, b"\1\5")]))
    out["craft_p2_mco.jp2"] = jc.jp2(jc.with_main_markers(
        base, add=[(0xff77, b"\0")]))
    out["craft_p2_cbd.jp2"] = jc.jp2(jc.with_main_markers(
        base, add=[(0xff78, b"\0\3\x0b\x09\x07")]))

    def mct2(p):
        p = bytearray(p)
        p[4] = 2
        return bytes(p)
    out["craft_p2_cod_mct2.jp2"] = jc.jp2(jc.with_main_markers(
        jc.encode(comps, levels=1, mct=True), edit={0xff52: mct2}))
    out["craft_levels32_cprl.j2k"] = jc.encode(comps, levels=32,
                                               progression="CPRL")
    out["craft_poc_top_skipped.jp2"] = jc.jp2(jc.encode(
        comps, levels=2, pocs=[(0, 0, 1, 2, 3, 0)]))
    return out


def full_size():
    """{name under ht/: file bytes} of val image 0."""
    bgr = cv2.imread(os.path.join(OUT, "lossless", "val_00000.jp2"))
    comps = [bgr[..., 2 - k].astype(np.int64) for k in range(3)]
    return {
        os.path.basename(LOSSLESS_HT): jc.jp2(jc.encode(
            comps, levels=5, mct=True, cblksty=jc.HT)),
        "val_00000_97_ict_ht.jp2": jc.jp2(jc.encode(
            comps, levels=5, mct=True, reversible=False,
            quant=(HT97_EXPN, 0), cblksty=jc.HT, ht_passes=3)),
    }


def rgb_digest(path):
    img = cv2.imread(path)
    if img is None:
        return None
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return list(img.shape), hashlib.sha256(img.tobytes()).hexdigest()


def main():
    written = {}
    for sub, files in (("matrix", matrix()), ("ht", full_size())):
        os.makedirs(os.path.join(OUT, sub), exist_ok=True)
        for name, data in files.items():
            with open(os.path.join(OUT, sub, name), "wb") as f:
                f.write(data)
            written["%s/%s" % (sub, name)] = len(data)
    path = os.path.join(OUT, "cv2_digests.json")
    with open(path) as f:
        digests = json.load(f)
    for rel in written:
        d = rgb_digest(os.path.join(OUT, rel))
        digests[rel] = {"cv2": None} if d is None else {"shape": d[0],
                                                        "sha256": d[1]}
    png = digests["lossless/val_00000.jp2"]
    assert digests[LOSSLESS_HT]["sha256"] == png["sha256"], LOSSLESS_HT
    digests[LOSSLESS_HT]["png"] = png["png"]
    with open(path, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print("%d files, %.2f MB" % (len(written), sum(written.values()) / 1e6))


if __name__ == "__main__":
    main()
