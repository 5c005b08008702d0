"""COCO mask API (RLE) — a from-scratch numpy implementation (a copy of
`mergenet_tpu/data/rle.py`; polygons are filled by `imgproc.fill_poly`,
cv2's fillPoly in numpy).

The environment has no pycocotools, so this module provides the subset of
`pycocotools.mask` the pipeline needs, byte-compatible with the COCO
compressed-RLE string format so results interoperate with standard tooling:

    encode(mask)        binary (H, W) F-order mask -> RLE dict
    decode(rle)         RLE dict -> binary (H, W) mask
    merge(rles)         union (or intersection) of RLEs
    area(rle)           pixel count
    iou(dt, gt, iscrowd)  pairwise mask IoU
    frPyObjects(objs, h, w)  polygon / uncompressed RLE -> RLE

RLE convention (per the COCO spec): counts alternate runs of 0s and 1s in
Fortran (column-major) order, starting with the count of 0s.  The
compressed string packs each count LEB128-style in 6-bit chunks (+48 so
bytes are printable ASCII), with counts[i>=2] delta-encoded against
counts[i-2].
"""

import numpy as np


def _counts_from_mask(mask):
    """(H, W) binary mask -> run-length counts, F-order, starting with 0s."""
    flat = np.asfortranarray(mask).flatten(order="F").astype(np.uint8)
    n = flat.size
    if n == 0:
        return [0]
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    boundaries = np.concatenate([[0], change, [n]])
    runs = np.diff(boundaries).tolist()
    if flat[0] == 1:  # must start with a zero-run
        runs = [0] + runs
    return runs


def _mask_from_counts(counts, h, w):
    n = h * w
    flat = np.zeros(n, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        c = int(c)
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def _leb_encode(counts):
    """COCO 6-bit LEB variant with delta encoding of counts[i>=2]."""
    out = bytearray()
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:  # maskApi.c rleToString: delta-encode from index 3 on
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            sign = bool(c & 0x10)
            more = not ((x == 0 and not sign) or (x == -1 and sign))
            if more:
                c |= 0x20
            out.append(c + 48)
    return bytes(out)


def _leb_decode(s):
    if isinstance(s, str):
        s = s.encode("ascii")
    counts = []
    pos = 0
    n = len(s)
    while pos < n:
        x = 0
        k = 0
        more = True
        while more:
            c = s[pos] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            pos += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k + 5)  # sign extend
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask):
    """Binary (H, W) mask -> compressed RLE {'size': [h, w], 'counts': bytes}.

    Accepts uint8/bool arrays (F- or C-order; flattening is column-major as
    in the COCO spec)."""
    h, w = mask.shape[:2]
    counts = _counts_from_mask(mask)
    return {"size": [int(h), int(w)], "counts": _leb_encode(counts)}


def decode(rle):
    """RLE dict -> binary (H, W) uint8 mask.  Accepts compressed (bytes/str
    counts) or uncompressed (list counts)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _leb_decode(counts)
    return _mask_from_counts(counts, h, w)


def area(rle):
    """Foreground pixel count of an RLE."""
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _leb_decode(counts)
    return int(sum(counts[1::2]))


def merge(rles, intersect=False):
    """Union (or intersection) of a list of RLEs."""
    if not rles:
        return {"size": [0, 0], "counts": b""}
    m = decode(rles[0]).astype(bool)
    for r in rles[1:]:
        other = decode(r).astype(bool)
        m = (m & other) if intersect else (m | other)
    return encode(m.astype(np.uint8))


def iou(dt, gt, iscrowd=None):
    """Pairwise IoU between two lists of RLEs.

    Returns (len(dt), len(gt)) float array.  When iscrowd[j] is truthy, the
    union is just the detection's area (COCO crowd convention)."""
    if iscrowd is None:
        iscrowd = [0] * len(gt)
    D, G = len(dt), len(gt)
    out = np.zeros((D, G), dtype=np.float64)
    d_masks = [decode(d).astype(bool) for d in dt]
    g_masks = [decode(g).astype(bool) for g in gt]
    d_areas = [int(m.sum()) for m in d_masks]
    g_areas = [int(m.sum()) for m in g_masks]
    for i in range(D):
        for j in range(G):
            inter = int((d_masks[i] & g_masks[j]).sum())
            if iscrowd[j]:
                union = d_areas[i]
            else:
                union = d_areas[i] + g_areas[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


def frPyObjects(objs, h, w):
    """Convert polygon(s) / uncompressed RLE(s) to RLE.

    Mirrors pycocotools.mask.frPyObjects as the reference does: a list of
    polygons (flat [x0, y0, x1, y1, ...]) returns a list of RLEs, a list
    of dicts a list, a single dict one RLE.  Polygons are filled as the
    reference fills them (`cv2.fillPoly` on vertices rounded half to
    even), by `imgproc.poly_mask`."""
    from .imgproc import poly_mask

    if isinstance(objs, dict):
        if "counts" in objs:  # uncompressed RLE
            return {"size": list(objs["size"]),
                    "counts": _leb_encode(objs["counts"])}
        raise ValueError("unsupported object {}".format(objs))
    if len(objs) == 0:
        return []
    if isinstance(objs[0], dict):
        return [frPyObjects(o, h, w) for o in objs]
    if isinstance(objs[0], (list, tuple, np.ndarray)):
        return [encode(poly_mask(p, h, w)) for p in objs]
    # single flat polygon
    return [encode(poly_mask(objs, h, w))]
