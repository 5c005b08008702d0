"""Grid helpers shared by the decoder and the plain kernel versions."""

import torch


def shift2d(x, di, dj, fill):
    """x shifted so out[i, j] = x[i + di, j + dj] (leading two dims),
    out-of-range -> fill."""
    H, W = x.shape[:2]
    out = torch.full_like(x, fill)
    if abs(di) >= H or abs(dj) >= W:
        return out
    r0, r1 = max(0, -di), H - max(0, di)
    c0, c1 = max(0, -dj), W - max(0, dj)
    out[r0:r1, c0:c1] = x[r0 + di:r1 + di, c0 + dj:c1 + dj]
    return out
