"""Training targets built on the device (`mergenet_tpu.ops.targets` is
the reference).

From an instance-id mask and a per-instance class table, the
(H, W, num_classes + num_offsets) float32 target the network regresses:
one-hot class planes, then per offset o a plane that is 1 where pixel p
and pixel p + o belong to the same instance.  Out-of-bounds partners
count as "same" (the reference's sign-correct border fill).  Rolls and
compares only, batched over a leading axis."""

import numpy as np
import torch


def instance_mask_to_class_mask(mask, object_class):
    """(N, H, W) class ids from (N, H, W) instance ids and the (N, K)
    instance-id -> class-id tables (ids must lie in [0, K))."""
    n = mask.shape[0]
    return torch.gather(object_class.long(), 1,
                        mask.reshape(n, -1).long()).reshape(mask.shape)


def _border_same(H, W, di, dj, device):
    """(H, W) bool plane marking pixels whose +offset partner is out of
    bounds."""
    rows = torch.arange(H, device=device)[:, None]
    cols = torch.arange(W, device=device)[None, :]
    return ((rows + di < 0) | (rows + di >= H)
            | (cols + dj < 0) | (cols + dj >= W))


def mask_to_target(mask, object_class, num_classes, offsets):
    """(N, H, W, num_classes + len(offsets)) float32 targets.

    mask: (N, H, W) integer instance ids (0 = background); object_class:
    (N, K) integer class table (index 0 = background, zero-padded past
    the live instances); num_classes 0 builds offsets-only targets,
    `offsets=()` class-only ones."""
    N, H, W = mask.shape
    planes = []
    if num_classes > 0:
        cls = instance_mask_to_class_mask(mask, object_class)
        planes.append(cls[..., None] == torch.arange(num_classes,
                                                     device=mask.device))
    if offsets:
        same = [(torch.roll(mask, (-di, -dj), dims=(1, 2)) == mask)
                | _border_same(H, W, di, dj, mask.device)
                for di, dj in offsets]
        planes.append(torch.stack(same, dim=-1))
    return torch.cat(planes, dim=-1).float()


def mask_to_target_np(mask, object_class, num_classes, offsets):
    """Pure-numpy twin for one (H, W) mask, for host loaders and tests."""
    H, W = mask.shape
    C, O = num_classes, len(offsets)
    target = np.zeros((H, W, C + O), dtype=np.float32)
    oc = np.asarray(object_class)
    class_mask = oc[mask]
    for c in range(C):
        target[:, :, c] = class_mask == c
    for n, (di, dj) in enumerate(offsets):
        rolled = np.roll(np.roll(mask, -di, axis=0), -dj, axis=1)
        plane = (rolled == mask).astype(np.float32)
        if di < 0:
            plane[:-di, :] = 1
        elif di > 0:
            plane[-di:, :] = 1
        if dj < 0:
            plane[:, :-dj] = 1
        elif dj > 0:
            plane[:, -dj:] = 1
        target[:, :, C + n] = plane
    return target
