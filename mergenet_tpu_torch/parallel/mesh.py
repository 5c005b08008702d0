"""The data-parallel mesh of the port (`mergenet_tpu.parallel.mesh` is the
reference).

The reference names a `jax.sharding.Mesh` of ('data', 'spatial',
'model') axes and lets GSPMD insert the collectives.  Here the mesh is
the initialised `torch.distributed` process group, one process and one
device per rank (`torchrun` starts them; the tests start gloo ranks on
the CPU): every rank holds the whole model, takes its contiguous slice
of the global batch (`shard_batch`), and the steps reduce across ranks
what GSPMD reduces across the data axis (gradients, the loss, the
batch-norm statistics; `parallel/train.py`).

Only the data axis is ported.  A spatial or model axis above 1 raises
NotImplementedError: a height-sharded convolution needs GSPMD's halo
exchange, which has no counterpart in a process group, and
`models.tile_predict` already covers inputs too large for one card.
`batch_sharding` and `replicated_sharding` (`NamedSharding` objects)
have no torch counterpart: the steps shard with `shard_batch` and keep
the parameters replicated by construction."""

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape`: {"data", "spatial", "model"} axis sizes; this process's
    `rank` in a world of `world` ranks, and its `device`."""
    shape: dict
    rank: int
    world: int
    device: torch.device


def world_size():
    """Ranks of the initialised process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank():
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def make_mesh(data=0, spatial=1, model=1, device=None):
    """The ('data', 'spatial', 'model') mesh over the initialised process
    group; `data=0` means every rank.  Its device is `cuda:<local rank>`
    (`LOCAL_RANK` as `torchrun` sets it, else the rank), or the CPU when
    `device="cpu"`.  Without a process group the world is this one
    process."""
    if spatial != 1 or model != 1:
        raise NotImplementedError(
            "the port shards the data axis only: spatial=%d, model=%d "
            "(ROADMAP.md section 3)" % (spatial, model))
    n = world_size()
    data = data or n
    if data != n:
        raise ValueError("mesh data=%d != %d ranks: launch one process per "
                         "data shard" % (data, n))
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank()))
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh runs on the GPU by default and no CUDA device "
                "is available; pass device='cpu' explicitly")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    return Mesh({"data": data, "spatial": 1, "model": 1}, rank(), n, dev)


def check_mesh(mesh):
    """`mesh` unchanged when it is a port `Mesh` the port can run:
    TypeError for anything else (a JAX mesh), NotImplementedError for a
    spatial or model axis above 1."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a mergenet_tpu_torch.parallel.Mesh "
                        "(make_mesh), got %s" % type(mesh).__name__)
    if mesh.shape.get("spatial", 1) != 1 or mesh.shape.get("model", 1) != 1:
        raise NotImplementedError(
            "the port shards the data axis only, got mesh shape %s "
            "(ROADMAP.md section 3)" % (mesh.shape,))
    return mesh


def data_axis_for_batch(batch_size: int, n_devices: Optional[int] = None):
    """Largest data-parallel axis size <= n_devices (default: the world
    size) that divides `batch_size`, so every (drop_last) batch shards
    exactly."""
    if n_devices is None:
        n_devices = world_size()
    dp = min(batch_size, n_devices)
    while dp > 1 and batch_size % dp:
        dp -= 1
    return dp


def local_slice(n, mesh):
    """This rank's contiguous slice of a leading axis of `n`, which the
    data axis must divide (the reference's sharding contract)."""
    d = mesh.shape["data"]
    if n % d:
        raise ValueError("batch of %d does not divide over a data axis of "
                         "%d" % (n, d))
    b = n // d
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(batch, mesh):
    """This rank's contiguous slice of the leading axis of every array in
    `batch` (an array, or a tuple, list or dict of them), as tensors on
    the mesh's device."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    x = batch if torch.is_tensor(batch) else torch.as_tensor(
        np.asarray(batch))
    return x[local_slice(x.shape[0], mesh)].to(mesh.device)


def all_gather_batch(x, mesh):
    """The whole batch on every rank from each rank's equal slice `x`
    (concatenated in rank order)."""
    if mesh.world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)
