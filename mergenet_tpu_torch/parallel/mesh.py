"""The device mesh of the port (`mergenet_tpu.parallel.mesh` is the
reference).

The reference names a `jax.sharding.Mesh` of ('data', 'spatial',
'model') axes and lets GSPMD insert the collectives.  Here the mesh is
the initialised `torch.distributed` process group, one process and one
device per rank (`torchrun` starts them; the tests start gloo ranks on
the CPU), laid out as the reference lays its devices out
(`reshape(data, spatial, model)`): rank r sits at (d, s, m) with
r = (d * spatial + s) * model + m.

  * data: every rank holds the whole model and takes its contiguous
    slice of the global batch; the steps reduce across ranks what GSPMD
    reduces across the data axis (gradients, the loss, the batch-norm
    statistics; `parallel/train.py`).
  * spatial: the image height of the NHWC batches is split into equal
    contiguous blocks; the layers exchange the boundary rows their
    windows need (`parallel/halo.py`), as GSPMD's halo exchanges do.
  * model: nothing is sharded over it (the reference shards nothing over
    it either): its replicas compute the same blocks, and every reduction
    counts one replica.

`make_mesh` builds the process subgroups those reductions run over
(`Mesh.axes`).  Collectives go through `all_reduce_` and `all_gather`,
point-to-point transfers through `exchange`.  NCCL takes device tensors
in all of them; gloo takes them in its collectives but not in its
point-to-point transfers (they abort on a device pointer: PERF.md), so
on a gloo group `exchange` stages CUDA tensors through host memory: the
group's backend picks the route (`host_route`).
`batch_sharding` and `replicated_sharding` (`NamedSharding` objects)
have no torch counterpart: the steps take each rank's block
(`local_slice`, and `halo.as_rows` for the height) and keep the
parameters replicated by construction."""

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "spatial", "model")

#: transfers this process made through `all_reduce_`, `all_gather` and
#: `exchange`: calls, host seconds inside them (a staged transfer waits
#: for the device's queued work first) and bytes sent
TRANSPORT = {"calls": 0, "seconds": 0.0, "bytes": 0}


def _count(t0, nbytes):
    TRANSPORT["calls"] += 1
    TRANSPORT["seconds"] += time.perf_counter() - t0
    TRANSPORT["bytes"] += nbytes


@dataclasses.dataclass(frozen=True)
class Axis:
    """A set of ranks that reduce or exchange together: `ranks` in
    order, this rank's `index` among them, and their process `group`
    (None for the default group)."""
    ranks: tuple
    index: int
    group: object = None

    @property
    def size(self):
        return len(self.ranks)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape`: {"data", "spatial", "model"} axis sizes; this process's
    `rank` in a world of `world` ranks, and its `device`.  `axes` maps
    "spatial" (the ranks of this rank's (d, m) row), "data_spatial" (the
    data x spatial ranks of its model replica m), "data" (the ranks
    sharing its (s, m)) and "world" to `Axis` objects (`make_mesh` builds
    them; a mesh built by hand runs only where every such set is this
    rank alone)."""
    shape: dict
    rank: int
    world: int
    device: torch.device
    axes: Optional[dict] = dataclasses.field(default=None, compare=False)

    @property
    def coords(self):
        """This rank's (d, s, m)."""
        S, M = self.shape.get("spatial", 1), self.shape.get("model", 1)
        return self.rank // (S * M), self.rank // M % S, self.rank % M

    def axis(self, name):
        if self.axes is not None:
            return self.axes[name]
        D, S = self.shape.get("data", 1), self.shape.get("spatial", 1)
        n = {"data": D, "spatial": S, "data_spatial": D * S,
             "world": self.world}[name]
        if n > 1:
            raise ValueError("a Mesh built by hand has no process groups "
                             "to run its %s axis over: use make_mesh" % name)
        return Axis((self.rank,), 0)

    def moments(self, x):
        """Batch norm's global statistics over this mesh
        (`parallel.halo.moments`)."""
        from .halo import moments
        return moments(x, self)

    def dropout_mask(self, x, rate, generator):
        """Dropout's keep mask for this rank's block `x`
        (`parallel.halo.global_mask`)."""
        from .halo import global_mask
        return global_mask(x, rate, generator, self)


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


def rank_at(shape, d, s, m):
    """The rank at mesh coordinates (d, s, m)."""
    return (d * shape["spatial"] + s) * shape["model"] + m


def _axes(shape, me, world):
    """Every rank builds every subgroup, in one order (new_group is
    collective); returns this rank's."""
    D, S, M = (shape[a] for a in AXES)
    d, s, m = me
    fam = {
        "spatial": [[rank_at(shape, dd, ss, mm) for ss in range(S)]
                    for dd in range(D) for mm in range(M)],
        "data_spatial": [[rank_at(shape, dd, ss, mm) for dd in range(D)
                          for ss in range(S)] for mm in range(M)],
        "data": [[rank_at(shape, dd, ss, mm) for dd in range(D)]
                 for ss in range(S) for mm in range(M)],
    }
    mine = rank_at(shape, d, s, m)
    out = {"world": Axis(tuple(range(world)), mine)}
    made = {}
    for name, sets in fam.items():
        for ranks in sets:
            ranks = tuple(ranks)
            if ranks not in made:
                made[ranks] = (None if len(ranks) in (1, world)
                               else dist.new_group(list(ranks)))
            if mine in ranks:
                out[name] = Axis(ranks, ranks.index(mine), made[ranks])
    return out


def make_mesh(data=0, spatial=1, model=1, device=None):
    """The ('data', 'spatial', 'model') mesh over the initialised process
    group; `data=0` means every rank the other axes leave.  ValueError
    when the axes do not multiply to the world size.  Its device is
    `cuda:<local rank>` (`LOCAL_RANK` as `torchrun` sets it, else the
    rank), or `device` when given (`"cpu"`; `"cuda:0"` for ranks that
    share one card).  Without a process group the world is this one
    process.  Collective: every rank calls it with the same axes."""
    n = world_size()
    if data == 0:
        if n % (spatial * model):
            raise ValueError("spatial=%d x model=%d does not divide %d ranks"
                             % (spatial, model, n))
        data = n // (spatial * model)
    if data * spatial * model != n:
        raise ValueError("mesh %dx%dx%d != %d ranks: launch one process per "
                         "mesh position" % (data, spatial, model, n))
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
    shape = {"data": data, "spatial": spatial, "model": model}
    r = rank()
    mesh = Mesh(shape, r, n, dev)
    return dataclasses.replace(mesh, axes=_axes(shape, mesh.coords, n))


def check_mesh(mesh):
    """`mesh` unchanged when it is a port `Mesh`: TypeError for anything
    else (a JAX mesh), ValueError when its axes do not multiply to its
    world."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a mergenet_tpu_torch.parallel.Mesh "
                        "(make_mesh), got %s" % type(mesh).__name__)
    n = int(np.prod([mesh.shape.get(a, 1) for a in AXES]))
    if n != mesh.world:
        raise ValueError("mesh shape %s holds %d ranks, not the world's %d"
                         % (mesh.shape, n, mesh.world))
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
    """This rank's contiguous slice of a leading (batch) axis of `n`,
    which the data axis must divide (the reference's sharding
    contract); ranks that share a data index share it."""
    D = mesh.shape["data"]
    if n % D:
        raise ValueError("batch of %d does not divide over a data axis of "
                         "%d" % (n, D))
    b, d = n // D, mesh.coords[0]
    return slice(d * b, (d + 1) * b)


def row_slice(h, mesh):
    """This rank's contiguous block of `h` image rows over the spatial
    axis, or None when the axis does not divide `h` (such an array is
    held whole by every rank of the axis)."""
    S = mesh.shape.get("spatial", 1)
    if S == 1 or h % S:
        return None
    k, s = h // S, mesh.coords[1]
    return slice(s * k, (s + 1) * k)


def shard_batch(batch, mesh):
    """This rank's block of every array in `batch` (an array, or a
    tuple, list or dict of them) as tensors on the mesh's device: the
    batch slice of its data index, and for NHWC arrays the height block
    of its spatial index (the reference's `batch_sharding(mesh,
    spatial_axis=1)`)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    from .halo import as_rows, plain
    x = batch if torch.is_tensor(batch) else torch.as_tensor(
        np.asarray(batch))
    x = x[local_slice(x.shape[0], mesh)]
    if x.dim() == 4:
        x = plain(as_rows(x, mesh))
    return x.to(mesh.device)


# ------------------------------------------------------------- transport

def host_route(axis, device):
    """Whether `exchange` stages tensors on `device` through host memory
    to cross `axis`: CUDA tensors on a gloo group.  The group's backend
    decides."""
    return device.type == "cuda" and dist.get_backend(axis.group) == "gloo"


def all_reduce_(t, axis):
    """Sum `t` over `axis` in place; returns it."""
    if axis.size == 1:
        return t
    t0 = time.perf_counter()
    buf = t.contiguous()
    dist.all_reduce(buf, group=axis.group)
    out = t if buf is t else t.copy_(buf)
    _count(t0, buf.numel() * buf.element_size())
    return out


def all_gather(t, axis):
    """[t of each rank of `axis`], in the axis's order."""
    if axis.size == 1:
        return [t]
    t0 = time.perf_counter()
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    _count(t0, src.numel() * src.element_size())
    return parts


def exchange(axis, sends, recvs, device):
    """Point-to-point transfers within `axis` in one batch: `sends` is
    [(index, tensor)], `recvs` [(index, shape, dtype)], indices along the
    axis.  Returns the received tensors, in `recvs`' order, on
    `device`."""
    t0 = time.perf_counter()
    where = torch.device("cpu") if host_route(axis, device) else device
    out = [torch.empty(shape, dtype=dtype, device=where)
           for _, shape, dtype in recvs]
    ops = [dist.P2POp(dist.isend, t.contiguous().to(where),
                      axis.ranks[i], axis.group) for i, t in sends]
    ops += [dist.P2POp(dist.irecv, buf, axis.ranks[i], axis.group)
            for (i, _, _), buf in zip(recvs, out)]
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    got = [b.to(device) for b in out]
    _count(t0, sum(t.numel() * t.element_size() for _, t in sends))
    return got


def all_gather_batch(x, mesh):
    """The whole batch on every rank from each rank's block `x`: the
    (data, spatial) blocks put back together (a `halo.Rows` block along
    its height, any other block whole), one model replica's."""
    from .halo import rows_dim
    if mesh.world == 1:
        return x.as_subclass(torch.Tensor)
    hdim = rows_dim(x)
    parts = all_gather(x.as_subclass(torch.Tensor), mesh.axis("world"))
    D, S = mesh.shape["data"], mesh.shape["spatial"]
    blocks = []
    for d in range(D):
        row = [parts[rank_at(mesh.shape, d, s, 0)] for s in range(S)]
        blocks.append(row[0] if hdim is None else torch.cat(row, hdim))
    return torch.cat(blocks)
