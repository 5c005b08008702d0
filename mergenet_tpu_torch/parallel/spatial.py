"""The sharded forward of the port (`mergenet_tpu.parallel.spatial` is
the reference), over a `parallel.mesh.Mesh` of any shape.

The reference shards the batch over 'data' and the image height over
'spatial', and GSPMD inserts the convolutions' halo exchanges.  Here
each rank runs its (data, spatial) block of the batch, the layers
exchange the rows their windows reach across shard edges
(`parallel/halo.py`), replicas of the 'model' axis compute the same
blocks, and every rank gets the whole output."""

import copy

import torch

from .halo import as_rows, spatial
from .mesh import all_gather_batch, check_mesh, local_slice


def build_sharded_forward(model, mesh, apply_sigmoid=True, dtype=None,
                          output_size=None):
    """Returns fwd(imgs) -> (N, h, w, C) float32 over `mesh`.

    imgs: (N, H, W, 3) float (numpy or tensor), N divisible by the data
    axis; a height the spatial axis does not divide runs whole on each
    rank of it.  A copy of `model` runs in eval mode on the mesh's
    device, its float32 parameters and the input cast to `dtype` (None:
    as given) as the reference casts them; the output is float32, the
    sigmoid when `apply_sigmoid`, at `output_size` (models that take
    one; None: the input's size), and the whole batch on every rank."""
    check_mesh(mesh)
    net = copy.deepcopy(model).to(mesh.device).eval()
    if dtype is not None:
        for t in list(net.parameters()) + list(net.buffers()):
            if t.dtype == torch.float32:
                t.data = t.data.to(dtype)
    kwargs = {} if output_size is None else {
        "output_size": tuple(output_size)}

    @torch.no_grad()
    def fwd(imgs):
        imgs = torch.as_tensor(imgs)
        x = imgs[local_slice(imgs.shape[0], mesh)].to(mesh.device)
        if dtype is not None:
            x = x.to(dtype)
        with spatial(mesh):
            out = net(as_rows(x, mesh), **kwargs).float()
        if apply_sigmoid:
            out = torch.sigmoid(out)
        return all_gather_batch(out, mesh)

    fwd.model = net  # the copy it runs
    return fwd
