"""The sharded forward of the port (`mergenet_tpu.parallel.spatial` is
the reference), over the data axis of a `parallel.mesh.Mesh`.

The reference shards the batch over 'data' and the image height over
'spatial', and GSPMD inserts the convolutions' halo exchanges.  The
port shards the batch only (`parallel/mesh.py` says why a spatial axis
raises): each rank runs its slice of the batch and every rank gets the
whole output."""

import copy

import torch

from .mesh import all_gather_batch, check_mesh, local_slice


def build_sharded_forward(model, mesh, apply_sigmoid=True, dtype=None):
    """Returns fwd(imgs) -> (N, H, W, C) float32 over `mesh`.

    imgs: (N, H, W, 3) float (numpy or tensor), N divisible by the data
    axis.  A copy of `model` runs in eval mode on the mesh's device,
    its float32 parameters and the input cast to `dtype` (None: as
    given) as the reference casts them; the output is float32, the
    sigmoid when `apply_sigmoid`, and the whole batch on every rank."""
    check_mesh(mesh)
    net = copy.deepcopy(model).to(mesh.device).eval()
    if dtype is not None:
        for t in list(net.parameters()) + list(net.buffers()):
            if t.dtype == torch.float32:
                t.data = t.data.to(dtype)

    @torch.no_grad()
    def fwd(imgs):
        imgs = torch.as_tensor(imgs)
        x = imgs[local_slice(imgs.shape[0], mesh)].to(mesh.device)
        if dtype is not None:
            x = x.to(dtype)
        out = net(x).float()
        if apply_sigmoid:
            out = torch.sigmoid(out)
        return all_gather_batch(out, mesh)

    fwd.model = net  # the copy it runs
    return fwd
