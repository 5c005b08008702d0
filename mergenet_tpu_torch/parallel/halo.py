"""Height-sharded activations and their halo exchange: the port's
counterpart of the halo exchanges GSPMD inserts for a mesh's 'spatial'
axis (`mergenet_tpu/parallel/spatial.py`).

Layout.  On a mesh with spatial = S > 1, an activation of global height
H is *sharded* when S divides H: rank s of the spatial axis holds the
rows [s * H / S, (s + 1) * H / S) as a `Rows` tensor (a torch.Tensor
subclass that remembers which dimension is the height and passes that
on through the ops it meets).  When S does not divide H the activation
is *replicated*: every rank of the axis holds all of it, as a plain
tensor.  Each op decides the layout of its output from the output's
global height alone, so tensors of one height always agree (they can be
added and concatenated).

The layers (`models/layers.py`) call the `SpatialContext` that
`spatial(mesh)` installs as `layers.SPATIAL`:

  * windowed ops (convs, max pooling) run on the rank's rows extended by
    the rows their windows reach into from the neighbouring shards
    (`halo`, an autograd Function: the forward receives those rows,
    filled with the op's own padding at the image's edges, zeros or
    -inf; the backward sends their gradients back to their owner, which
    adds them).  The rows are computed from the op's global padding, so a
    strided window starts on the right row of every shard.  A shard too
    short for the halo, or an input that is replicated, is gathered and
    the op computes this rank's output rows from the whole;
  * a bilinear upsample by a power of two needs one row per side;
    any other resize gathers, resizes and keeps this rank's rows;
  * pooling over whole bins (the pyramid pooling) gathers;
  * `gather` is differentiable: its backward sums the gradient over
    the axis and keeps this rank's rows (each rank's gradient of a
    replicated tensor is its own part of the whole).

Transport: point-to-point batches and collectives within the spatial
axis (`mesh.exchange`, `mesh.all_gather`, `mesh.all_reduce_`), routed by
the group's backend.  `STATS` counts the bytes this rank sends."""

import contextlib

import torch
import torch.nn.functional as F

from . import mesh as M

#: bytes this rank sent in halo exchanges (forward and backward) and in
#: gathers (`gather`: rows, and batch norm's statistics), and the number
#: of exchanges; read it twice to measure a span
STATS = {"halo_bytes": 0, "halo_exchanges": 0, "gather_bytes": 0}

# ops that keep a tensor's dimensions but not their order or meaning:
# their results are plain tensors
_RELAYOUT = {torch.Tensor.transpose, torch.transpose, torch.Tensor.movedim,
             torch.movedim, torch.Tensor.swapaxes, torch.swapaxes,
             torch.Tensor.reshape, torch.reshape, torch.Tensor.view,
             torch.Tensor.flatten, torch.flatten}
_PERMUTE = {torch.Tensor.permute, torch.permute}


class Rows(torch.Tensor):
    """A rank's block of rows of a height-sharded activation; `_hdim` is
    the height's dimension (2 in NCHW, 1 in NHWC).  Results of torch ops
    on it with as many dimensions are `Rows` too (a permute moves
    `_hdim`); anything else comes back plain."""

    _hdim = 2

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = _first_rows(args)
        if src is None:
            src = _first_rows(tuple(kwargs.values()))
        with torch._C.DisableTorchFunctionSubclass():
            out = func(*args, **kwargs)
            ndim = None if src is None else src.dim()
        if src is None or func in _RELAYOUT:
            return _untag(out)
        hdim = src._hdim
        if func in _PERMUTE:
            dims = args[1] if len(args) == 2 and not isinstance(
                args[1], int) else args[1:]
            dims = kwargs.get("dims", dims)
            hdim = [d % ndim for d in dims].index(hdim)
        return _retag(out, ndim, hdim)


def _first_rows(seq):
    for a in seq:
        if isinstance(a, Rows):
            return a
        if isinstance(a, (tuple, list)):
            r = _first_rows(a)
            if r is not None:
                return r
    return None


def _retag(out, ndim, hdim):
    if isinstance(out, torch.Tensor):
        if torch.Tensor.dim(plain(out)) != ndim:
            return _untag(out)
        return tag(out, hdim)
    if isinstance(out, (tuple, list)):
        return type(out)(_retag(o, ndim, hdim) for o in out)
    return out


def _untag(out):
    if isinstance(out, Rows):
        return out.as_subclass(torch.Tensor)
    if isinstance(out, (tuple, list)):
        return type(out)(_untag(o) for o in out)
    return out


def tag(x, hdim=2):
    """`x` as this rank's rows of a sharded activation."""
    y = x if isinstance(x, Rows) else x.as_subclass(Rows)
    y._hdim = hdim
    return y


def plain(x):
    """`x` as a plain tensor (the same storage)."""
    return x.as_subclass(torch.Tensor) if isinstance(x, Rows) else x


def rows_dim(x):
    """The height dimension of a sharded `x`, None for a whole one."""
    return x._hdim if isinstance(x, Rows) else None


def as_rows(x, mesh, hdim=1):
    """This rank's row block of a whole tensor `x` (the height at
    `hdim`) as `Rows`, or `x` itself when the spatial axis does not
    divide its height (or is 1)."""
    sl = M.row_slice(x.shape[hdim], mesh)
    if sl is None:
        return x
    idx = [slice(None)] * x.dim()
    idx[hdim] = sl
    return tag(plain(x)[tuple(idx)], hdim)


def _fmt(x):
    return (torch.channels_last if x.dim() == 4 and x.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)


def _rows(x, a, b, hdim):
    return x.narrow(hdim, a, b - a)


def _sent(t):
    STATS["halo_bytes"] += t.numel() * t.element_size()
    return t


class _Halo(torch.autograd.Function):
    """x (this rank's h rows, plain) -> its rows extended by los[s] rows
    above and his[s] below (a negative count drops rows), with `fill`
    beyond the image's edges."""

    @staticmethod
    def forward(ctx, x, axis, los, his, fill, hdim):
        S, s, h = axis.size, axis.index, x.shape[hdim]
        lo, hi = los[s], his[s]
        ctx.meta = (axis, los, his, hdim, h)
        sends, recvs = [], []
        if s > 0 and his[s - 1] > 0:
            sends.append((s - 1, _sent(_rows(x, 0, his[s - 1], hdim))))
        if s < S - 1 and los[s + 1] > 0:
            sends.append((s + 1, _sent(_rows(x, h - los[s + 1], h, hdim))))

        def shape(n):
            sh = list(x.shape)
            sh[hdim] = n
            return sh
        if s > 0 and lo > 0:
            recvs.append((s - 1, shape(lo), x.dtype))
        if s < S - 1 and hi > 0:
            recvs.append((s + 1, shape(hi), x.dtype))
        STATS["halo_exchanges"] += 1
        got = M.exchange(axis, sends, recvs, x.device)
        parts = []
        if lo > 0:
            parts.append(got.pop(0) if s > 0 else x.new_full(shape(lo),
                                                             fill))
        parts.append(_rows(x, max(-lo, 0), h - max(-hi, 0), hdim))
        if hi > 0:
            parts.append(got.pop(0) if s < S - 1
                         else x.new_full(shape(hi), fill))
        return torch.cat(parts, hdim).contiguous(memory_format=_fmt(x))

    @staticmethod
    def backward(ctx, g):
        axis, los, his, hdim, h = ctx.meta
        S, s = axis.size, axis.index
        lo, hi = los[s], his[s]
        n = g.shape[hdim]
        top, bottom = max(lo, 0), max(hi, 0)
        shape = list(g.shape)
        shape[hdim] = h
        gx = g.new_zeros(shape).contiguous(memory_format=_fmt(g))
        _rows(gx, max(-lo, 0), h - max(-hi, 0), hdim).copy_(
            _rows(g, top, n - bottom, hdim))
        sends, recvs = [], []
        if s > 0 and lo > 0:
            sends.append((s - 1, _sent(_rows(g, 0, lo, hdim))))
        if s < S - 1 and hi > 0:
            sends.append((s + 1, _sent(_rows(g, n - hi, n, hdim))))

        def sh(k):
            out = list(g.shape)
            out[hdim] = k
            return out
        if s < S - 1 and los[s + 1] > 0:
            recvs.append((s + 1, sh(los[s + 1]), g.dtype))
        if s > 0 and his[s - 1] > 0:
            recvs.append((s - 1, sh(his[s - 1]), g.dtype))
        got = M.exchange(axis, sends, recvs, g.device)
        if s < S - 1 and los[s + 1] > 0:
            _rows(gx, h - los[s + 1], h, hdim).add_(got.pop(0))
        if s > 0 and his[s - 1] > 0:
            _rows(gx, 0, his[s - 1], hdim).add_(got.pop(0))
        return gx, None, None, None, None, None


class _Gather(torch.autograd.Function):
    """this rank's rows (plain) -> the whole tensor on every rank of the
    axis; the backward sums the gradient over the axis and keeps this
    rank's rows."""

    @staticmethod
    def forward(ctx, x, axis, hdim):
        ctx.meta = (axis, hdim, x.shape[hdim])
        STATS["gather_bytes"] += x.numel() * x.element_size()
        return torch.cat(M.all_gather(x, axis), hdim).contiguous(
            memory_format=_fmt(x))

    @staticmethod
    def backward(ctx, g):
        axis, hdim, h = ctx.meta
        g = M.all_reduce_(g.contiguous().clone(), axis)
        return _rows(g, axis.index * h, (axis.index + 1) * h, hdim), \
            None, None


def halo(x, axis, los, his, fill=0.0, hdim=2):
    """Differentiable: this rank's rows `x` (plain) extended by los[s]
    rows from the rank above and his[s] from the rank below (negative:
    drop rows), `fill` beyond the image."""
    return _Halo.apply(x, axis, tuple(los), tuple(his), fill, hdim)


def gather(x, axis, hdim=2):
    """Differentiable: the whole tensor from each rank's rows `x`
    (blocks of equal size along `hdim`, in the axis's order)."""
    if axis.size == 1:
        return plain(x)
    return _Gather.apply(plain(x), axis, hdim)


def gather_rows(x, mesh):
    """The whole tensor on every rank of the spatial axis from a `Rows`
    block (its height at `_hdim`); a whole tensor as it is."""
    hdim = rows_dim(x)
    if hdim is None:
        return x
    return gather(x, mesh.axis("spatial"), hdim)


def global_mask(x, rate, generator, mesh):
    """Dropout's keep mask for this rank's block `x` of a batch-sharded
    (and perhaps height-sharded) NCHW activation: the mask of the global
    shape drawn from `generator`, and this rank's block of it, so every
    mesh draws the one-process step's masks."""
    D = mesh.shape["data"]
    d = mesh.coords[0]
    shape = list(x.shape)
    shape[0] *= D
    hdim = rows_dim(x)
    if hdim is not None:
        shape[hdim] *= mesh.shape["spatial"]
    keep = torch.rand(shape, generator=generator, device=x.device) \
        < 1.0 - rate
    n = x.shape[0]
    keep = keep[d * n:(d + 1) * n]
    if hdim is not None:
        h, s = x.shape[hdim], mesh.coords[1]
        keep = _rows(keep, s * h, (s + 1) * h, hdim)
    return keep


def moments(x, mesh):
    """Batch norm's global per-channel mean and biased variance of the
    NCHW batch whose block `x` this rank holds: over the data x spatial
    ranks of its model replica for a height-sharded `x`, over the data
    ranks of its (spatial, model) position for a whole one, so every
    pixel counts once.  Every rank of the axis holds an equal block of n
    values per channel (`as_rows`): one differentiable gather of the
    blocks' means and centred sums of squares, merged exactly (Chan et
    al.)."""
    axis = mesh.axis("data" if rows_dim(x) is None else "data_spatial")
    n = x.numel() // x.shape[1]
    dims = (0, 2, 3)
    m = x.mean(dims)
    c = x - m[:, None, None]
    part = torch.stack([m, (c * c).sum(dims)])[None]
    means, sums = gather(part, axis, 0).unbind(1)
    mean = means.mean(0)
    var = (sums.sum(0) + n * ((means - mean) ** 2).sum(0)) \
        / (n * axis.size)
    return mean, var


class SpatialContext:
    """The layers' view of a spatial mesh axis while a sharded forward
    runs (`models.layers.SPATIAL`): global sizes, and the ops whose
    windows cross shard edges."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axis = mesh.axis("spatial")
        self.S, self.s = self.axis.size, self.axis.index

    # ---- layouts
    def height(self, x):
        """The global height of an NCHW activation."""
        return x.shape[2] * self.S if isinstance(x, Rows) else x.shape[2]

    def hw(self, x):
        return self.height(x), x.shape[3]

    def out(self, y, H=None):
        """A whole NCHW result `y` in the layout of its height: this
        rank's rows when the axis divides it."""
        H = y.shape[2] if H is None else H
        if H % self.S:
            return y
        h = H // self.S
        return tag(y[:, :, self.s * h:(self.s + 1) * h])

    def gather(self, x):
        return gather(x, self.axis) if isinstance(x, Rows) else x

    # ---- windowed ops
    def windowed(self, x, k, stride, dilation, pad, fill, op):
        """op(rows) runs a window op of height `k` (dilated), `stride` and
        padding `pad` = (top, bottom) over the height, on input rows it
        gets whole (no height padding of its own); returns the result in
        its layout."""
        H = self.height(x)
        ke = dilation * (k - 1) + 1
        pt, pb = pad
        Ho = (H + pt + pb - ke) // stride + 1
        if Ho % self.S:
            full = plain(self.gather(x))
            if pt or pb:
                full = _pad_rows(full, pt, pb, fill)
            return op(full)
        ho = Ho // self.S

        def need(s):  # the global input rows output block s reads
            return s * ho * stride - pt, (s + 1) * ho * stride - stride \
                - pt + ke
        if isinstance(x, Rows):
            h = x.shape[2]
            los = [s * h - need(s)[0] for s in range(self.S)]
            his = [need(s)[1] - (s + 1) * h for s in range(self.S)]
            if max(los + his) <= h:
                return tag(op(halo(plain(x), self.axis, los, his, fill)))
            x = self.gather(x)
        a, b = need(self.s)
        full = _pad_rows(plain(x), pt, pb, fill)
        return tag(op(full[:, :, a + pt:b + pt]))

    def conv(self, x, weight, bias, stride, padding, dilation):
        if weight.shape[2] == 1 and stride[0] == 1 and padding[0] == 0:
            return F.conv2d(x, weight, bias, stride, padding, dilation)
        return self.windowed(
            x, weight.shape[2], stride[0], dilation[0],
            (padding[0], padding[0]), 0.0,
            lambda e: F.conv2d(e, weight, bias, stride, (0, padding[1]),
                               dilation))

    def stem(self, x, w, s2d):
        """`models.layers.StemConv7` (7x7, stride 2, padding 3, weight
        `w`) on a height shard: its space-to-depth form when `s2d` and
        every shard's rows pair up (an even block), else the strided
        7x7."""
        from ..models.layers import _s2d_stem_kernel, space_to_depth
        H, W = self.hw(x)
        if s2d and H % 2 == 0 and W % 2 == 0 and x.shape[2] % 2 == 0:
            y = space_to_depth(plain(x))
            if rows_dim(x) is not None:
                y = tag(y)
            k = _s2d_stem_kernel(w)
            return self.windowed(
                y, 4, 1, 1, (2, 1), 0.0,
                lambda e: F.conv2d(F.pad(e, (2, 1, 0, 0)), k))
        return self.windowed(
            x, 7, 2, 1, (3, 3), 0.0,
            lambda e: F.conv2d(e, w, stride=2, padding=(0, 3)))

    def max_pool(self, x, window, stride, padding):
        return self.windowed(
            x, window, stride, 1, (padding, padding), float("-inf"),
            lambda e: F.max_pool2d(e, window, stride, (0, padding)))

    def conv_transpose(self, x, fn, k, stride, padding):
        """fn(x) is the transposed conv; with k == stride and no padding
        each input row makes its own output rows, so a shard stays
        local."""
        if isinstance(x, Rows) and k == stride and padding == 0:
            return tag(fn(plain(x)))
        return self.out(fn(self.gather(x)))

    def resize(self, x, size, antialias):
        """Bilinear resize (half-pixel centres) to the global `size`."""
        H, W = self.hw(x)
        Ho, Wo = size
        r = Ho // H
        if (isinstance(x, Rows) and Ho % self.S == 0 and not antialias
                and r * H == Ho and r & (r - 1) == 0):
            # each output row reads the rows beside its source row, one
            # beyond the shard at most; at the image's edge the
            # interpolation's own clamp is the reference's
            los = [0] + [1] * (self.S - 1)
            his = [1] * (self.S - 1) + [0]
            ext = halo(plain(x), self.axis, los, his)
            y = F.interpolate(ext, size=(r * ext.shape[2], Wo),
                              mode="bilinear", align_corners=False)
            a = r * los[self.s]
            return tag(y[:, :, a:a + r * x.shape[2]])
        y = F.interpolate(plain(self.gather(x)), size=(Ho, Wo),
                          mode="bilinear", align_corners=False,
                          antialias=antialias)
        return self.out(y)

    def adaptive_pool(self, x, o):
        return self.out(F.adaptive_avg_pool2d(plain(self.gather(x)), o))


def _pad_rows(x, top, bottom, fill):
    if top == 0 and bottom == 0:
        return x
    return F.pad(x, (0, 0, top, bottom), value=fill)


@contextlib.contextmanager
def spatial(mesh):
    """The layers run height-sharded over `mesh`'s spatial axis while
    the context is open (nothing changes when that axis is 1)."""
    from ..models import layers
    if mesh is None or mesh.shape.get("spatial", 1) == 1:
        yield
        return
    saved = layers.SPATIAL
    layers.SPATIAL = SpatialContext(mesh)
    try:
        yield
    finally:
        layers.SPATIAL = saved
