"""Shared building blocks of the PyTorch model port (`mergenet_tpu.models
.layers` is the reference).

Modules run NCHW tensors in `channels_last` memory format: an NHWC array
permuted to NCHW is already channels_last, so the JAX layout at the
public functions costs no copy.  Submodules keep the Flax module names
(`Conv_0`, `SyncBatchNorm_0`, ...) so `convert.py` maps a Flax parameter
tree onto the state dict by name.

Compute dtype: every conv casts its weight and bias to its input's
dtype at use, so a model holding float32 parameters runs in bf16 when
its input is bf16 (the reference's `dtype=jnp.bfloat16`: float32
params, bf16 compute); batch norm keeps float32 statistics.

Height sharding: while a step or forward runs over a mesh whose spatial
axis is above 1, `SPATIAL` holds its `parallel.halo.SpatialContext`
and the ops whose windows cross rows (convs, pooling, resizes, the
stem) ask it for their rows; sizes the models pass between layers are
global sizes (`hw`).  Without it every op is the plain one."""

import math

import torch
import torch.nn.functional as F
from torch import nn

#: the spatial context of a height-sharded run (`parallel.halo.spatial`
#: sets it), else None
SPATIAL = None


def hw(x):
    """The global spatial size (h, w) of an NCHW activation."""
    return SPATIAL.hw(x) if SPATIAL is not None else tuple(x.shape[-2:])


def replicate(x):
    """`x` whole on every rank of a spatial axis (gathered when it is
    height-sharded); `x` itself otherwise."""
    return SPATIAL.gather(x) if SPATIAL is not None else x


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in its input's dtype (the reference's
    `nn.Conv(dtype=...)`, which promotes params to the compute dtype)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if SPATIAL is not None:
            return SPATIAL.conv(x, self.weight.to(x.dtype), bias,
                                self.stride, self.padding, self.dilation)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` computing in its input's dtype.  Its weight
    (in, out, kh, kw) is the reference's `nn.ConvTranspose` kernel
    (kh, kw, in, out) flipped in both spatial axes (`convert.py`)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)

        def fn(t):
            return F.conv_transpose2d(t, self.weight.to(x.dtype), bias,
                                      self.stride, self.padding)
        if SPATIAL is not None:
            return SPATIAL.conv_transpose(x, fn, self.kernel_size[0],
                                          self.stride[0], self.padding[0])
        return fn(x)


def conv2d(cin, cout, k, stride=1, padding=0, dilation=1, bias=False):
    """A conv as `nn.Conv` builds it in the reference, with the padding
    spelled out (torch pads symmetrically; the reference's strided
    convs use explicit symmetric padding for the same reason)."""
    return Conv2d(cin, cout, k, stride=stride, padding=padding,
                  dilation=dilation, bias=bias)


class SyncBatchNorm(nn.Module):
    """Batch norm with flax `nn.BatchNorm`'s semantics (momentum 0.9,
    epsilon 1e-5).

    Train mode normalises with the batch's statistics, taken in float32
    over (N, H, W), and updates the running statistics with flax's rule:
    `running = 0.9 * running + 0.1 * batch`, where the batch variance is
    the BIASED one (ddof=0; `torch.nn.BatchNorm2d` would use ddof=1).  A
    single value per channel (N*H*W == 1, the pyramid pooling's 1x1
    branch at batch 1) has variance 0, so the output is the bias, as in
    flax.  Setting `update_stats = False` keeps the running statistics
    (the train step does so while `torch.utils.checkpoint` recomputes a
    forward, which must not count the batch twice).

    Eval mode: y = (x - mean) * scale / sqrt(var + eps) + bias, with the
    affine folded in float32 and applied in the input's dtype.

    Cross-replica statistics: while `mesh` holds a `parallel.Mesh` (the
    train steps set it), train mode takes the statistics of the global
    batch, as GSPMD gives the reference: each rank's per-channel mean
    and sum of squared deviations from it are gathered in one
    differentiable collective and merged into the global mean and
    (biased) variance.  A height-sharded activation reduces over the data
    x spatial ranks of this model replica, a whole one over the data
    ranks of its (spatial, model) position: every pixel counts once.
    Not `torch.nn.SyncBatchNorm`, whose running variance is unbiased."""

    MOMENTUM = 0.9

    def __init__(self, num_features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.update_stats = True
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            return self._train_forward(x)
        a = self.weight.float() * torch.rsqrt(self.running_var.float()
                                              + self.eps)
        b = self.bias.float() - self.running_mean.float() * a
        return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]

    def _global_train_forward(self, x):
        pdt = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(pdt)
        mean, var = self.mesh.moments(xf)
        d = xf - mean[:, None, None]
        scale = self.weight.to(pdt) * torch.rsqrt(var + self.eps)
        y = d * scale[:, None, None] + self.bias.to(pdt)[:, None, None]
        if self.update_stats:
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
        return y.to(x.dtype)

    def _train_forward(self, x):
        if self.mesh is not None:
            return self._global_train_forward(x)
        # one pass: the normalised output (float32 arithmetic, the input's
        # dtype out) and the float32 batch mean and 1/sqrt(var + eps);
        # no ValueError at one value per channel, unlike F.batch_norm
        pdt = torch.promote_types(x.dtype, torch.float32)
        bias = self.bias.to(pdt)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight.to(pdt), bias, None, None, True, 0.0, self.eps)
        if x.numel() == x.shape[1]:
            # one value per channel: the op's folded affine leaves an ulp
            # of x * scale / sqrt(eps) where flax returns the bias
            # exactly; its gradients (0 to x and scale) stay
            y = y - y.detach() + bias.detach()[:, None, None].to(y.dtype)
        if self.update_stats:
            with torch.no_grad():
                var = (invstd.double().reciprocal().square()
                       - self.eps).clamp_(min=0)
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
        return y


def space_to_depth(x, r=2):
    """NCHW space-to-depth: (N, C, H, W) -> (N, r*r*C, H/r, W/r) with
    the reference's channel order (row-parity, col-parity, channel)."""
    n, c, h, w = x.shape
    return (x.reshape(n, c, h // r, r, w // r, r)
            .permute(0, 3, 5, 1, 2, 4)
            .reshape(n, r * r * c, h // r, w // r))


def _s2d_stem_kernel(weight):
    """Embed a (F, I, 7, 7) stride-2 weight into the (F, 4I, 4, 4)
    stride-1 weight that computes the same conv on space-to-depth-2
    input padded (2, 1): a zero row and column in front (the 4x4 window
    position outside the 7x7 footprint), then each spatial axis split
    into (tap, parity) so the channels line up with `space_to_depth`."""
    f, i = weight.shape[:2]
    k8 = F.pad(weight, (1, 0, 1, 0))
    return (k8.reshape(f, i, 4, 2, 4, 2)
            .permute(0, 3, 5, 1, 2, 4)
            .reshape(f, 4 * i, 4, 4))


class StemConv7(nn.Module):
    """The 7x7/stride-2 ResNet stem conv with symmetric padding 3.  With
    `s2d=True` (and even H and W, as the reference requires; otherwise
    the strided conv runs) it computes the same conv as a 4x4/stride-1
    conv over the 2x2 space-to-depth input, equal up to float summation
    order.  The parameter is the (features, in, 7, 7) weight either way,
    so checkpoints do not change."""

    def __init__(self, cin=3, features=64, s2d=False):
        super().__init__()
        self.s2d = s2d
        self.weight = nn.Parameter(torch.empty(features, cin, 7, 7))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # nn.Conv2d's

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if SPATIAL is not None:
            return SPATIAL.stem(x, w, self.s2d)
        if self.s2d and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            return F.conv2d(F.pad(space_to_depth(x), (2, 1, 2, 1)),
                            _s2d_stem_kernel(w))
        return F.conv2d(x, w, stride=2, padding=3)


class Dropout(nn.Module):
    """flax `nn.Dropout(rate, deterministic=not train)`: in train mode
    each element is kept with probability 1 - rate (a uniform draw below
    it) and scaled by 1 / (1 - rate); in eval mode the identity.  The
    draws come from `generator`, a `torch.Generator` on the input's
    device that the train step sets (its `rng` argument); train mode
    without one raises: torch's global generator is never used.  While
    `mesh` holds a `parallel.Mesh` (the train steps set it), the mask is
    this rank's block of the global batch's, as GSPMD draws it."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate
        self.generator = None
        self.mesh = None

    def mask(self, x):
        """The keep mask of `x`'s shape (True = kept)."""
        if self.generator is None:
            raise RuntimeError(
                "dropout in train mode needs a torch.Generator: pass the "
                "train step its rng argument")
        if self.mesh is not None:
            return self.mesh.dropout_mask(x, self.rate, self.generator)
        return torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - self.rate

    def forward(self, x):
        if not self.training or self.rate == 0:
            return x
        keep = 1.0 - self.rate
        return torch.where(self.mask(x), x / keep, torch.zeros_like(x))


class ConcatFusionConv(nn.Module):
    """3x3/SAME conv with bias over the channel concat of same-shape
    feature maps (the reference splits it into per-part partial convs,
    an HBM saving on the TPU; the parameters are the same)."""

    def __init__(self, cin, features):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, cin, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # nn.Conv2d's
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, parts):
        x = torch.cat(parts, dim=1)
        if SPATIAL is not None:
            return SPATIAL.conv(x, self.weight.to(x.dtype),
                                self.bias.to(x.dtype), (1, 1), (1, 1),
                                (1, 1))
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=1)


class ConvBNRelu(nn.Module):
    """conv -> batch norm -> relu, the reference's workhorse block."""

    def __init__(self, cin, features, kernel=3, stride=1, dilation=1,
                 use_bias=False, relu=True):
        super().__init__()
        pad = dilation * (kernel - 1) // 2
        self.Conv_0 = conv2d(cin, features, kernel, stride, pad, dilation,
                             use_bias)
        self.SyncBatchNorm_0 = SyncBatchNorm(features)
        self.relu = relu

    def forward(self, x):
        x = self.SyncBatchNorm_0(self.Conv_0(x))
        return F.relu(x) if self.relu else x


def resize_bilinear(x, size):
    """Bilinear resize of an NCHW tensor to spatial `size` (h, w):
    half-pixel centres (`align_corners=False`) with edge clamping, and an
    antialiasing triangle filter on each downsampled axis — the function
    `jax.image.resize(..., "bilinear")` computes, which the reference
    uses for every resize (its upsampling matrices reproduce it).
    `size` is global: a height shard resizes to its rows of it."""
    H, W = int(size[0]), int(size[1])
    h, w = hw(x)
    if (H, W) == (h, w):
        return x
    if SPATIAL is not None:
        return SPATIAL.resize(x, (H, W), H < h or W < w)
    return F.interpolate(x, size=(H, W), mode="bilinear",
                         align_corners=False, antialias=(H < h or W < w))


def to_nchw(x, dtype=None):
    """A model's NHWC input as NCHW (its storage is channels_last
    already: no copy), cast to the compute `dtype` when one is set."""
    x = x.permute(0, 3, 1, 2)
    return x if dtype is None else x.to(dtype)


def nhwc_logits(y, size):
    """An NCHW head output resized to `size`, as float32 NHWC logits."""
    return resize_bilinear(y, size).permute(0, 2, 3, 1).float()


def max_pool(x, window=2, stride=2, padding=0):
    """Max pooling; padded positions never win (-inf padding)."""
    if SPATIAL is not None:
        return SPATIAL.max_pool(x, window, stride, padding)
    return F.max_pool2d(x, window, stride, padding)


def adaptive_avg_pool(x, out_size):
    """Adaptive average pooling to (out_size, out_size) over the
    floor/ceil index windows [floor(i*h/o), ceil((i+1)*h/o)) — the
    reference's general-case windows, and plain average pooling when
    the size divides.  A height shard is gathered first."""
    if SPATIAL is not None:
        return SPATIAL.adaptive_pool(x, out_size)
    return F.adaptive_avg_pool2d(x, out_size)
