"""Layer parity of the PyTorch port with the Flax reference
(mergenet_tpu/models/layers.py), plus the port's own readers.

Inputs come from a numpy seed; float32 throughout.  Tolerance 1e-5
absolute: the same arithmetic in another summation order."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models import layers as JL
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.models import layers as TL
from torch_port_helpers import FIX512

TOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("size", [(26, 34), (13, 40), (5, 7), (6, 17),
                                  (13, 17)])
def test_resize_bilinear_up_and_down(size):
    """Upsampling (the reference's matrices) and downsampling (its
    antialiased jax.image.resize) on a 13x17 input."""
    x = np.random.default_rng(0).standard_normal((2, 13, 17, 4)) \
        .astype(np.float32)
    ref = np.asarray(JL.resize_bilinear(jnp.asarray(x), size))
    got = _nhwc(TL.resize_bilinear(_nchw(x), size))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("out_size", [1, 2, 3, 6])
def test_adaptive_avg_pool_4x8(out_size):
    """4x8 -> (1, 2, 3, 6): 3 and 6 take the floor/ceil window branch."""
    x = np.random.default_rng(1).standard_normal((2, 4, 8, 5)) \
        .astype(np.float32)
    ref = np.asarray(JL.adaptive_avg_pool(jnp.asarray(x), out_size))
    got = _nhwc(TL.adaptive_avg_pool(_nchw(x), out_size))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_max_pool_3x3_s2_padded():
    x = np.random.default_rng(2).standard_normal((1, 9, 12, 3)) \
        .astype(np.float32)
    ref = np.asarray(JL.max_pool(jnp.asarray(x), window=3, stride=2,
                                 padding=((1, 1), (1, 1))))
    got = _nhwc(TL.max_pool(_nchw(x), window=3, stride=2, padding=1))
    np.testing.assert_array_equal(got, ref)


def test_conv_bn_relu_and_bn_eval():
    """ConvBNRelu (eval-mode batch norm) with converted Flax variables."""
    from mergenet_tpu_torch.convert import flax_to_state_dict
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 12, 6)).astype(np.float32)
    jm = JL.ConvBNRelu(features=8, kernel=3)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = {"SyncBatchNorm_0": {"BatchNorm_0": {
        "mean": rng.standard_normal(8).astype(np.float32),
        "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}}}
    params["SyncBatchNorm_0"]["BatchNorm_0"]["scale"] = \
        rng.standard_normal(8).astype(np.float32)
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                              jnp.asarray(x), train=False))
    tm = TL.ConvBNRelu(6, 8, kernel=3).eval()
    tm.load_state_dict(flax_to_state_dict(params, stats), strict=True)
    got = _nhwc(tm(_nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_png_reader_matches_cv2():
    import cv2
    path = os.path.join(FIX512, "bench_img.png")
    ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    got = TIO.read_png_rgb(path)
    assert got.dtype == np.uint8 and got.shape == (512, 1024, 3)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_filters_round_trip(ftype):
    """Each of the five PNG scanline filters, encoded here, decodes back."""
    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (6, 9, 3)).astype(np.uint8)
    prev = np.zeros(27, np.int64)
    for row in img:
        x = row.reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(3, np.int64), x[:-3]])
        ul = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
        pred = [0 * x, left, prev, (left + prev) >> 1,
                np.array([TIO._paeth(a, b, c)
                          for a, b, c in zip(left, prev, ul)])][ftype]
        filt = ((x - pred) % 256).astype(np.uint8)
        got = TIO._unfilter_row(ftype, filt, prev.astype(np.uint8), 3)
        np.testing.assert_array_equal(got, row.reshape(-1))
        prev = x


def test_checkpoint_tree_matches_bench_reader():
    import bench
    path = os.path.join(FIX512, "bench_ckpt.npz")
    ref_p, ref_b = bench.load_bench_checkpoint(path)
    got_p, got_b = TIO.load_bench_checkpoint(path)
    ref = dict(jax.tree_util.tree_flatten_with_path((ref_p, ref_b))[0])
    got = dict(jax.tree_util.tree_flatten_with_path((got_p, got_b))[0])
    assert ref.keys() == got.keys() and len(ref) == 305
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
