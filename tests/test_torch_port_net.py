"""PSPFPNet-r50 forward parity of the PyTorch port with the Flax
reference, with the committed trained weights (bench_ckpt.npz).

A 128x256 input puts c5 at 4x8, which 3 and 6 do not divide, so the
pyramid pooling takes its floor/ceil window branch.  float32 on the CPU
(the card's TF32 does not apply here); max abs error <= 1e-3 on logits
of magnitude ~10."""

import os

import jax
import numpy as np
import pytest
import torch

from mergenet_tpu.models import get_model
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.convert import flax_to_state_dict, load_flax_weights
from mergenet_tpu_torch.models import PSPFPNet, logits_at, probs_at
from torch_port_helpers import FIX512

TOL = 1e-3


@pytest.fixture(scope="module")
def weights():
    p, b = TIO.load_bench_checkpoint(os.path.join(FIX512, "bench_ckpt.npz"))
    f32 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), t)
    return f32(p), f32(b)


def test_converted_state_dict_covers_the_module(weights):
    sd = flax_to_state_dict(*weights)
    model = PSPFPNet(19)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    # HWIO -> OIHW for the stem kernel
    stem = weights[0]["ResNetBackbone_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["ResNetBackbone_0.Conv_0.weight"].numpy(),
        stem.transpose(3, 2, 0, 1))


def test_pspfpnet_r50_logits_match_flax(weights):
    params, batch_stats = weights
    x = np.random.default_rng(0).random((1, 128, 256, 3)).astype(np.float32)
    jm = get_model(9, 10, "pspfpnet")
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, train=False, output_size=(64, 128)))(
            {"params": params, "batch_stats": batch_stats}, x))
    model = load_flax_weights(PSPFPNet(19).eval(), params, batch_stats)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        got = logits_at(model, torch.from_numpy(x), (64, 128)).numpy()
    assert got.shape == ref.shape == (1, 64, 128, 19)
    assert np.abs(got - ref).max() <= TOL
    probs = probs_at(model, torch.from_numpy(x), (64, 128)).numpy()
    np.testing.assert_allclose(probs, 1 / (1 + np.exp(-got)), atol=1e-6)
