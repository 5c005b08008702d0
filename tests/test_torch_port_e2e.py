"""The slice as a whole: `e2e.build_e2e_infer` of the port (uint8 image
-> PSPFPNet-r50 logits at the decode size -> `decode_hierarchical` ->
nearest upsample) against the reference's `utils/e2e.py` hier mode, with
the committed trained weights on a committed val image, float32 on the
CPU.

The two nets' logits differ by float32 summation order only (max abs
~1e-5, see test_torch_port_net.py), far inside every decode threshold
here, so the served masks must be the same partition up to renaming,
with equal instance classes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models import get_model
from mergenet_tpu.utils.e2e import build_e2e_infer as jax_build
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.convert import load_flax_weights
from mergenet_tpu_torch.e2e import build_e2e_infer
from mergenet_tpu_torch.models import PSPFPNet
from torch_port_helpers import FIX512, assert_same_partition


def test_served_frame_matches_reference():
    p, b = TIO.load_bench_checkpoint(os.path.join(FIX512, "bench_ckpt.npz"))
    p, b = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  (p, b))
    offsets = TIO.load_offsets(FIX512)
    img = TIO.read_png_rgb(os.path.join(FIX512, "bench_img.png"))[None]
    size = (256, 512)  # decode at half the 512x1024 input, as served

    ref_infer = jax_build(get_model(9, 10, "pspfpnet"), 9, offsets,
                          decode_size=size)
    rm, rc = ref_infer({"params": p, "batch_stats": b},
                       jnp.asarray(img.astype(np.float32) / 256.0))
    infer = build_e2e_infer(load_flax_weights(PSPFPNet(19), p, b), 9,
                            offsets, decode_size=size, device="cpu")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        gm, gc = infer(img)
    assert gm.shape == (1, 512, 1024) and gc.shape == (1, 8192)
    assert_same_partition(gm[0].numpy(), np.asarray(rm[0]), gc[0].numpy(),
                          np.asarray(rc[0]))
    assert int(gm.max()) >= 1


def test_entry_points_default_to_the_card():
    """device=None means CUDA: without a GPU the entry points raise
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from mergenet_tpu_torch.decoder.device import decode_hierarchical
    cp = np.full((8, 8, 2), 0.5, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decode_hierarchical(cp, cp[..., :1], 2, ((0, 1),))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_e2e_infer(PSPFPNet(19), 9, ((0, 1),) * 10)
