"""The port's served paths against the reference's, with the committed
trained weights (`bench_ckpt.npz`, PSPFPNet-r50, C=9, O=10) on crops of
the committed val images, float32 on the CPU:

- `e2e.build_e2e_infer(decode_mode="exact")` (sigmoid probabilities ->
  staged exact decode -> relabel -> nearest upsample) against
  `utils/e2e.py`'s exact mode;
- `serving.build_serving_pipeline(overflow_fallback=True)` against
  `mergenet_tpu/serving.py` on a one-device CPU mesh: with tight
  capacities every frame overflows and is re-decoded by the exact mode;
  with the certified capacities no frame overflows.

The two nets' outputs differ by float32 summation order only (max abs
~1e-5 on logits, tests/test_torch_port_net.py), far inside every decode
threshold here, so the masks must be the same partition up to renaming
with equal instance classes, and the overflow counts must be equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models import get_model
from mergenet_tpu.parallel.mesh import make_mesh
from mergenet_tpu.serving import build_serving_pipeline as jax_serving
from mergenet_tpu.utils.e2e import build_e2e_infer as jax_e2e
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.convert import load_flax_weights
from mergenet_tpu_torch.e2e import build_e2e_infer
from mergenet_tpu_torch.models import PSPFPNet
from mergenet_tpu_torch.serving import build_serving_pipeline
from torch_port_helpers import FIX512, assert_same_partition

OFFSETS = TIO.load_offsets(FIX512)
#: capacities far below a 64x128 scene's pair and edge counts
TIGHT = dict(max_components=64, pair_components=32, pair_slots=16,
             edge_slots=128)


def _crop(name, rows, cols):
    return TIO.read_png_rgb(os.path.join(FIX512, name))[rows, cols]


@pytest.fixture(scope="module")
def weights():
    p, b = TIO.load_bench_checkpoint(os.path.join(FIX512, "bench_ckpt.npz"))
    p, b = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  (p, b))
    return {"params": p, "batch_stats": b}


@pytest.fixture(scope="module")
def imgs():
    """Two 128x256 uint8 crops of committed val images, two instances
    each; served at half size, 64x128."""
    return np.stack([_crop("bench_img.png", slice(128, 256),
                           slice(128, 384)),
                     _crop("bench_img_1.png", slice(192, 320),
                           slice(0, 256))])


def _port_model(weights):
    return load_flax_weights(PSPFPNet(19), weights["params"],
                             weights["batch_stats"])


def _assert_same_masks(gm, gc, rm, rc):
    gm, gc = np.asarray(gm), np.asarray(gc)
    rm, rc = np.asarray(rm), np.asarray(rc)
    assert gm.shape == rm.shape and gm.dtype == np.int32
    for b in range(gm.shape[0]):
        assert_same_partition(gm[b], rm[b], gc[b], rc[b])
        assert gm[b].max() == rm[b].max()
        np.testing.assert_array_equal(gc[b], rc[b])


def test_e2e_exact_mode_matches_reference(weights):
    """A 256x512 crop across several instances, decoded at 128x256."""
    img = _crop("bench_img.png", slice(128, 384), slice(256, 768))[None]
    ref = jax_e2e(get_model(9, 10, "pspfpnet"), 9, OFFSETS,
                  decode_size=(128, 256), decode_mode="exact")
    x = img.astype(np.float32) / 256.0
    rm, rc = ref(weights, jnp.asarray(x))
    infer = build_e2e_infer(_port_model(weights), 9, OFFSETS,
                            decode_size=(128, 256), decode_mode="exact",
                            device="cpu")
    gm, gc = infer(x)
    assert gm.shape == (1, 256, 512)
    _assert_same_masks(gm, gc, rm, rc)
    assert int(gm.max()) >= 3


@pytest.mark.parametrize("hier_kwargs,overflows", [(TIGHT, True),
                                                   (None, False)])
def test_serving_pipeline_matches_reference(weights, imgs, hier_kwargs,
                                            overflows):
    x = imgs.astype(np.float32) / 256.0
    mesh = make_mesh(data=1, devices=jax.devices()[:1])
    ref = jax_serving(get_model(9, 10, "pspfpnet"), 9, OFFSETS, mesh,
                      decode_size=(64, 128), hier_kwargs=hier_kwargs,
                      overflow_fallback=True)
    rm, rc, rov = ref(weights, jnp.asarray(x))
    serve = build_serving_pipeline(_port_model(weights), 9, OFFSETS,
                                   decode_size=(64, 128),
                                   hier_kwargs=hier_kwargs,
                                   overflow_fallback=True, device="cpu")
    gm, gc, gov = serve(x)
    assert gm.shape == (2, 128, 256)
    np.testing.assert_array_equal(gov.numpy(), np.asarray(rov))
    assert (gov.numpy() > 0).all() == overflows
    assert (gov.numpy() == 0).all() == (not overflows)
    _assert_same_masks(gm, gc, rm, rc)
    assert int(gm.max()) >= 2
    if not overflows:  # in budget: the fast path's masks, untouched
        plain = build_serving_pipeline(_port_model(weights), 9, OFFSETS,
                                       decode_size=(64, 128), device="cpu")
        pm, pc = plain(x)
        assert torch.equal(pm, gm) and torch.equal(pc, gc)


def test_serving_fallback_is_the_exact_decode(weights, imgs):
    """A flagged frame's served mask is `run_segmentation_device`'s exact
    decode of that frame's probabilities, upsampled (the fallback
    contract), independently of the reference."""
    from mergenet_tpu_torch.decoder.device import run_segmentation_device
    from mergenet_tpu_torch.e2e import upsample_nearest
    from mergenet_tpu_torch.models import probs_at

    model = _port_model(weights)
    x = imgs[1:].astype(np.float32) / 256.0
    serve = build_serving_pipeline(model, 9, OFFSETS, decode_size=(64, 128),
                                   hier_kwargs=TIGHT,
                                   overflow_fallback=True, device="cpu")
    gm, gc, gov = serve(x)
    assert int(gov[0]) > 0
    small = probs_at(model, torch.from_numpy(x), (64, 128))[0]
    em, ecls = run_segmentation_device(
        small[..., :9].movedim(-1, 0), small[..., 9:].movedim(-1, 0), 9,
        OFFSETS, mode="exact", merge_logprob_bias=0.03, device="cpu")
    np.testing.assert_array_equal(
        gm[0].numpy(), upsample_nearest(torch.from_numpy(em),
                                        (128, 256)).numpy())
    assert gc[0, :len(ecls)].tolist() == ecls
    assert (gc[0, len(ecls):] == -1).all()


def test_serving_rejects_uint8_and_defaults_to_the_card(imgs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serving_pipeline(PSPFPNet(19), 9, OFFSETS)
    serve = build_serving_pipeline(PSPFPNet(19), 9, OFFSETS, device="cpu")
    with pytest.raises(ValueError, match="float"):
        serve(imgs)
