"""The slice as a whole: `e2e.build_e2e_infer` of the port (float image
-> PSPFPNet-r50 logits at the decode size -> `decode_hierarchical` ->
nearest upsample) against the reference's `utils/e2e.py` hier mode, with
the committed trained weights on a committed val image, float32 on the
CPU.  Both entry points take the same float images as given: the /256
RGB of `AllDataset`, and the caffe-style mean-subtracted BGR of
`ClassDataset(caffe=True)` (`mergenet_tpu/data/dataset.py`).

The two nets' logits differ by float32 summation order only, far inside
every decode threshold here, so the served masks must be the same
partition up to renaming, with equal instance classes.  The logits the
port's entry computed (caught by a forward hook on its net) are also
held against the reference net's on the same floats, to LOGIT_RTOL of
their largest magnitude: the caffe-style input is decoded as all
background, so only its logits show that the entry fed the floats to
the net as given."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mergenet_tpu.models import get_model, logits_at
from mergenet_tpu.utils.e2e import build_e2e_infer as jax_build
from mergenet_tpu_torch import io as TIO
from mergenet_tpu_torch.convert import load_flax_weights
from mergenet_tpu_torch.e2e import build_e2e_infer
from mergenet_tpu_torch.models import PSPFPNet
from torch_port_helpers import FIX512, assert_same_partition


#: the reference's caffe-mode pixel mean (RGB), `data/dataset.py`
CAFFE_MEAN_RGB = np.array([123.68, 116.779, 103.939])
#: logits' max abs error over their max magnitude: test_torch_port_net's
#: 1e-3 on logits of magnitude ~10 (measured here: 4.5e-6 on /256 floats,
#: 1.4e-6 on caffe-style floats whose logits reach ~5e3)
LOGIT_RTOL = 1e-4


@pytest.fixture(scope="module")
def frame_pair():
    """(reference infer and net logits with their variables, port infer
    and its net, the uint8 val image, the port's results by input): one
    reference jit and one port forward for every float input of this
    shape."""
    p, b = TIO.load_bench_checkpoint(os.path.join(FIX512, "bench_ckpt.npz"))
    p, b = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  (p, b))
    offsets = TIO.load_offsets(FIX512)
    img = TIO.read_png_rgb(os.path.join(FIX512, "bench_img.png"))[None]
    size = (256, 512)  # decode at half the 512x1024 input, as served
    jm = get_model(9, 10, "pspfpnet")
    ref_infer = jax_build(jm, 9, offsets, decode_size=size)
    ref_logits = jax.jit(lambda v, x: logits_at(jm, v, x, size))
    net = load_flax_weights(PSPFPNet(19), p, b)
    infer = build_e2e_infer(net, 9, offsets, decode_size=size, device="cpu")
    return ((ref_infer, ref_logits, {"params": p, "batch_stats": b}),
            (infer, net), img, {})


def _port_run(frame_pair, x, key):
    """The port's (masks, classes, net logits) for input `x`, computed
    once per key; the logits are the net's output inside the entry (the
    copy of `net` that it runs, `infer.model`)."""
    (infer, net), cache = frame_pair[1], frame_pair[3]
    if key not in cache:
        seen = []
        hook = infer.model.register_forward_hook(
            lambda mod, args, out: seen.append(out.detach().clone()))
        try:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                masks, classes = infer(x)
        finally:
            hook.remove()
        assert len(seen) == 1
        cache[key] = masks, classes, seen[0]
    return cache[key]


def _assert_port_matches_reference(frame_pair, x, key):
    ref_infer, ref_logits, variables = frame_pair[0]
    rm, rc = ref_infer(variables, jnp.asarray(x))
    gm, gc, gl = _port_run(frame_pair, x, key)
    assert gm.shape == (1, 512, 1024) and gc.shape == (1, 8192)
    assert_same_partition(gm[0].numpy(), np.asarray(rm[0]), gc[0].numpy(),
                          np.asarray(rc[0]))
    np.testing.assert_array_equal(gc[0].numpy(), np.asarray(rc[0]))
    rl = np.asarray(ref_logits(variables, jnp.asarray(x)))
    assert gl.shape == rl.shape == (1, 256, 512, 19)
    assert np.abs(gl.numpy() - rl).max() <= LOGIT_RTOL * np.abs(rl).max()
    return gm


def test_served_frame_matches_reference(frame_pair):
    """The /256 RGB floats of `AllDataset`, the served frame's input."""
    img = frame_pair[2]
    gm = _assert_port_matches_reference(
        frame_pair, img.astype(np.float32) / 256.0, "div256")
    assert int(gm.max()) >= 1


def test_caffe_style_frame_matches_reference(frame_pair):
    """Mean-subtracted BGR floats with no scaling, built as
    `ClassDataset(caffe=True)._to_float` builds them: an input that no
    uint8 image divided by 256 can express."""
    img = frame_pair[2][0].astype(np.float32)
    img -= CAFFE_MEAN_RGB[None, None, :]
    x = img[:, :, ::-1].copy()[None].astype(np.float32)
    gm = _assert_port_matches_reference(frame_pair, x, "caffe")
    # the net trained on /256 inputs finds no instance in these, in the
    # reference as in the port (the logits above are what tell the two
    # inputs apart); the /256 frame has some
    g256 = _port_run(frame_pair, frame_pair[2].astype(np.float32) / 256.0,
                     "div256")[0]
    assert not torch.equal(gm, g256)


def test_infer_takes_float_images_as_given(frame_pair):
    """(N, H, W, 3) floats only: a rank-3 image, a wrong channel count
    and uint8 pixels (no implied /256) are refused."""
    infer, img = frame_pair[1][0], frame_pair[2]
    x = img.astype(np.float32) / 256.0
    for bad in (x[0], x[..., :2], img):
        with pytest.raises(ValueError, match="float"):
            infer(bad)


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


def test_builders_leave_the_callers_module_as_it_was():
    """`build_e2e_infer` and `build_serving_pipeline` run a copy of the
    caller's module: after building a bf16 infer on the CPU, every
    parameter and buffer of the caller's model is still float32 and
    unchanged, and the module is still in train mode.  (The CPU has no
    bf16 antialiased resize, so the bf16 infer is built, not run.)"""
    from mergenet_tpu_torch.models import init_model
    from mergenet_tpu_torch.serving import build_serving_pipeline
    from torch_port_helpers import randomize_batch_norm
    model = randomize_batch_norm(init_model(
        PSPFPNet(5, layer=18, fpn_dim=16), 5), 6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    offsets = ((0, 1), (1, 0), (2, 2))
    for build in (build_e2e_infer, build_serving_pipeline):
        fn = build(model, 2, offsets, decode_size=(16, 32),
                   dtype=torch.bfloat16, device="cpu")
        assert fn.model is not model
        assert next(fn.model.parameters()).dtype == torch.bfloat16
        assert model.training
        for k, v in model.state_dict().items():
            assert v.dtype == before[k].dtype, k
            assert torch.equal(v, before[k]), k
        assert all(p.dtype == torch.float32 for p in model.parameters())
