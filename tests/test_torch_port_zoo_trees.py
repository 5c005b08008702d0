"""Every arch of the port's zoo has the Flax model's parameter tree:
`convert.state_dict_to_flax` of the port's `get_model(arch)` has exactly
the paths and shapes of the JAX package's `get_model(arch)` init trees
(params and batch_stats), taken with `jax.eval_shape` (a trace, no
compile), so `convert.load_flax_weights` carries every checkpoint across
strictly.  Tracing all 23 names costs ~45 s here, so the cases cover
every ResNet depth (18/34/50/101/152: the BasicBlock and Bottleneck
tables), every FCN scale on both backbones, and every other family
once.  The vgg16 archs are left to `test_torch_port_zoo.py`: their
narrow twins' forwards through the Flax module check the same tree
(only the widths scale), and `test_get_model_passes_model_kwargs_through`
which score heads each scale has."""

import jax
import jax.numpy as jnp
import pytest
import torch

from mergenet_tpu.models import get_model as jget_model
from mergenet_tpu_torch.convert import state_dict_to_flax
from mergenet_tpu_torch.models import VALID_ARCHS, get_model

ARCHS = ["fcn8_resnet18", "fcn16_resnet34", "fcn32_resnet50",
         "fcn16_resnet101", "fcn8_resnet152",
         "unet", "unet_small", "pspnet", "pspfpnet", "upernet"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "keys"):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_matches_flax(arch):
    assert arch in VALID_ARCHS
    jm = jget_model(9, 10, arch, verbose=False)
    ref = jax.eval_shape(lambda k: jm.init(
        {"params": k, "dropout": k}, jnp.zeros((1, 64, 64, 3)),
        train=False), jax.random.PRNGKey(0))
    params, stats = state_dict_to_flax(get_model(9, 10, arch))
    assert _shapes(params) == _shapes(ref["params"])
    assert _shapes(stats) == _shapes(ref.get("batch_stats", {}))
