"""Training state, steps and the device mesh of the port
(`mergenet_tpu.parallel` is the reference): one card, or one rank per
card over a `torch.distributed` process group (`mesh.py`), with the
batch over the data axis and the image height over the spatial axis
(`halo.py`)."""

from .mesh import Mesh, data_axis_for_batch, make_mesh, shard_batch
from .train import (SGD, TrainState, build_eval_step, build_train_step,
                    build_train_step_compact, create_train_state,
                    make_optimizer, multistep_lr)

__all__ = ["Mesh", "make_mesh", "data_axis_for_batch", "shard_batch",
           "SGD", "TrainState", "make_optimizer", "multistep_lr",
           "build_train_step", "build_train_step_compact",
           "build_eval_step", "create_train_state"]
