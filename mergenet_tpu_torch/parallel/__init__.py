"""Training state and steps of the port (`mergenet_tpu.parallel` is the
reference); one card, data parallelism waits for a later slice."""

from .train import (SGD, TrainState, build_eval_step, build_train_step,
                    build_train_step_compact, create_train_state,
                    make_optimizer, multistep_lr)

__all__ = ["SGD", "TrainState", "make_optimizer", "multistep_lr",
           "build_train_step", "build_train_step_compact",
           "build_eval_step", "create_train_state"]
