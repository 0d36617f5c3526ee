"""ray_tpu_torch.parallel — the train step (port of ``ray_tpu.parallel``).

One device for now: the mesh, the shardings and the pipeline wait for the
multi-GPU slice."""

from ray_tpu_torch.parallel.optim import adafactor, adamw
from ray_tpu_torch.parallel.train_step import (
    TrainState, create_train_state, make_eval_step, make_train_step)

__all__ = ["TrainState", "adafactor", "adamw", "create_train_state",
           "make_eval_step", "make_train_step"]
