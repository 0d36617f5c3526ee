# Copied from ray_tpu/rllib/algorithms/r2d2/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.r2d2.r2d2 import (  # noqa: F401
    R2D2, R2D2Config, R2D2Learner, R2D2Module, R2D2ModuleSpec)
