# Copied from ray_tpu/rllib/algorithms/a2c/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.a2c.a2c import A2C, A2CConfig

__all__ = ["A2C", "A2CConfig"]
