# Copied from ray_tpu/rllib/algorithms/ars/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.ars.ars import ARS, ARSConfig

__all__ = ["ARS", "ARSConfig"]
