# Copied from ray_tpu/rllib/algorithms/es/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.es.es import ES, ESConfig

__all__ = ["ES", "ESConfig"]
