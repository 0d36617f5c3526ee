# Copied from ray_tpu/rllib/algorithms/bc/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.bc.bc import BC, BCConfig

__all__ = ["BC", "BCConfig"]
