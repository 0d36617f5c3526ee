# Copied from ray_tpu/rllib/algorithms/appo/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.appo.appo import APPO, APPOConfig

__all__ = ["APPO", "APPOConfig"]
