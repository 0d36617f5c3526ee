# Copied from ray_tpu/rllib/algorithms/sac/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.sac.sac import SAC, SACConfig

__all__ = ["SAC", "SACConfig"]
