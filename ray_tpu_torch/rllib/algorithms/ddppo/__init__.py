# Copied from ray_tpu/rllib/algorithms/ddppo/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.ddppo.ddppo import DDPPO, DDPPOConfig

__all__ = ["DDPPO", "DDPPOConfig"]
