# Copied from ray_tpu/rllib/algorithms/ddpg/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import (
    DDPG, DDPGConfig, TD3, TD3Config)

__all__ = ["DDPG", "DDPGConfig", "TD3", "TD3Config"]
