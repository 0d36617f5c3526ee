# Copied from ray_tpu/rllib/algorithms/maddpg/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.maddpg.maddpg import (  # noqa: F401
    MADDPG, MADDPGConfig)
