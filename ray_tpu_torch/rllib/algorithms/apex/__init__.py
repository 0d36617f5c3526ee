# Copied from ray_tpu/rllib/algorithms/apex/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.apex.apex import ApexDQN, ApexDQNConfig

__all__ = ["ApexDQN", "ApexDQNConfig"]
