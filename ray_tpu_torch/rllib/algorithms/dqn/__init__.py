# Copied from ray_tpu/rllib/algorithms/dqn/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig

__all__ = ["DQN", "DQNConfig"]
