# Copied from ray_tpu/rllib/algorithms/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig

__all__ = ["Algorithm", "AlgorithmConfig"]
