# Copied from ray_tpu/rllib/algorithms/dreamerv3/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.dreamerv3.dreamerv3 import (
    DreamerV3, DreamerV3Config)

__all__ = ["DreamerV3", "DreamerV3Config"]
