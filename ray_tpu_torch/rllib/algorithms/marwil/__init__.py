# Copied from ray_tpu/rllib/algorithms/marwil/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.marwil.marwil import MARWIL, MARWILConfig

__all__ = ["MARWIL", "MARWILConfig"]
