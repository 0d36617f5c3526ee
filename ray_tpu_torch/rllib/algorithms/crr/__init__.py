# Copied from ray_tpu/rllib/algorithms/crr/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.crr.crr import CRR, CRRConfig

__all__ = ["CRR", "CRRConfig"]
