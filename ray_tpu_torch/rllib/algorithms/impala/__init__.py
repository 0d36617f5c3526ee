# Copied from ray_tpu/rllib/algorithms/impala/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.impala.impala import IMPALA, IMPALAConfig

__all__ = ["IMPALA", "IMPALAConfig"]
