# Copied from ray_tpu/rllib/algorithms/qmix/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.qmix.qmix import QMIX, QMIXConfig

__all__ = ["QMIX", "QMIXConfig"]
