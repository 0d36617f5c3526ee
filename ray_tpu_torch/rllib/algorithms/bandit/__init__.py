# Copied from ray_tpu/rllib/algorithms/bandit/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.bandit.bandit import (  # noqa: F401
    BanditLinTS, BanditLinTSConfig, BanditLinUCB, BanditLinUCBConfig)
