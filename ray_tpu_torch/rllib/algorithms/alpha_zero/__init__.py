# Copied from ray_tpu/rllib/algorithms/alpha_zero/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.alpha_zero.alpha_zero import (
    MCTS, AlphaZero, AlphaZeroConfig)

__all__ = ["AlphaZero", "AlphaZeroConfig", "MCTS"]
