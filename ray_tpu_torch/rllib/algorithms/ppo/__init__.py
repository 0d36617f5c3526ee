# Copied from ray_tpu/rllib/algorithms/ppo/__init__.py (ray_tpu -> ray_tpu_torch).
from ray_tpu_torch.rllib.algorithms.ppo.multi_agent import (
    MultiAgentPPO, MultiAgentPPOConfig)
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig

__all__ = ["PPO", "PPOConfig", "MultiAgentPPO", "MultiAgentPPOConfig"]
