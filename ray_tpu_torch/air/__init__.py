# Ported from ray_tpu/air/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""ray_tpu_torch.air — shared configs for Train (reference:
python/ray/air/__init__.py). The JAX package's ``air.integrations`` needs
Tune, which the port has not copied yet (ROADMAP Queue 1)."""

from ray_tpu_torch.air.config import (
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig)

__all__ = ["CheckpointConfig", "FailureConfig", "RunConfig",
           "ScalingConfig"]
