# Ported from ray_tpu/train/base_trainer.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""BaseTrainer + Result (reference: python/ray/train/base_trainer.py —
fit :581; in the reference, fit wraps the trainer as a Tune Trainable
:700,844).

Here ``fit()`` sets up experiment/trial dirs and calls the subclass's
``training_loop()`` directly; ``ray_tpu_torch.tune`` reuses trainers through the
same ``training_loop()`` entry point when sweeping (Trainable wrapping
lives on the Tune side).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.air.config import (
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.train._checkpoint import Checkpoint


class TrainingFailedError(RuntimeError):
    pass


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    path: str
    error: Optional[Exception] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: Optional[list] = None
    # the trial's hyperparameter config (reference: Result.config)
    config: Optional[Dict[str, Any]] = None
    # worker-group restarts the elastic recovery loop performed; 0 on a
    # clean run (mirrors ray_tpu_torch_train_restarts_total for this trial)
    restarts: int = 0


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    # Subclasses implement the actual training drive loop.
    def training_loop(self) -> Result:
        raise NotImplementedError

    def fit(self) -> Result:
        from ray_tpu_torch._private.storage import (
            get_storage_backend, is_remote_uri, join_uri, local_path)

        name = self.run_config.name or f"train_{int(time.time())}"
        storage = self.run_config.resolved_storage_path()
        if is_remote_uri(storage):
            trial_dir = join_uri(storage, name)
            get_storage_backend(trial_dir).makedirs(trial_dir)
        else:
            trial_dir = os.path.join(local_path(storage), name)
            os.makedirs(trial_dir, exist_ok=True)
        self._experiment_name = name
        self._storage_path = storage
        self._trial_dir = trial_dir
        return self.training_loop()
