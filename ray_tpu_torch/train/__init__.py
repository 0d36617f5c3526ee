# Ported from ray_tpu/train/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""ray_tpu_torch.train — distributed training orchestration on the port's
runtime (reference: python/ray/train/__init__.py).

Port of ``ray_tpu/train``: ``TorchTrainer`` (the counterpart of
``JaxTrainer``) runs the user's loop in a group of worker actors, each
holding a GPU unless ``ScalingConfig(use_gpu=False)``, joined by
``torch.distributed`` (NCCL on the cards, gloo on the CPU); the loop reports
metrics and checkpoints with :func:`report`, and a later ``fit`` resumes
from a checkpoint. ``save_pytree`` / ``load_pytree`` keep tensor trees as
host data; ``ParamsPredictor`` runs params from a checkpoint. The
trainers' ``datasets=`` are split over the workers (``DataConfig``), each
worker reads its shard with :func:`get_dataset_shard`, and
``BatchPredictor`` maps a predictor over a ``ray_tpu_torch.data`` Dataset.

Not ported yet (ROADMAP Queue 1): Tune, sharded checkpoints, and
``accelerate``, ``gbdt`` and ``huggingface``.
"""

from typing import Dict, Optional

from ray_tpu_torch.air.config import (
    CheckpointConfig, FailureConfig, RunConfig, ScalingConfig)
from ray_tpu_torch.train._checkpoint import (
    Checkpoint, InStoreCheckpoint, load_pytree, save_pytree)
from ray_tpu_torch.train._internal.session import (
    TrainContext, get_session, in_session)
from ray_tpu_torch.train.base_trainer import (
    BaseTrainer, Result, TrainingFailedError)
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.predictor import (
    BatchPredictor, ParamsPredictor, Predictor, TorchPredictor)
from ray_tpu_torch.train.torch.config import TorchConfig
from ray_tpu_torch.train.torch.torch_trainer import TorchTrainer


def report(metrics: Dict, *, checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (+ optional checkpoint) from within a train loop
    (reference: ray.train.report, _internal/session.py:654)."""
    get_session().report(metrics, checkpoint)


def get_context() -> TrainContext:
    return TrainContext()


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_dataset_shard(name: str = "train"):
    return get_session().get_dataset_shard(name)


__all__ = [
    "BaseTrainer", "Checkpoint", "CheckpointConfig", "DataParallelTrainer",
    "FailureConfig", "InStoreCheckpoint", "TorchConfig", "TorchTrainer",
    "Result", "RunConfig",
    "ScalingConfig", "TrainContext", "TrainingFailedError", "get_checkpoint",
    "get_context", "get_dataset_shard", "report", "save_pytree",
    "load_pytree",
    "Predictor", "ParamsPredictor", "TorchPredictor", "BatchPredictor",
]
