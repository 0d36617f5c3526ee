# Ported from ray_tpu/train/predictor.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Predictors (reference: python/ray/train/predictor.py Predictor ABC —
load a checkpoint once, predict on column batches).

Port of ``ray_tpu/train/predictor.py``. ``ParamsPredictor`` is the
counterpart of the JAX package's flagship ``JaxPredictor``: a pure
``apply_fn(params, batch)`` on tensors on the predictor's device, host
numpy in and out. ``BatchPredictor`` maps a predictor over a
``ray_tpu_torch.data`` Dataset in an actor pool, a card per actor with
``num_gpus=1`` (the reference's ``num_tpus``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type, Union

import numpy as np

from ray_tpu_torch.train._checkpoint import Checkpoint, load_pytree


class Predictor:
    """One loaded model; predicts on column-batches (dict of numpy)."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _host_numpy(out) -> np.ndarray:
    """A tensor's values as host numpy (bf16, which numpy lacks, as fp32)."""
    import torch

    out = out.detach().cpu()
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.numpy()


class ParamsPredictor(Predictor):
    """Predictor over a pure ``apply_fn(params, batch_tensor) -> tensor``:
    the port of ``JaxPredictor``.

    The params are a tree of tensors on ``device`` (``None`` is the CUDA
    card; pass ``device="cpu"`` for the CPU); ``apply_fn`` is passed by the
    caller (models are code, checkpoints are data). Each batch's
    ``feature_column`` goes to the device, ``apply_fn`` runs under
    ``torch.no_grad()``, and the prediction comes back as host numpy under
    ``output_column``.
    """

    def __init__(self, params: Any, apply_fn: Callable,
                 feature_column: str = "features",
                 output_column: str = "predictions",
                 device: Optional[Union[str, Any]] = None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch._private.tree import tree_map

        self.device = resolve_device(device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.feature_column = feature_column
        self.output_column = output_column
        self._apply = apply_fn

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable, name: str = "params",
                        feature_column: str = "features",
                        output_column: str = "predictions",
                        device: Optional[Union[str, Any]] = None
                        ) -> "ParamsPredictor":
        """Load the tree ``save_pytree`` wrote under ``name`` in the
        checkpoint: the params, or a train state whose ``"params"`` entry
        they are."""
        from ray_tpu_torch._private.device import resolve_device

        dev = resolve_device(device)
        with checkpoint.as_directory() as d:
            state = load_pytree(d, name, device=dev)
        params = state["params"] if isinstance(state, dict) \
            and "params" in state else state
        return cls(params, apply_fn, feature_column=feature_column,
                   output_column=output_column, device=dev)

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        x = torch.as_tensor(np.asarray(batch[self.feature_column]),
                            device=self.device)
        with torch.no_grad():
            out = self._apply(self.params, x)
        result = dict(batch)
        result[self.output_column] = _host_numpy(out)
        return result


class TorchPredictor(Predictor):
    """torch.nn.Module inference (reference: train/torch/torch_predictor.py);
    the checkpoint holds {"model_state": state_dict} and the caller
    supplies the module factory. The model runs on ``device`` (``None`` is
    the CUDA card; pass ``device="cpu"`` for the CPU)."""

    def __init__(self, model, feature_column: str = "features",
                 output_column: str = "predictions",
                 device: Optional[Union[str, Any]] = None):
        import torch

        from ray_tpu_torch._private.device import resolve_device

        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.feature_column = feature_column
        self.output_column = output_column
        self._torch = torch

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        model_factory: Callable,
                        feature_column: str = "features",
                        output_column: str = "predictions",
                        device: Optional[Union[str, Any]] = None
                        ) -> "TorchPredictor":
        model = model_factory()
        state = checkpoint.to_dict()
        if "model_state" in state:
            model.load_state_dict(state["model_state"])
        return cls(model, feature_column=feature_column,
                   output_column=output_column, device=device)

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        torch = self._torch
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(batch[self.feature_column]),
                                device=self.device)
            out = _host_numpy(self.model(x))
        result = dict(batch)
        result[self.output_column] = out
        return result


class _PredictorCallable:
    """Actor-pool callable for map_batches: builds the predictor ONCE in
    the replica's constructor from the shipped checkpoint. Dict-backed
    checkpoints travel by value (cluster-safe); directory checkpoints
    travel by path (shared-filesystem deployments, the reference's
    storage-path model)."""

    def __init__(self, predictor_cls, shipped, from_checkpoint_kwargs: Dict):
        kind, payload = shipped
        ckpt = (Checkpoint.from_dict(payload) if kind == "dict"
                else Checkpoint.from_directory(payload))
        self.predictor = predictor_cls.from_checkpoint(
            ckpt, **from_checkpoint_kwargs)

    def __call__(self, batch):
        return self.predictor.predict(batch)


def _ship_checkpoint(checkpoint: Checkpoint):
    import os

    if os.path.exists(os.path.join(checkpoint.path, "_dict.pkl")):
        return ("dict", checkpoint.to_dict())
    return ("path", checkpoint.path)


class BatchPredictor:
    """Checkpoint + predictor class → scalable Dataset inference
    (reference: train/batch_predictor.py:40). The predictor runs in an
    actor pool of ``concurrency`` actors; ``num_gpus=1`` gives each actor
    a card (a predictor that defaults to the card, as ``ParamsPredictor``
    does, runs there)."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **from_checkpoint_kwargs):
        self.checkpoint = checkpoint
        self.predictor_cls = predictor_cls
        self.from_checkpoint_kwargs = from_checkpoint_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **kwargs)

    def predict(self, dataset, *, batch_size: int = 256,
                concurrency: int = 2, num_cpus: Optional[float] = None,
                num_gpus: Optional[float] = None):
        """Lazy: returns the mapped Dataset; iterate/materialize to run."""
        return dataset.map_batches(
            _PredictorCallable,
            batch_size=batch_size,
            fn_constructor_args=(self.predictor_cls,
                                 _ship_checkpoint(self.checkpoint),
                                 self.from_checkpoint_kwargs),
            concurrency=concurrency,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
        )
