"""Optimizers with optax's signatures and defaults.

``create_train_state`` takes an optimizer as a factory ``params ->
torch.optim.Optimizer``; the factories here build one over the leaves of a
param tree and set every hyperparameter explicitly, because PyTorch's
defaults are not optax's (``torch.optim.AdamW`` decays weights by 1e-2 by
default, ``optax.adamw`` by 1e-4).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch._private.tree import tree_leaves


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> Callable[[Any], torch.optim.Optimizer]:
    """``optax.adamw``: Adam with bias correction and decoupled weight decay,
    p ← p − lr·(m̂ / (√v̂ + eps) + weight_decay·p)."""
    def make(params: Any) -> torch.optim.Optimizer:
        return torch.optim.AdamW(
            tree_leaves(params), lr=learning_rate, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay, amsgrad=False, maximize=False)
    return make
