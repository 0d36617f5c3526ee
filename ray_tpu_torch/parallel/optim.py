"""Optimizers with optax's signatures and defaults.

``create_train_state`` takes an optimizer as a factory ``params ->
torch.optim.Optimizer``; the factories here build one over the leaves of a
param tree and set every hyperparameter explicitly, because PyTorch's
defaults are not optax's (``torch.optim.AdamW`` decays weights by 1e-2 by
default, ``optax.adamw`` by 1e-4; ``torch.optim.Adafactor`` is another
algorithm than ``optax.adafactor``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.parallel.sharding import as_replicated


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


class _ClipAdam(torch.optim.Adam):
    """``optax.chain(clip_by_global_norm(max_norm), adam(lr))``: the grads
    of all the leaves are scaled by ``max_norm / norm`` when their fp32
    global norm is at least ``max_norm`` (optax's ``trigger``, with no
    epsilon: ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm),
    then Adam with bias correction and eps outside the square root, which
    is torch's ``Adam`` with ``weight_decay=0``."""

    def __init__(self, params, lr, max_norm, betas, eps):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=0.0, amsgrad=False, maximize=False)
        self.max_norm = max_norm

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("clip_adam takes no closure")
        grads = [p.grad for group in self.param_groups
                 for p in group["params"] if p.grad is not None]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if isinstance(norm, DTensor):
            norm = norm.full_tensor()
        norm = norm.item()
        if norm >= self.max_norm:
            for g in grads:
                g.mul_(self.max_norm / norm)
        return super().step()


def clip_adam(learning_rate: float, max_norm: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8
              ) -> Callable[[Any], torch.optim.Optimizer]:
    """``optax.chain(optax.clip_by_global_norm(max_norm),
    optax.adam(learning_rate))``, the RL learners' optimizer: a factory
    ``params -> torch.optim.Optimizer`` (:class:`_ClipAdam`)."""
    def make(params: Any) -> torch.optim.Optimizer:
        return _ClipAdam(tree_leaves(params), learning_rate, max_norm,
                         (b1, b2), eps)
    return make


def factored_dims(shape: Tuple[int, ...], factored: bool = True,
                  min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the (second-largest, largest) axes of the
    whole leaf, or ``None`` when the leaf has rank < 2 or its second-largest
    dim is under ``min_dim_size_to_factor``. For a layer-stacked leaf these
    need not be the last two (``wq`` [L, 2048, 16, 128] factors over
    (3, 1)). Ties go as numpy's argsort orders them, as in optax."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements (DTensors on a mesh: a
    row or column mean of a sharded grad into its replicated moment)."""
    if isinstance(like, DTensor) and t.placements != like.placements:
        return t.redistribute(like.device_mesh, like.placements)
    return t


def _rms(t: torch.Tensor) -> torch.Tensor:
    """The root mean square of a whole leaf, fp32, as a 0-dim tensor."""
    return torch.linalg.vector_norm(t, dtype=torch.float32) / math.sqrt(
        t.numel())


class _Adafactor(torch.optim.Optimizer):
    """optax 0.2.6's ``adafactor`` chain, one leaf at a time: factored
    second-moment scaling, block-RMS clipping, the learning rate, the
    parameter-RMS scale, momentum, weight decay, and the descent sign. State
    (``v_row``/``v_col`` or ``v``, ``ema``) is fp32 whatever the param
    type. For a DTensor param, ``v`` and ``ema`` take its placements and
    ``v_row``/``v_col`` are replicated."""

    def __init__(self, params, lr, min_dim_size_to_factor, decay_rate,
                 decay_offset, multiply_by_parameter_scale,
                 clipping_threshold, momentum, weight_decay_rate, eps,
                 factored):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor,
            decay_rate=decay_rate, decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            weight_decay_rate=weight_decay_rate, eps=eps, factored=factored))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("adafactor takes no closure")
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group)

    def _update(self, p: torch.Tensor, group) -> None:
        st = self.state[p]
        dims = factored_dims(tuple(p.shape), group["factored"],
                             group["min_dim_size_to_factor"])
        if not st:
            st["step"] = 0
            # shaped like p: p's placements on a mesh; the factored moments
            # are of lower rank and replicated, as the JAX rule places them
            if dims is None:
                st["v"] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = dims
                f32 = dict(dtype=torch.float32, device=p.device)
                st["v_row"] = as_replicated(torch.zeros(
                    [n for i, n in enumerate(p.shape) if i != d0], **f32), p)
                st["v_col"] = as_replicated(torch.zeros(
                    [n for i, n in enumerate(p.shape) if i != d1], **f32), p)
            if group["momentum"] is not None:
                st["ema"] = torch.zeros_like(p, dtype=torch.float32)
        # the decay 1 - t**-decay_rate, t counted from 1 at the first update
        # (in fp32, as optax's _decay_rate_pow)
        t = np.float32(st["step"] - group["decay_offset"] + 1)
        decay = float(np.float32(1.0) - t ** np.float32(-group["decay_rate"]))
        g = p.grad.float()
        grad_sqr = g * g + group["eps"]
        if dims is None:
            v = st["v"].mul_(decay).add_(grad_sqr, alpha=1.0 - decay)
            u = g * v.rsqrt()
        else:
            d1, d0 = dims
            v_row = st["v_row"].mul_(decay).add_(
                _placed_as(grad_sqr.mean(dim=d0), st["v_row"]),
                alpha=1.0 - decay)
            v_col = st["v_col"].mul_(decay).add_(
                _placed_as(grad_sqr.mean(dim=d1), st["v_col"]),
                alpha=1.0 - decay)
            row_col_mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1,
                                      keepdim=True)
            u = (g * (v_row / row_col_mean).rsqrt().unsqueeze(d0)
                 * v_col.rsqrt().unsqueeze(d1))
        del grad_sqr
        if group["clipping_threshold"] is not None:
            u.div_(torch.clamp_min(_rms(u) / group["clipping_threshold"],
                                   1.0))
        u.mul_(group["lr"])
        if group["multiply_by_parameter_scale"]:
            u.mul_(torch.clamp_min(_rms(p), 1e-3))
        if group["momentum"] is not None:
            u = st["ema"].mul_(group["momentum"]).add_(
                u, alpha=1.0 - group["momentum"])
        if group["weight_decay_rate"] is not None:
            u = u.add(p.float(), alpha=group["weight_decay_rate"])
        p.sub_(u)
        st["step"] += 1


def adafactor(learning_rate: float, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, decay_offset: int = 0,
              multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0,
              momentum: Optional[float] = None,
              weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
              factored: bool = True
              ) -> Callable[[Any], torch.optim.Optimizer]:
    """``optax.adafactor`` (optax 0.2.6): per leaf, with ``g`` its gradient
    and ``t`` the update count from 1,

    - second moment of ``g**2 + eps`` with decay ``1 - t**-decay_rate``:
      factored into row and column means over the leaf's two largest axes
      (:func:`factored_dims`), else kept whole; ``u = g / sqrt(v)``;
    - ``u /= max(1, rms(u) / clipping_threshold)``, the RMS of the whole
      leaf (all layers of a stacked one);
    - ``u *= learning_rate``, then ``u *= max(rms(p), 1e-3)``;
    - optional momentum (an EMA without debiasing) and weight decay
      (``u += weight_decay_rate * p``); then ``p -= u``.

    Returns a factory ``params -> torch.optim.Optimizer`` for
    ``create_train_state``. Schedules and optax's ``weight_decay_mask`` and
    ``dtype_momentum`` are not taken."""
    def make(params: Any) -> torch.optim.Optimizer:
        return _Adafactor(
            tree_leaves(params), learning_rate, min_dim_size_to_factor,
            decay_rate, decay_offset, multiply_by_parameter_scale,
            clipping_threshold, momentum, weight_decay_rate, eps, factored)
    return make
