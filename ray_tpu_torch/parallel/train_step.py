"""Train and eval step builders on one device.

Port of ``ray_tpu/parallel/train_step.py``: the framework owns the step,
loss → grad → optimizer update. PyTorch runs eagerly, so there is nothing to
jit; the optimizer updates the params in place (where the JAX step donates
its input state and returns new arrays), which saves a second copy of the
params and the moments. Gradient accumulation is a loop over microbatches.

The mesh and the shardings of the JAX builders (``mesh``,
``state_shardings``, ``rules``, ``batch_logical_axes``,
``frozen_logical_axes``) wait for the multi-GPU slice.

Usage::

    state = create_train_state(lambda g: init_lora(cfg, lcfg, g, g.device),
                               adamw(1e-4), seed=1)
    step = make_train_step(
        lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg),
        adamw(1e-4), frozen=base)
    state, metrics = step(state, {"inputs": x, "targets": y})
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map

Optimizer = Callable[[Any], torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    """The step count, the params (a tree of leaf tensors that require
    grad) and the optimizer built over them, which holds the moments."""
    step: int
    params: Any
    opt_state: torch.optim.Optimizer


def create_train_state(init_fn: Callable[[torch.Generator], Any],
                       tx: Optimizer, *,
                       device: Optional[Union[str, torch.device]] = None,
                       seed: int = 0) -> TrainState:
    """``init_fn(generator)`` draws the params from a generator seeded with
    ``seed`` on ``device`` (``None`` is the CUDA card); they become leaves
    that require grad, and ``tx(params)`` builds the optimizer over them."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tree_map(
        lambda t: t.detach().to(dev).requires_grad_(True), init_fn(gen))
    return TrainState(step=0, params=params, opt_state=tx(params))


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the fp32 L2 norm of all the tensors together."""
    total = sum((t.float() ** 2).sum() for t in tensors)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _microbatches(batch: Dict[str, Any], n: int):
    """Split the leading (batch) dim into n equal consecutive parts, as the
    JAX step's reshape to (n, B / n) does."""
    if n == 1:
        return [batch]
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1 or next(iter(sizes)) % n:
        raise ValueError(f"batch sizes {sorted(sizes)} do not split into "
                         f"{n} microbatches")
    return [{k: v.chunk(n)[i] for k, v in batch.items()} for i in range(n)]


def make_train_step(loss_fn: Callable[..., torch.Tensor], tx: Optimizer, *,
                    grad_accum: int = 1, frozen: Any = None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    With ``grad_accum > 1`` the batch's leading dim is split into
    microbatches; their losses and grads are summed, then divided by
    ``grad_accum``, and the params are updated once. ``frozen`` (optional)
    is a tree of params that are not trained (a LoRA run's base model),
    passed to ``loss_fn(params, batch, frozen)`` as an argument. Metrics:
    ``loss`` (the mean over microbatches) and ``grad_norm`` (the fp32 global
    norm of the averaged grads, before the update) as 0-dim device tensors,
    and ``step``, the new step count. ``tx`` is accepted for the JAX
    signature's sake: the optimizer that updates is the state's."""
    del tx  # the state's optimizer, built by create_train_state, updates

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = tree_leaves(state.params)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss_sum = None
        for mb in _microbatches(batch, grad_accum):
            loss = (loss_fn(state.params, mb) if frozen is None
                    else loss_fn(state.params, mb, frozen))
            loss.backward()  # sums into .grad across microbatches
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
        for p in leaves:
            if p.grad is None:  # unused by the loss: a zero grad, as in JAX
                p.grad = torch.zeros_like(p)
            elif grad_accum > 1:
                p.grad.div_(grad_accum)
        gnorm = global_norm(p.grad for p in leaves)
        opt.step()
        new_state = TrainState(step=state.step + 1, params=state.params,
                               opt_state=opt)
        return new_state, {"loss": loss_sum / grad_accum,
                           "grad_norm": gnorm, "step": new_state.step}

    return step


def make_eval_step(loss_fn: Callable[[Any, Dict[str, Any]], torch.Tensor]):
    """Returns ``step(params, batch) -> loss``, without grad."""
    def step(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)
    return step
