"""Train and eval step builders, on one device or on a mesh.

Port of ``ray_tpu/parallel/train_step.py``: the framework owns the step,
loss → grad → optimizer update. PyTorch runs eagerly, so there is nothing to
jit; the optimizer updates the params in place (where the JAX step donates
its input state and returns new arrays), which saves a second copy of the
params and the moments. Gradient accumulation is a loop over microbatches.

With a ``mesh`` (a ``DeviceMesh`` from ``parallel.mesh``) the params are
DTensors placed by their logical axes (``logical_axes``, ``rules``), the
batch is sharded by ``batch_logical_axes``, and a frozen base by
``frozen_logical_axes`` (replicated when omitted), as the JAX builders'
shardings place them. DTensor propagates the shardings through the loss; the
step then redistributes each grad to its param's placements (the JAX step's
``out_shardings``), which reduces the partial sums over the batch's axes:
the grads are averaged over the data axis by the step itself. The optimizer
state follows ``_opt_state_shardings``' rule: a state tensor shaped like its
param takes the param's placements, a tensor of lower rank or a scalar is
replicated.

Usage::

    state = create_train_state(lambda g: init_lora(cfg, lcfg, g, g.device),
                               adamw(1e-4), seed=1)
    step = make_train_step(
        lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg),
        adamw(1e-4), frozen=base)
    state, metrics = step(state, {"inputs": x, "targets": y})

On a mesh (in each rank of a process group, e.g. a ``TorchTrainer``
worker)::

    mesh = create_mesh(MeshConfig(data=-1, fsdp=2, tensor=2))
    state = create_train_state(lambda g: init_llama(cfg, g, g.device), tx,
                               mesh, llama_logical_axes(cfg))
    step = make_train_step(lambda p, b: llama_loss(p, b, cfg), tx, mesh,
                           batch_logical_axes=("batch", "seq"))
    state, metrics = step(state, global_batch)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.parallel.sharding import (
    LogicalAxisRules, NamedSharding, PartitionSpec, compat_mesh_ctx,
    logical_to_spec, param_shardings, shard_pytree, shard_tensor)

Optimizer = Callable[[Any], torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    """The step count, the params (a tree of leaf tensors that require
    grad; DTensors on a mesh) and the optimizer built over them, which
    holds the moments."""
    step: int
    params: Any
    opt_state: torch.optim.Optimizer


def _mesh_device(mesh: DeviceMesh, device) -> torch.device:
    dev = resolve_device(device if device is not None
                         else mesh.device_type)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not the mesh's "
                         f"{mesh.device_type}")
    return dev


def _place_params(params: Any, mesh: Optional[DeviceMesh],
                  logical_axes: Any, rules: Optional[LogicalAxisRules]):
    """Full tensors → DTensors by their logical axes (replicated where
    ``logical_axes`` is None); as they are without a mesh."""
    if mesh is None:
        return params
    if logical_axes is None:
        repl = NamedSharding(mesh, PartitionSpec())
        return tree_map(lambda t: shard_tensor(t, repl), params)
    return shard_pytree(params, param_shardings(logical_axes, mesh, rules))


def create_train_state(init_fn: Callable[[torch.Generator], Any],
                       tx: Optimizer, mesh: Optional[DeviceMesh] = None,
                       logical_axes: Any = None, *,
                       rules: Optional[LogicalAxisRules] = None,
                       device: Optional[Union[str, torch.device]] = None,
                       seed: int = 0) -> TrainState:
    """``init_fn(generator)`` draws the params from a generator seeded with
    ``seed`` on ``device`` (``None`` is the CUDA card, or the mesh's device
    type); they become leaves that require grad, and ``tx(params)`` builds
    the optimizer over them. With a ``mesh`` every rank draws the same full
    params and keeps its shards (``logical_axes``: a tree of logical-axis
    tuples; replicated when omitted)."""
    dev = (resolve_device(device) if mesh is None
           else _mesh_device(mesh, device))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _place_params(
        tree_map(lambda t: t.detach().to(dev), init_fn(gen)), mesh,
        logical_axes, rules)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return TrainState(step=0, params=params, opt_state=tx(params))


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the fp32 L2 norm of all the tensors together
    (a replicated 0-dim DTensor for DTensors)."""
    total = sum((t.float() ** 2).sum() for t in tensors)
    if isinstance(total, DTensor):
        return total.sqrt()
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


def _shard_batch(batch: Dict[str, Any], mesh: Optional[DeviceMesh],
                 spec: Optional[PartitionSpec]) -> Dict[str, Any]:
    """The global batch (the same full tensors on every rank) sharded by the
    batch spec, its leading dims as the spec names them; a DTensor is
    redistributed to it."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        sh = NamedSharding(mesh, PartitionSpec(*spec[:v.dim()]))
        if isinstance(v, DTensor):
            out[k] = v.redistribute(mesh, sh.placements)
        else:
            out[k] = shard_tensor(v, sh)
    return out


def _full(x):
    """A replicated DTensor's value as a plain tensor."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(loss_fn: Callable[..., torch.Tensor], tx: Optimizer,
                    mesh: Optional[DeviceMesh] = None, *,
                    rules: Optional[LogicalAxisRules] = None,
                    batch_logical_axes: Tuple[Optional[str], ...] = (
                        "batch", None),
                    grad_accum: int = 1, frozen: Any = None,
                    frozen_logical_axes: Any = None):
    """Returns ``step(state, batch) -> (state, metrics)``.

    With ``grad_accum > 1`` the batch's leading dim is split into
    microbatches; their losses and grads are summed, then divided by
    ``grad_accum``, and the params are updated once. ``frozen`` (optional)
    is a tree of params that are not trained (a LoRA run's base model),
    passed to ``loss_fn(params, batch, frozen)`` as an argument. Metrics:
    ``loss`` (the mean over microbatches) and ``grad_norm`` (the fp32 global
    norm of the averaged grads, before the update) as 0-dim device tensors,
    and ``step``, the new step count. ``tx`` is accepted for the JAX
    signature's sake: the optimizer that updates is the state's.

    With a ``mesh``: the batch is the global batch, the same on every rank
    (or DTensors), sharded by ``batch_logical_axes``; the frozen tree is
    placed once, here, by ``frozen_logical_axes`` (replicated when
    omitted), and the step keeps it as ``step.frozen``; the loss runs with
    the mesh in scope (``compat_mesh_ctx``); each grad is redistributed to
    its param's placements (which the params carry: the JAX builders'
    ``state_shardings`` has no counterpart) before the norm and the
    update."""
    del tx  # the state's optimizer updates
    batch_spec = (logical_to_spec(batch_logical_axes, rules)
                  if mesh is not None else None)
    if mesh is not None and frozen is not None:
        frozen = _place_params(
            tree_map(lambda t: _full(t).detach(), frozen), mesh,
            frozen_logical_axes, rules)

    def grads_of(state: TrainState, batch: Dict[str, Any]):
        if mesh is not None and grad_accum > 1:
            # microbatches are cut from the global batch, then sharded
            batch = {k: _full(v) for k, v in batch.items()}
        loss_sum = None
        for mb in _microbatches(batch, grad_accum):
            mb = _shard_batch(mb, mesh, batch_spec)
            loss = (loss_fn(state.params, mb) if frozen is None
                    else loss_fn(state.params, mb, frozen))
            loss.backward()  # sums into .grad across microbatches
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
        return loss_sum

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = tree_leaves(state.params)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        with compat_mesh_ctx(mesh):
            loss_sum = grads_of(state, batch)
        for p in leaves:
            if p.grad is None:  # unused by the loss: a zero grad, as in JAX
                p.grad = torch.zeros_like(p)
            elif isinstance(p, DTensor) and p.grad.placements != \
                    p.placements:
                # partial sums over the batch's axes reduced, and the grad
                # laid out as its param (what the optimizer needs)
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
            if grad_accum > 1:
                p.grad.div_(grad_accum)
        gnorm = global_norm(p.grad for p in leaves)
        opt.step()
        new_state = TrainState(step=state.step + 1, params=state.params,
                               opt_state=opt)
        return new_state, {"loss": _full(loss_sum / grad_accum),
                           "grad_norm": _full(gnorm), "step": new_state.step}

    step.frozen = frozen  # as placed on the mesh
    return step


def _state_to_host(st: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _full(v) for k, v in st.items()}


def train_state_tree(state: TrainState) -> Dict[str, Any]:
    """The state as a tree for ``save_pytree``: ``{"step": the step count,
    "params": the params, "opt_state": [the optimizer's state of each
    leaf of the params, in tree_leaves order]}`` (AdamW's: its step,
    ``exp_avg`` and ``exp_avg_sq``). DTensors are gathered to full tensors
    (every rank must call this: ``full_tensor`` is a collective). The JAX
    state is a pytree as it stands; this is its counterpart."""
    opt = state.opt_state
    return {"step": state.step,
            "params": tree_map(lambda t: _full(t.detach()), state.params),
            "opt_state": [_state_to_host(opt.state.get(p, {}))
                          for p in tree_leaves(state.params)]}


def _place_state(v, p):
    """An optimizer state value placed for a DTensor param ``p``: shaped
    like ``p`` → ``p``'s placements; a tensor of lower rank or a scalar →
    replicated (the JAX rule, ``_opt_state_shardings``). AdamW's 0-dim step
    count stays a plain tensor, the same on every rank, as AdamW keeps
    it."""
    if not isinstance(v, torch.Tensor) or isinstance(v, DTensor) \
            or v.dim() == 0:
        return v
    mesh = p.device_mesh
    v = v.to(p.to_local().device)
    if tuple(v.shape) == tuple(p.shape):
        return distribute_tensor(v, mesh, p.placements, src_data_rank=None)
    return DTensor.from_local(v, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def load_train_state(tree: Dict[str, Any], tx: Optimizer,
                     mesh: Optional[DeviceMesh] = None,
                     logical_axes: Any = None, *,
                     rules: Optional[LogicalAxisRules] = None,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> TrainState:
    """The :class:`TrainState` that :func:`train_state_tree` took apart:
    the params as leaves that require grad on ``device`` (``None`` is the
    CUDA card, or the mesh's device type), placed by ``logical_axes`` on a
    ``mesh``; ``tx(params)`` as the optimizer, with its per-leaf state put
    back through ``load_state_dict`` (which moves the moments to their
    param's device and leaves AdamW's step count where the optimizer keeps
    it), placed by the optimizer-state rule on a mesh. 0-dim integer leaves
    come back as Python ints."""
    dev = (resolve_device(device) if mesh is None
           else _mesh_device(mesh, device))
    params = _place_params(
        tree_map(lambda t: t.detach().to(dev), tree["params"]), mesh,
        logical_axes, rules)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    leaves = tree_leaves(params)
    opt = tx(params)
    saved = opt.state_dict()
    saved["state"] = {
        i: {k: v.item() if isinstance(v, torch.Tensor) and v.dim() == 0
            and not v.is_floating_point() else v for k, v in st.items()}
        for i, st in enumerate(tree["opt_state"]) if st}
    if mesh is not None:
        saved["state"] = {
            i: {k: _place_state(v, leaves[i]) for k, v in st.items()}
            for i, st in saved["state"].items()}
    opt.load_state_dict(saved)
    return TrainState(step=int(tree["step"]), params=params, opt_state=opt)


def make_eval_step(loss_fn: Callable[[Any, Dict[str, Any]], torch.Tensor],
                   mesh: Optional[DeviceMesh] = None, *,
                   rules: Optional[LogicalAxisRules] = None,
                   batch_logical_axes: Tuple[Optional[str], ...] = (
                       "batch", None)):
    """Returns ``step(params, batch) -> loss``, without grad; on a
    ``mesh`` the batch is sharded as :func:`make_train_step` shards it and
    the loss comes back as a plain 0-dim tensor."""
    batch_spec = (logical_to_spec(batch_logical_axes, rules)
                  if mesh is not None else None)

    def step(params, batch):
        with torch.no_grad(), compat_mesh_ctx(mesh):
            return _full(loss_fn(params, _shard_batch(batch, mesh,
                                                      batch_spec)))
    return step
