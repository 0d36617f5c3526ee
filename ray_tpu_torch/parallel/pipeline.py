"""Pipeline parallelism: a GPipe microbatch schedule over a ``stage`` mesh
axis.

Port of ``ray_tpu/parallel/pipeline.py``. Each rank along ``stage`` holds one
pipeline stage's parameters (the stacked params' leading stage dim, sharded
over the axis); activations flow stage to stage over point-to-point sends on
the axis's sub-group, and the last stage's outputs are broadcast over the
axis, the JAX package's ``psum`` of the masked outputs.

Schedule: GPipe fill/drain. With S stages and M microbatches there are
S+M-1 ticks; at tick t stage s works on microbatch t-s (:func:`gpipe_ticks`).
The JAX package computes the idle ticks (t-s outside [0, M)) on garbage and
masks them out, which keeps its program static; here they are skipped, with
the same results: a stage calls ``stage_fn`` M times a forward, not S+M-1.

The schedule is apart from the transport. :func:`pipeline_apply` without a
mesh runs every stage's ticks in this process, tick by tick (one card holding
every stage), on plain autograd. On a mesh, each rank runs its own stage's
ticks in order inside :class:`_StageTicks`, whose forward receives each
microbatch's input from the previous stage and sends its output to the next,
and whose backward is the transpose: in reverse microbatch order it receives
the output's gradient from the next stage, back-propagates through the
stage, and sends the input's gradient to the previous stage (what XLA derives
from ``ppermute`` for the JAX package). ``torch.distributed``'s sends are
not differentiable, so the backward is written out.

On a mesh with a ``data`` axis as well (DP × PP), each data rank's rows are
its contiguous block of the batch (the batch sharding of
``parallel.train_step``), split into M microbatches. The JAX package cuts
each microbatch from the whole batch first and then shards it over
``data``, so the rows that share a microbatch differ; for a stage function
that treats rows independently (a transformer layer, an MLP) the results are
the same.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor, Partial, Replicate, Shard, distribute_tensor)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import (
    tree_flatten, tree_from_numpy, tree_leaves, tree_map, tree_unflatten)
from ray_tpu_torch.parallel.sharding import PartitionSpec

STAGE_AXIS = "stage"


def num_stages(mesh: DeviceMesh, axis: str = STAGE_AXIS) -> int:
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh {dict(zip(names, mesh.shape))} has no "
                         f"'{axis}' axis")
    return mesh.size(names.index(axis))


def gpipe_ticks(n_stages: int, n_micro: int) -> List[List[Tuple[int, int]]]:
    """GPipe's fill/drain: for each of the S+M-1 ticks, the (stage,
    microbatch) pairs that work in it, stage s on microbatch t-s; the idle
    ones are left out."""
    return [[(s, t - s) for s in range(n_stages) if 0 <= t - s < n_micro]
            for t in range(n_stages + n_micro - 1)]


def _stack(trees: Sequence[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return type(trees[0])(_stack(list(t)) for t in zip(*trees))
    return torch.stack(trees)


def _stage_placements(mesh: DeviceMesh, axis: str) -> Tuple:
    """A stacked leaf's placements: its leading dim on ``axis``, replicated
    over every other mesh dim."""
    return tuple(Shard(0) if n == axis else Replicate()
                 for n in mesh.mesh_dim_names)


def init_stage_params(init_fn: Callable[[torch.Generator], Any],
                      n_stages: int, mesh: Optional[DeviceMesh] = None, *,
                      axis: str = STAGE_AXIS, seed: int = 0,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Any:
    """Per-stage params stacked on a leading stage dim: ``init_fn(generator)``
    called once per stage, in stage order, on one generator seeded with
    ``seed``. The stacked leaves require grad; with a mesh they are
    DTensors sharded over ``axis`` (each stage rank keeps its own stage) and
    replicated over the other axes. ``device`` ``None`` is the CUDA card, or
    the mesh's device type."""
    dev = resolve_device(device if device is not None or mesh is None
                         else mesh.device_type)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stacked = _stack([tree_map(lambda t: t.detach().to(dev), init_fn(gen))
                      for _ in range(n_stages)])
    if mesh is not None:
        if num_stages(mesh, axis) != n_stages:
            raise ValueError(f"{n_stages} stages on a '{axis}' axis of size "
                             f"{num_stages(mesh, axis)}")
        placements = _stage_placements(mesh, axis)
        stacked = tree_map(lambda t: distribute_tensor(
            t, mesh, placements, src_data_rank=None), stacked)
    return tree_map(lambda t: t.requires_grad_(True), stacked)


def stage_params_from_jax(tree: Any) -> Any:
    """The JAX package's stacked stage params (``init_stage_params``'s
    result), as numpy arrays (``jax.tree.map(np.asarray, params)``, done by
    the caller), as CPU tensors in the same layout."""
    return tree_from_numpy(tree)


def stage_param_spec(params_stacked: Any, axis: str = STAGE_AXIS) -> Any:
    """The spec tree for stacked stage params: the leading dim on
    ``axis``."""
    return tree_map(lambda _: PartitionSpec(axis), params_stacked)


def _num_microbatches(batch: int, n_stages: int, data_size: int,
                      num_microbatches: Optional[int]) -> int:
    def valid(m: int) -> bool:
        return batch % m == 0 and (batch // m) % data_size == 0

    if num_microbatches is None:
        # the largest M <= 4*S that divides the batch and leaves each
        # microbatch divisible across the data axes
        m = next((m for m in range(min(4 * n_stages, batch), 0, -1)
                  if valid(m)), 1)
    else:
        m = num_microbatches
    if not valid(m):
        raise ValueError(
            f"batch {batch} not divisible into {m} microbatches across "
            f"data axes of size {data_size}")
    return m


def _run_ticks_in_process(stage_fn, stage_params, xs: torch.Tensor
                          ) -> torch.Tensor:
    """Every stage's ticks in this process: xs [M, mb, ...] → the last
    stage's outputs [M, mb, ...]."""
    n_stages = tree_leaves(stage_params)[0].shape[0]
    # one ``unbind`` per leaf, as llama_hidden slices its stacked layers
    leaves, structure = tree_flatten(stage_params)
    per_leaf = [t.unbind(0) for t in leaves]
    params = [tree_unflatten(structure, [u[s] for u in per_leaf])
              for s in range(n_stages)]
    n_micro = xs.shape[0]
    acts, outs = {}, [None] * n_micro
    for tick in gpipe_ticks(n_stages, n_micro):
        done = {}
        for s, m in tick:
            h = xs[m] if s == 0 else acts.pop((s - 1, m))
            y = stage_fn(params[s], h)
            if s == n_stages - 1:
                outs[m] = y
            else:
                done[(s, m)] = y
        acts.update(done)
    return torch.stack(outs)


class _StageTicks(torch.autograd.Function):
    """One stage rank's ticks on the ``stage`` sub-group. Inputs: the
    stage's local param leaves, then xs [M, mb, ...] (read by stage 0 only).
    Output: the last stage's outputs [M, mb, ...], broadcast to every stage
    rank. The backward takes the output's gradient on the last stage (every
    rank holds the same loss: the broadcast's transpose is not a sum) and
    runs the stage's backward microbatch by microbatch in reverse, passing
    input gradients to the previous stage."""

    @staticmethod
    def forward(ctx, stage_fn, structure, group, n_leaves, *args):
        leaves, xs = args[:n_leaves], args[n_leaves]
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        prev = dist.get_global_rank(group, rank - 1) if rank > 0 else None
        nxt = (dist.get_global_rank(group, rank + 1) if rank < world - 1
               else None)
        last = dist.get_global_rank(group, world - 1)
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        params = tree_unflatten(structure, inputs)
        h_ins, h_outs = [], []
        with torch.enable_grad():
            for m in range(xs.shape[0]):
                if prev is None:
                    h = xs[m].detach()
                else:
                    h = torch.empty_like(xs[m])
                    dist.recv(h, prev, group=group)
                h.requires_grad_(prev is not None or xs.requires_grad)
                y = stage_fn(params, h)
                if nxt is not None:
                    dist.send(y.detach().contiguous(), nxt, group=group)
                h_ins.append(h)
                h_outs.append(y)
        out = (torch.stack([y.detach() for y in h_outs]) if nxt is None
               else torch.empty_like(xs))
        dist.broadcast(out, last, group=group)
        ctx.stage_fn, ctx.group = stage_fn, group
        ctx.prev, ctx.nxt = prev, nxt
        ctx.inputs, ctx.h_ins, ctx.h_outs = inputs, h_ins, h_outs
        return out

    @staticmethod
    def backward(ctx, grad_out):
        inputs, h_ins, h_outs = ctx.inputs, ctx.h_ins, ctx.h_outs
        wrt = [t for t in inputs if t.requires_grad]
        grads = [None] * len(inputs)
        grad_xs = [None] * len(h_ins)
        for m in reversed(range(len(h_ins))):
            if ctx.nxt is None:
                g = grad_out[m].contiguous()
            else:
                g = torch.empty_like(h_outs[m])
                dist.recv(g, ctx.nxt, group=ctx.group)
            need_h = h_ins[m].requires_grad
            got = torch.autograd.grad(h_outs[m], wrt + [h_ins[m]] * need_h,
                                      g, allow_unused=True)
            it = iter(got[:len(wrt)])
            for i, t in enumerate(inputs):
                if t.requires_grad:
                    gi = next(it)
                    if gi is not None:
                        grads[i] = gi if grads[i] is None else grads[i] + gi
            if need_h:
                if ctx.prev is not None:
                    dist.send(got[-1].contiguous(), ctx.prev,
                              group=ctx.group)
                else:
                    grad_xs[m] = got[-1]
        grads = [torch.zeros_like(t) if g is None and t.requires_grad else g
                 for t, g in zip(inputs, grads)]
        grad_x = (torch.stack([g if g is not None else torch.zeros_like(h)
                               for g, h in zip(grad_xs, h_ins)])
                  if ctx.prev is None and any(g is not None for g in grad_xs)
                  else None)
        ctx.inputs = ctx.h_ins = ctx.h_outs = None
        return (None, None, None, None, *grads, grad_x)


def _data_axes(mesh: DeviceMesh, data_axis) -> Tuple[str, ...]:
    return tuple(a for a in (data_axis or ()) if a in mesh.mesh_dim_names)


def _data_rank_and_size(mesh: DeviceMesh, axes: Sequence[str]
                        ) -> Tuple[int, int]:
    """This rank's index over the data axes (major to minor) and their
    size."""
    rank, size = 0, 1
    for a in axes:
        n = mesh.size(mesh.mesh_dim_names.index(a))
        rank = rank * n + mesh.get_local_rank(a)
        size *= n
    return rank, size


def _batch_placements(mesh: DeviceMesh, axes: Sequence[str]) -> Tuple:
    """The rows sharded over the data axes (in mesh order, as DTensor splits
    a dim over several mesh dims), replicated over the others."""
    return tuple(Shard(0) if n in axes else Replicate()
                 for n in mesh.mesh_dim_names)


def _local_rows(x: torch.Tensor, mesh: DeviceMesh, axes: Sequence[str]
                ) -> torch.Tensor:
    """This data rank's contiguous block of the batch: from a full tensor,
    the same on every rank, or from a DTensor."""
    if isinstance(x, DTensor):
        return x.redistribute(mesh, _batch_placements(mesh, axes)).to_local()
    d, n = _data_rank_and_size(mesh, axes)
    return x.chunk(n)[d] if n > 1 else x


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    mesh: Optional[DeviceMesh] = None,
    *,
    axis: str = STAGE_AXIS,
    data_axis: Optional[Sequence[str]] = ("data",),
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """Apply S pipeline stages to ``x`` with microbatch pipelining.

    Args:
      stage_fn: ``(params_for_one_stage, h) -> h`` with unchanged shape and
        type (the homogeneous-stage contract).
      stage_params: a tree stacked on a leading ``n_stages`` dim (see
        :func:`init_stage_params`): DTensors sharded over ``axis`` on a
        mesh, plain tensors without one.
      x: ``[batch, ...]`` activations, split into ``num_microbatches`` equal
        microbatches on the leading dim (default: the largest M <= 4·S that
        divides the batch across the data axes).
      mesh: the ``DeviceMesh`` whose ``axis`` holds the stages, or None to
        run every stage's ticks in this process.
      data_axis: mesh axes the batch dim is also sharded over (DP × PP
        meshes); None or () for pure PP.

    Returns ``[batch, ...]``: without a mesh a tensor; on a mesh a DTensor
    sharded over the data axes and replicated over ``axis``, whose gradient
    flows back through the stages.
    """
    if mesh is None:
        n_stages = tree_leaves(stage_params)[0].shape[0]
        m = _num_microbatches(x.shape[0], n_stages, 1, num_microbatches)
        ys = _run_ticks_in_process(stage_fn, stage_params,
                                   x.reshape((m, -1) + x.shape[1:]))
        return ys.reshape(x.shape[:1] + ys.shape[2:])

    n_stages = num_stages(mesh, axis)
    axes = _data_axes(mesh, data_axis)
    _, data_size = _data_rank_and_size(mesh, axes)
    m = _num_microbatches(x.shape[0], n_stages, data_size, num_microbatches)
    local = _local_rows(x, mesh, axes)
    xs = local.reshape((m, -1) + local.shape[1:])
    leaves, structure = tree_flatten(stage_params)
    # each rank's own stage; its gradient is partial over the data axes
    # (each data rank saw its rows) and the stage's shard of the stack
    grad_placements = tuple(
        Shard(0) if n == axis else (Partial() if n in axes else Replicate())
        for n in mesh.mesh_dim_names)
    local_leaves = [t.to_local(grad_placements=grad_placements)[0]
                    if isinstance(t, DTensor) else t for t in leaves]
    ys = _StageTicks.apply(stage_fn, structure, mesh.get_group(axis),
                           len(local_leaves), *local_leaves, xs)
    y_local = ys.reshape(local.shape[:1] + ys.shape[2:])
    return DTensor.from_local(y_local, mesh, _batch_placements(mesh, axes),
                              run_check=False)


def make_pipeline_train_step(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
    tx,
    mesh: Optional[DeviceMesh],
    stage_params: Any,
    *,
    axis: str = STAGE_AXIS,
    data_axis: Optional[Sequence[str]] = ("data",),
    num_microbatches: Optional[int] = None,
):
    """``step((params, optimizer), (x, target)) -> ((params, optimizer),
    metrics)``: the forward is the microbatch pipeline, the backward its
    transpose, and ``optimizer`` (``tx(params)``, built by the caller as the
    JAX caller builds ``tx.init(params)``) updates the params in place.
    ``loss_fn(pipeline_output, target) -> scalar``; on a mesh the target is
    sharded as the output is, and each param's gradient is reduced over the
    data axes to the param's placements. Metrics: ``loss``, a 0-dim tensor.
    ``tx`` and ``stage_params`` are accepted for the JAX signature's sake:
    the carry's params and optimizer are the ones used."""
    del tx, stage_params
    axes = () if mesh is None else _data_axes(mesh, data_axis)

    def step(carry, batch):
        params, opt = carry
        x, target = batch
        opt.zero_grad(set_to_none=True)
        y = pipeline_apply(stage_fn, params, x, mesh, axis=axis,
                           data_axis=data_axis,
                           num_microbatches=num_microbatches)
        if mesh is not None and not isinstance(target, DTensor):
            target = DTensor.from_local(
                _local_rows(target, mesh, axes), mesh,
                _batch_placements(mesh, axes), run_check=False)
        loss = loss_fn(y, target)
        loss.backward()
        for p in tree_leaves(params):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif isinstance(p, DTensor) and p.grad.placements != \
                    p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        opt.step()
        loss = loss.detach()
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        return (params, opt), {"loss": loss}

    return step


__all__ = ["STAGE_AXIS", "gpipe_ticks", "init_stage_params",
           "make_pipeline_train_step", "num_stages", "pipeline_apply",
           "stage_param_spec", "stage_params_from_jax"]
