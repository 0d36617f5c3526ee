"""Logical-axis sharding rules on DTensor.

Port of ``ray_tpu/parallel/sharding.py``. Parameters are annotated with
*logical* axis names ("embed", "mlp", "heads", "vocab", …); a rule table
maps logical → mesh axes, and :func:`logical_to_spec` turns a leaf's logical
axes into a per-tensor-dim spec exactly as the JAX package does. DTensor is
the port's GSPMD: a spec becomes one placement per mesh dim
(:func:`spec_to_placements`: ``Shard(d)`` on each mesh dim that the spec
puts tensor dim ``d`` on, ``Replicate()`` elsewhere), ``jax.device_put``
onto a sharding is ``distribute_tensor``, ``with_sharding_constraint`` is
``DTensor.redistribute`` (:func:`constrain`), and ``shard_map`` is
``local_map`` (:func:`compat_shard_map`). The mesh in scope is a context
variable (:func:`compat_mesh_ctx`, :func:`ambient_mesh`).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor, Placement, Replicate, Shard, distribute_tensor)

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
LogicalAxisRules = Dict[str, Union[None, str, Tuple[str, ...]]]

# The standard rule table for transformer LMs. fsdp shards the embed dim of
# every weight (ZeRO-3); tensor shards heads/mlp (megatron); batch rides
# (data, fsdp) together so the global batch divides evenly when fsdp > 1.
DEFAULT_RULES: LogicalAxisRules = {
    "batch": ("data", "fsdp"),
    "seq": "seq",
    "embed": "fsdp",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "mlp": "tensor",
    "vocab": "tensor",
    "expert": "expert",
    "norm": None,
}


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (not sharded), a mesh axis name, or a tuple
    of mesh axis names (major to minor) — ``jax.sharding.PartitionSpec``'s
    entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[LogicalAxisRules] = None
                    ) -> PartitionSpec:
    """('embed','mlp') -> PartitionSpec('fsdp','tensor') under
    DEFAULT_RULES."""
    rules = rules or DEFAULT_RULES
    spec = []
    used: set = set()
    for ax in logical_axes:
        mesh_ax = rules.get(ax) if ax is not None else None
        # A mesh axis may appear only once per spec; later duplicates
        # replicate.
        if mesh_ax is None:
            spec.append(None)
        elif isinstance(mesh_ax, tuple):
            fresh = tuple(m for m in mesh_ax if m not in used)
            used.update(fresh)
            spec.append(fresh if fresh else None)
        elif mesh_ax in used:
            spec.append(None)
        else:
            used.add(mesh_ax)
            spec.append(mesh_ax)
    return P(*spec)


def spec_to_placements(spec: Sequence[Any], mesh: DeviceMesh
                       ) -> Tuple[Placement, ...]:
    """One DTensor placement per mesh dim: ``Shard(d)`` where the spec puts
    tensor dim ``d`` on that mesh dim, ``Replicate()`` elsewhere; a spec's
    axis that is not a dim of the mesh, or is one of size 1, shards
    nothing. A tensor
    dim on several mesh dims is split over them major to minor in mesh
    order, as DTensor splits it; a spec that names them in another order
    has another layout and raises."""
    names = mesh.mesh_dim_names
    placements: list = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        # an axis the mesh leaves out has size 1 (mesh.mesh_axes)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            # a dim of size 1 (a one-rank mesh) shards nothing: DTensor
            # cannot reshape a dim it holds as sharded, even over one rank
            if mesh.size(i) > 1:
                placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: ``jax.sharding.NamedSharding``'s counterpart."""
    mesh: DeviceMesh
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return spec_to_placements(self.spec, self.mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def _map_axes(fn, logical_tree):
    """``fn`` over each logical-axes tuple of a tree (the tuples are
    leaves, not nodes)."""
    if isinstance(logical_tree, dict):
        return {k: _map_axes(fn, v) for k, v in logical_tree.items()}
    if _is_axes(logical_tree):
        return fn(logical_tree)
    if isinstance(logical_tree, (list, tuple)):
        return type(logical_tree)(_map_axes(fn, v) for v in logical_tree)
    raise TypeError(f"not a logical-axes tree leaf: {logical_tree!r}")


def param_shardings(logical_tree: Any, mesh: DeviceMesh,
                    rules: Optional[LogicalAxisRules] = None) -> Any:
    """Map a tree of logical-axis tuples to a tree of NamedShardings."""
    return _map_axes(
        lambda axes: NamedSharding(mesh, logical_to_spec(axes, rules)),
        logical_tree)


def shard_tensor(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A full tensor, the same on every rank, as a DTensor on the sharding:
    each rank keeps its own slice, with no communication
    (``src_data_rank=None``). The tensor is moved to the mesh's device
    type first."""
    dev = torch.device(sharding.mesh.device_type)
    if t.device.type != dev.type:
        t = t.to(dev if dev.type == "cpu" else torch.device(
            dev.type, torch.cuda.current_device()))
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def shard_pytree(tree: Any, shardings: Any) -> Any:
    """Place a tree of full tensors onto its shardings (the same structure,
    a NamedSharding per leaf): ``jax.device_put`` of a host pytree."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_pytree(v, s) for v, s in zip(tree, shardings))
    return shard_tensor(tree, shardings)


def place_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A full tensor, the same on every rank, placed as ``like`` is when
    ``like`` is a DTensor (each rank keeps its slice); else ``t``."""
    if not isinstance(like, DTensor):
        return t
    return distribute_tensor(t, like.device_mesh, like.placements,
                             src_data_rank=None)


def as_replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A tensor that every rank computed alike (a table of constants), as a
    replicated DTensor on ``like``'s mesh when ``like`` is a DTensor (DTensor
    ops take no plain tensors); else ``t``."""
    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_mesh", default=None)


def ambient_mesh() -> Optional[DeviceMesh]:
    """The mesh in scope (set by :func:`compat_mesh_ctx`), or None."""
    return _MESH.get()


@contextlib.contextmanager
def compat_mesh_ctx(mesh: Optional[DeviceMesh]):
    """Put ``mesh`` in scope for :func:`constrain` and the mesh-bound
    layers (``jax.set_mesh``'s counterpart)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def compat_shard_map(f, mesh: Optional[DeviceMesh] = None, in_specs=None,
                     out_specs=None, check_vma: bool = False):
    """``shard_map`` as ``local_map``: ``f`` runs on each rank's local
    shards of the DTensor arguments (``in_specs``, one per argument, each a
    spec or None for a non-tensor argument) and its outputs are DTensors
    with ``out_specs``. Arguments are redistributed to ``in_specs`` first.
    ``mesh`` None is the ambient mesh (which a backward on autograd's own
    thread does not see: callers there pass their DTensors' mesh).
    ``check_vma`` is accepted for the JAX signature's sake."""
    from torch.distributed.tensor.experimental import local_map

    del check_vma
    mesh = mesh if mesh is not None else ambient_mesh()
    if mesh is None:
        raise RuntimeError("compat_shard_map needs a mesh in scope")

    def placements(spec):
        # local_map reads a list as one tensor's placements and a tuple as
        # one entry per output
        return None if spec is None else list(spec_to_placements(spec, mesh))

    def one_or_tuple(specs):
        if isinstance(specs, PartitionSpec) or specs is None:
            return placements(specs)
        return tuple(placements(s) for s in specs)

    return local_map(f, out_placements=one_or_tuple(out_specs),
                     in_placements=one_or_tuple(in_specs),
                     device_mesh=mesh, redistribute_inputs=True)


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
              rules: Optional[LogicalAxisRules] = None) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axes: a DTensor is
    redistributed to the spec's placements on its mesh. No-op for a plain
    tensor (one-device code, where the JAX package has no mesh in scope).
    The mesh is the DTensor's own, not only the ambient one: autograd runs
    a CUDA backward, and with it the recompute of a checkpointed layer, on
    a thread of its own, where the ambient mesh is not set, and the
    recompute must lay its tensors out as the forward did."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = spec_to_placements(logical_to_spec(logical_axes, rules), mesh)
    return x if tuple(x.placements) == want else x.redistribute(
        mesh, want)


__all__ = ["DEFAULT_RULES", "LogicalAxisRules", "NamedSharding",
           "PartitionSpec", "ambient_mesh", "as_replicated", "compat_mesh_ctx",
           "compat_shard_map", "constrain", "logical_to_spec", "param_shardings", "place_like",
           "shard_pytree",
           "shard_tensor", "spec_to_placements"]
