"""Device-mesh formation over a ``torch.distributed`` world.

Port of ``ray_tpu/parallel/mesh.py``. The JAX package's mesh is a
``jax.sharding.Mesh`` over a slice's devices; here it is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialized process group, one device per rank, with the same six named
axes in the same order and the same shape inference; the axes of size 1 are
left out of the ``DeviceMesh`` (:func:`mesh_axes` says why). Topology placement has
no counterpart: the ranks are laid out in order (rank r at the row-major
position r), which on one host of NVLink-connected cards gives every axis
the same links.

Axis conventions (outer → inner, as in the JAX package):

- ``data``   — pure data parallelism (gradient all-reduce)
- ``stage``  — pipeline parallelism (point-to-point activations)
- ``fsdp``   — ZeRO-3 style parameter/optimizer sharding (all-gather weights)
- ``seq``    — sequence/context parallelism (ring attention)
- ``tensor`` — megatron-style tensor parallelism (activation collectives)
- ``expert`` — MoE expert parallelism (all_to_all)
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tpu_torch._private.device import resolve_device

AXIS_ORDER: Tuple[str, ...] = ("data", "stage", "fsdp", "seq", "tensor",
                               "expert")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Declarative mesh shape. -1 on at most one axis means "absorb the
    rest". It plays for the mesh the role ``ScalingConfig`` plays for the
    workers."""

    data: int = -1
    stage: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wildcards = [a for a, s in sizes.items() if s == -1]
        if len(wildcards) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wildcards}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wildcards:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {fixed}")
            sizes[wildcards[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER


def best_mesh_shape(n_devices: int, *, tensor: int = 1,
                    fsdp: Optional[int] = None, seq: int = 1) -> MeshConfig:
    """Heuristic: put everything not explicitly requested on fsdp, leaving
    data=1 unless fsdp is capped."""
    if fsdp is None:
        fsdp = max(1, n_devices // (tensor * seq))
    return MeshConfig(data=-1, fsdp=fsdp, seq=seq, tensor=tensor)


def create_mesh(config: Optional[MeshConfig] = None, *,
                device: Optional[Union[str, torch.device]] = None
                ) -> DeviceMesh:
    """A ``DeviceMesh`` over every rank of the initialized default process
    group, shaped by ``config`` (``MeshConfig()``: all ranks on ``data``),
    its dims named :data:`AXIS_ORDER`. ``device`` ``None`` is the CUDA card
    (each rank its current device) and raises without CUDA; the CPU is
    taken only when asked for (``device="cpu"``, over a gloo group)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialized torch.distributed process "
            "group (TorchTrainer's workers have one); local_mesh() sets up "
            "a one-rank group")
    config = config or MeshConfig()
    sizes = config.resolve(dist.get_world_size())
    names = mesh_axes(sizes)
    return init_device_mesh(dev.type, tuple(sizes[a] for a in names),
                            mesh_dim_names=names)


def mesh_axes(sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The axes a ``DeviceMesh`` is built over: those of :data:`AXIS_ORDER`
    larger than 1, in order (``("data",)`` when all are 1). An axis of size
    1 shards nothing, and DTensor's sharding propagation enumerates the
    placements of every op over every mesh dim, a cost that grows
    exponentially with their number: a six-dim mesh spent minutes of host
    time on one rms-norm. An axis that is not a dim of the mesh has size
    1 to every function of the port."""
    return tuple(a for a in AXIS_ORDER if sizes[a] > 1) or ("data",)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_mesh(*, device: Optional[Union[str, torch.device]] = None
               ) -> DeviceMesh:
    """A one-rank mesh (every axis of size 1) for single-device paths. With
    no process group initialized it first sets one up over this process
    alone (NCCL on the card, gloo when ``device="cpu"``), at a free
    ``localhost`` port."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    if dist.get_world_size() != 1:
        raise RuntimeError(
            f"local_mesh is a one-rank mesh; the process group has "
            f"{dist.get_world_size()} ranks (use create_mesh)")
    return create_mesh(MeshConfig(data=-1), device=dev)


__all__ = ["AXIS_ORDER", "MeshConfig", "best_mesh_shape", "create_mesh",
           "local_mesh", "mesh_axes"]
