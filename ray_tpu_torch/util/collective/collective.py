# Ported from ray_tpu/util/collective/collective.py (XLAGroup -> NCCLGroup).
"""Collective API across actors/tasks (reference:
python/ray/util/collective/collective.py — GroupManager :40,
init_collective_group :120, create_collective_group :151, allreduce :258,
barrier :298, reduce :311, broadcast :373, allgather :423,
reducescatter :472).

Groups are process-local objects registered in a ``GroupManager``; rendezvous
and declarative group creation ride the head's internal KV + a named store
actor (for the NCCL backend, the store carries rank 0's address, the
counterpart of NCCL's uniqueId broadcast).
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util.collective.types import (
    AllGatherOptions, AllReduceOptions, BarrierOptions, BroadcastOptions,
    Backend, RecvOptions, ReduceOp, ReduceOptions, ReduceScatterOptions,
    SendOptions)

_DECL_NS = "collective"


class GroupManager:
    """Process-local registry of collective groups (reference:
    collective.py:40)."""

    def __init__(self):
        self._groups: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def create_group(self, backend: Backend, world_size: int, rank: int,
                     group_name: str, store_key: str = ""):
        from ray_tpu_torch.util.collective.collective_group.cpu_group import CPUGroup
        from ray_tpu_torch.util.collective.collective_group.nccl_group import (
            NCCLGroup)

        cls = NCCLGroup if backend == Backend.NCCL else CPUGroup
        with self._lock:
            if group_name in self._groups:
                raise RuntimeError(
                    f"Collective group {group_name!r} already initialized in "
                    f"this process")
            g = cls(world_size, rank, group_name, store_key)
            self._groups[group_name] = g
            return g

    def get_group(self, group_name: str):
        with self._lock:
            g = self._groups.get(group_name)
        if g is None:
            g = self._try_declared_init(group_name)
        if g is None:
            raise RuntimeError(
                f"Collective group {group_name!r} is not initialized in this "
                f"process; call init_collective_group() or "
                f"create_collective_group() first")
        return g

    def destroy_group(self, group_name: str):
        with self._lock:
            g = self._groups.pop(group_name, None)
        if g is not None:
            g.destroy_group()

    def _try_declared_init(self, group_name: str):
        """Lazy init from a declaration written by create_collective_group
        (reference: declarative path collective.py:151)."""
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import KvClient, global_worker

        if global_worker is None or not global_worker.connected:
            return None
        kv = KvClient(global_worker)
        raw = kv.get(f"decl:{group_name}".encode(), namespace=_DECL_NS)
        if raw is None:
            return None
        decl = json.loads(raw.decode())
        my_actor = ray_tpu_torch.get_runtime_context().get_actor_id()
        rank = decl["ranks"].get(my_actor or "")
        if rank is None:
            return None
        try:
            return self.create_group(
                Backend.coerce(decl["backend"]), decl["world_size"], rank,
                group_name)
        except RuntimeError:
            # Lost a same-process race to another thread's lazy init.
            with self._lock:
                return self._groups.get(group_name)


_group_mgr = GroupManager()


def is_group_initialized(group_name: str = "default") -> bool:
    try:
        _group_mgr.get_group(group_name)
        return True
    except RuntimeError:
        return False


def init_collective_group(world_size: int, rank: int,
                          backend: str = "nccl",
                          group_name: str = "default",
                          store_key: str = ""):
    """Initialize this process's membership in a collective group
    (reference: collective.py:120). Call once per member, same order args."""
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range [0, {world_size})")
    return _group_mgr.create_group(
        Backend.coerce(backend), world_size, rank, group_name, store_key)


def create_collective_group(actors: List[Any], world_size: int,
                            ranks: List[int], backend: str = "nccl",
                            group_name: str = "default") -> None:
    """Declarative group creation from the driver (reference:
    collective.py:151): writes the membership table to the head KV; each
    actor's first collective op lazily joins with its declared rank."""
    if len(actors) != world_size or sorted(ranks) != list(range(world_size)):
        raise ValueError("need exactly world_size actors with ranks 0..n-1")
    from ray_tpu_torch._private.worker import KvClient, global_worker

    decl = {
        "backend": str(Backend.coerce(backend).value),
        "world_size": world_size,
        "ranks": {a._actor_id.hex(): r for a, r in zip(actors, ranks)},
    }
    KvClient(global_worker).put(
        f"decl:{group_name}".encode(), json.dumps(decl).encode(),
        namespace=_DECL_NS)


def destroy_collective_group(group_name: str = "default") -> None:
    _group_mgr.destroy_group(group_name)


def get_rank(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group_mgr.get_group(group_name).world_size


def allreduce(tensor, group_name: str = "default",
              op: ReduceOp = ReduceOp.SUM):
    return _group_mgr.get_group(group_name).allreduce(
        tensor, AllReduceOptions(reduceOp=op))


def barrier(group_name: str = "default") -> None:
    _group_mgr.get_group(group_name).barrier(BarrierOptions())


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: ReduceOp = ReduceOp.SUM):
    return _group_mgr.get_group(group_name).reduce(
        tensor, ReduceOptions(reduceOp=op, root_rank=dst_rank))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    return _group_mgr.get_group(group_name).broadcast(
        tensor, BroadcastOptions(root_rank=src_rank))


def allgather(tensor, group_name: str = "default") -> List[Any]:
    return _group_mgr.get_group(group_name).allgather(
        tensor, AllGatherOptions())


def reducescatter(tensor_list, group_name: str = "default",
                  op: ReduceOp = ReduceOp.SUM):
    return _group_mgr.get_group(group_name).reducescatter(
        tensor_list, ReduceScatterOptions(reduceOp=op))


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    _group_mgr.get_group(group_name).send(tensor, SendOptions(dst_rank=dst_rank))


def recv(like, src_rank: int, group_name: str = "default"):
    """Receive a tensor; ``like`` supplies dtype/placement (may be None)."""
    return _group_mgr.get_group(group_name).recv(
        like, RecvOptions(src_rank=src_rank))


def allreduce_sharded(tensor, mesh, axis: str, group_name: str = "default",
                      op: ReduceOp = ReduceOp.SUM):
    """Hierarchical allreduce: a sum over one axis of the member's mesh,
    then the combine across the group's members (multigpu-variant
    analog)."""
    g = _group_mgr.get_group(group_name)
    if not hasattr(g, "allreduce_sharded"):
        raise RuntimeError("allreduce_sharded requires the NCCL backend")
    return g.allreduce_sharded(tensor, mesh, axis, op)
