# Copied from ray_tpu/util/collective/__init__.py (ray_tpu -> ray_tpu_torch).
"""ray_tpu_torch.util.collective — collective communication across actors
(reference: python/ray/util/collective/__init__.py)."""

from ray_tpu_torch.util.collective.collective import (
    allgather, allreduce, allreduce_sharded, barrier, broadcast,
    create_collective_group, destroy_collective_group, get_collective_group_size,
    get_rank, init_collective_group, is_group_initialized, recv, reduce,
    reducescatter, send)
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

__all__ = [
    "init_collective_group", "create_collective_group",
    "destroy_collective_group", "is_group_initialized", "get_rank",
    "get_collective_group_size", "allreduce", "allreduce_sharded", "barrier",
    "reduce", "broadcast", "allgather", "reducescatter", "send", "recv",
    "Backend", "ReduceOp",
]
