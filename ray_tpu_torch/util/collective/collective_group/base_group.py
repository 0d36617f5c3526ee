# Copied from ray_tpu/util/collective/collective_group/base_group.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Base collective group (reference:
python/ray/util/collective/collective_group/base_collective_group.py).

Ops are *functional*: they return the result instead of mutating the input
tensor in place (the reference mutates torch/cupy tensors; jax arrays are
immutable, so the TPU-native API returns new values — numpy inputs are
additionally updated in place for drop-in compatibility).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List

from ray_tpu_torch.util.collective.types import (
    AllGatherOptions, AllReduceOptions, BarrierOptions, BroadcastOptions,
    RecvOptions, ReduceOptions, ReduceScatterOptions, SendOptions)


class BaseGroup(ABC):
    def __init__(self, world_size: int, rank: int, group_name: str):
        self._world_size = world_size
        self._rank = rank
        self._group_name = group_name

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world_size

    @property
    def group_name(self) -> str:
        return self._group_name

    def destroy_group(self) -> None:
        pass

    @classmethod
    @abstractmethod
    def backend(cls) -> str:
        ...

    @abstractmethod
    def allreduce(self, tensor, opts: AllReduceOptions = AllReduceOptions()):
        ...

    @abstractmethod
    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        ...

    @abstractmethod
    def reduce(self, tensor, opts: ReduceOptions = ReduceOptions()):
        ...

    @abstractmethod
    def allgather(self, tensor, opts: AllGatherOptions = AllGatherOptions()) -> List[Any]:
        ...

    @abstractmethod
    def broadcast(self, tensor, opts: BroadcastOptions = BroadcastOptions()):
        ...

    @abstractmethod
    def reducescatter(self, tensor_list, opts: ReduceScatterOptions = ReduceScatterOptions()):
        ...

    @abstractmethod
    def send(self, tensor, opts: SendOptions):
        ...

    @abstractmethod
    def recv(self, shape_dtype, opts: RecvOptions):
        ...
