# Ported from ray_tpu/util/collective/types.py (Backend.XLA -> Backend.NCCL).
"""Collective types (reference: python/ray/util/collective/types.py).

- ``Backend.NCCL`` — device collectives over a ``torch.distributed`` process
  group on the members' CUDA cards (``collective_group/nccl_group.py``),
  the counterpart of the JAX package's device-mesh (XLA) backend.
- ``Backend.CPU`` — gloo-equivalent host-memory backend for numpy arrays
  and CPU tensors, rendezvous + transport via a named store actor.
"""

from __future__ import annotations

import dataclasses
from enum import Enum


class Backend(str, Enum):
    NCCL = "nccl"
    CPU = "cpu"
    # Aliases: "gpu" and the JAX package's "xla" name the device backend,
    # "gloo" and "host" the host one.
    @classmethod
    def coerce(cls, name: "str | Backend") -> "Backend":
        if isinstance(name, Backend):
            return name
        name = str(name).lower()
        if name in ("nccl", "gpu", "xla"):
            return cls.NCCL
        if name in ("cpu", "gloo", "host"):
            return cls.CPU
        raise ValueError(f"Unknown collective backend: {name!r}")


class ReduceOp(str, Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


@dataclasses.dataclass
class AllReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30000


@dataclasses.dataclass
class BarrierOptions:
    timeout_ms: int = 30000


@dataclasses.dataclass
class ReduceOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    root_rank: int = 0
    timeout_ms: int = 30000


@dataclasses.dataclass
class BroadcastOptions:
    root_rank: int = 0
    timeout_ms: int = 30000


@dataclasses.dataclass
class AllGatherOptions:
    timeout_ms: int = 30000


@dataclasses.dataclass
class ReduceScatterOptions:
    reduceOp: ReduceOp = ReduceOp.SUM
    timeout_ms: int = 30000


@dataclasses.dataclass
class SendOptions:
    dst_rank: int = 0
    timeout_ms: int = 30000


@dataclasses.dataclass
class RecvOptions:
    src_rank: int = 0
    timeout_ms: int = 30000
