# Ported from ray_tpu/util/collective/collective_group/cpu_group.py (ray_tpu -> ray_tpu_torch; CPU tensors as well as numpy arrays).
"""Host-memory (gloo-equivalent) collective group.

Reference analog: python/ray/util/collective/collective_group/
gloo_collective_group.py (565 LoC). Rendezvous rides the named store actor;
every collective is gather-compute: all members contribute, each member
pulls the completed set and reduces locally.

Payload transport is SIZE-SPLIT (reference: NCCL/gloo groups move bulk
tensors peer-to-peer, nccl_collective_group.py:127): tensors above
``collective_inline_max_bytes`` are ``ray_tpu_torch.put`` into the object plane
and only their ObjectRefs cross the rendezvous store — members fetch the
bytes worker<->worker through the owner service/object plane (zero-copy
shm on one node, chunked pull across nodes), so the store never relays
O(members x bytes) through one process. Metadata-sized tensors stay
inline (one RPC beats put+get).
"""

from __future__ import annotations

import time
from typing import Any, List

import sys

import numpy as np

from ray_tpu_torch.util.collective.collective_group.base_group import BaseGroup
from ray_tpu_torch.util.collective.collective_group.store import CollectiveStore
from ray_tpu_torch.util.collective.types import (
    AllGatherOptions, AllReduceOptions, BarrierOptions, BroadcastOptions,
    RecvOptions, ReduceOp, ReduceOptions, ReduceScatterOptions, SendOptions)

_POLL_S = 0.002


def _is_tensor(x) -> bool:
    """A torch tensor? (torch is imported only by a process that has one:
    the host group keeps it out of the workers that pass numpy.)"""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _reduce_arrays(arrays: List[np.ndarray], op: ReduceOp) -> np.ndarray:
    acc = np.asarray(arrays[0]).copy()
    for a in arrays[1:]:
        a = np.asarray(a)
        if op == ReduceOp.SUM:
            acc += a
        elif op == ReduceOp.PRODUCT:
            acc *= a
        elif op == ReduceOp.MIN:
            np.minimum(acc, a, out=acc)
        elif op == ReduceOp.MAX:
            np.maximum(acc, a, out=acc)
    return acc


class CPUGroup(BaseGroup):
    def __init__(self, world_size: int, rank: int, group_name: str,
                 store_key: str = ""):
        """``store_key`` isolates incarnations of a logical group: a
        restarted worker group must not see a dead predecessor's staged
        contributions (same op sequence numbers would collide)."""
        super().__init__(world_size, rank, group_name)
        import ray_tpu_torch

        store_cls = ray_tpu_torch.remote(CollectiveStore)
        self._store = store_cls.options(
            name=f"_collective_store:{store_key or group_name}",
            get_if_exists=True,
            lifetime="detached",
        ).remote()
        import ray_tpu_torch as _rt

        _rt.get(self._store.register.remote(rank))
        self._seq = 0
        self._p2p_seq: dict = {}
        # owner-side pins for object-plane payloads: the CONTRIBUTOR must
        # hold its ref until every member fetched (refs relayed through
        # the store do not keep the owner's record alive on their own)
        self._p2p_pins: dict = {}

    @classmethod
    def backend(cls) -> str:
        return "cpu"

    def destroy_group(self) -> None:
        import ray_tpu_torch

        # drop owner-side pins for any still-unfetched bulk sends (the
        # store's TTL sweep reclaims the matching entries)
        self._p2p_pins.clear()
        try:
            remaining = ray_tpu_torch.get(self._store.deregister.remote(self._rank))
            if remaining == 0:
                ray_tpu_torch.kill(self._store)
        except Exception:
            pass

    # -- internals ---------------------------------------------------------

    def _next_key(self, op: str) -> str:
        self._seq += 1
        return f"{op}:{self._seq}"

    @staticmethod
    def _wire_nbytes(wire) -> int:
        if wire is None:
            return 0
        if isinstance(wire, (list, tuple)):
            return sum(CPUGroup._wire_nbytes(w) for w in wire)
        return int(getattr(wire, "nbytes", 0) or 0)

    def _boxed(self, wire):
        """("v", payload) inline, or ("r", ObjectRef) via the object plane
        for bulk tensors — the rendezvous store then carries ~20 bytes."""
        from ray_tpu_torch._private.config import CONFIG

        if self._wire_nbytes(wire) <= CONFIG.collective_inline_max_bytes:
            return ("v", wire)
        import ray_tpu_torch

        return ("r", ray_tpu_torch.put(wire))

    @staticmethod
    def _unboxed(boxed):
        tag, v = boxed
        if tag == "v":
            return v
        import ray_tpu_torch

        return ray_tpu_torch.get(v)

    @staticmethod
    def _unbox_all(boxed_list):
        """Resolve a whole collected set: all object-plane refs fetch in
        ONE batched get so cross-worker pulls overlap instead of running
        back-to-back (the win grows with world size)."""
        import ray_tpu_torch

        refs = [b[1] for b in boxed_list if b[0] == "r"]
        fetched = iter(ray_tpu_torch.get(refs) if refs else [])
        return [next(fetched) if b[0] == "r" else b[1]
                for b in boxed_list]

    def _exchange(self, op: str, payload: Any, timeout_ms: int) -> List[Any]:
        import ray_tpu_torch

        key = self._next_key(op)
        boxed = self._boxed(payload)
        # OWNER pin: our put ref must outlive every member's fetch — the
        # copies relayed through the store don't keep the owner's record
        pin = boxed[1] if boxed[0] == "r" else None
        ray_tpu_torch.get(self._store.contribute.remote(key, self._rank, boxed))
        deadline = time.time() + timeout_ms / 1000.0
        while True:
            out = ray_tpu_torch.get(
                self._store.collect.remote(key, self._world_size))
            if out is not None:
                break
            if time.time() > deadline:
                raise TimeoutError(
                    f"collective {op} timed out in group "
                    f"{self._group_name!r} (rank {self._rank})")
            time.sleep(_POLL_S)
        vals = self._unbox_all(out)
        if any(isinstance(b, tuple) and b and b[0] == "r" for b in out):
            # bytes fetched: count our confirm, then hold the pin until
            # EVERY member confirmed (the op is already a barrier — this
            # only extends it to the slowest fetcher). The pin phase gets
            # its OWN full timeout window: collect may have consumed most
            # of the shared deadline, and dropping the only pin while a
            # slower member is mid-fetch would lose its payload.
            ray_tpu_torch.get(self._store.confirm.remote(key, self._world_size))
            pin_deadline = time.time() + timeout_ms / 1000.0
            while pin is not None:
                if ray_tpu_torch.get(self._store.op_done.remote(key)):
                    break
                if time.time() > pin_deadline:
                    break  # give up pinning, not the result
                time.sleep(_POLL_S)
            del pin
        return vals

    # host<->transport hooks: numpy arrays and CPU tensors cross as numpy;
    # an input of the result's shape is updated in place and returned, a
    # tensor input gets a tensor back
    def _to_wire(self, tensor) -> np.ndarray:
        if _is_tensor(tensor):
            return tensor.detach().cpu().numpy()
        return np.asarray(tensor)

    def _from_wire(self, array: np.ndarray, like):
        if _is_tensor(like):
            import torch

            out = torch.from_numpy(np.ascontiguousarray(array)).to(
                like.dtype)
            if like.shape == out.shape:
                with torch.no_grad():
                    like.copy_(out)
                return like
            return out
        if (isinstance(like, np.ndarray) and like.shape == array.shape
                and like.flags.writeable):
            np.copyto(like, array.astype(like.dtype, copy=False))
            return like
        return array

    # -- ops ---------------------------------------------------------------

    def allreduce(self, tensor, opts: AllReduceOptions = AllReduceOptions()):
        parts = self._exchange("ar", self._to_wire(tensor), opts.timeout_ms)
        return self._from_wire(_reduce_arrays(parts, opts.reduceOp), tensor)

    def barrier(self, opts: BarrierOptions = BarrierOptions()):
        self._exchange("bar", None, opts.timeout_ms)

    def reduce(self, tensor, opts: ReduceOptions = ReduceOptions()):
        parts = self._exchange("red", self._to_wire(tensor), opts.timeout_ms)
        if self._rank == opts.root_rank:
            return self._from_wire(_reduce_arrays(parts, opts.reduceOp), tensor)
        return tensor

    def allgather(self, tensor,
                  opts: AllGatherOptions = AllGatherOptions()) -> List[Any]:
        parts = self._exchange("ag", self._to_wire(tensor), opts.timeout_ms)
        return [self._from_wire(np.asarray(p), None) for p in parts]

    def broadcast(self, tensor, opts: BroadcastOptions = BroadcastOptions()):
        payload = self._to_wire(tensor) if self._rank == opts.root_rank else None
        parts = self._exchange("bc", payload, opts.timeout_ms)
        return self._from_wire(np.asarray(parts[opts.root_rank]), tensor)

    def reducescatter(self, tensor_list,
                      opts: ReduceScatterOptions = ReduceScatterOptions()):
        """Each member contributes world_size shards; returns its reduced shard."""
        if len(tensor_list) != self._world_size:
            raise ValueError(
                f"reducescatter needs {self._world_size} input shards, got "
                f"{len(tensor_list)}")
        wire = [self._to_wire(t) for t in tensor_list]
        parts = self._exchange("rs", wire, opts.timeout_ms)
        mine = [np.asarray(p[self._rank]) for p in parts]
        return self._from_wire(
            _reduce_arrays(mine, opts.reduceOp), tensor_list[self._rank])

    def send(self, tensor, opts: SendOptions):
        import ray_tpu_torch

        pair = (self._rank, opts.dst_rank)
        seq = self._p2p_seq.get(pair, 0) + 1
        self._p2p_seq[pair] = seq
        key = f"sr:{self._rank}:{opts.dst_rank}:{seq}"
        boxed = self._boxed(self._to_wire(tensor))
        if boxed[0] == "r":
            # owner pin until the receiver confirms the fetch; pruned
            # lazily on later sends and at destroy_group
            self._p2p_pins[key] = boxed[1]
        ray_tpu_torch.get(self._store.put_p2p.remote(key, boxed))
        if self._p2p_pins:
            gone = ray_tpu_torch.get(
                self._store.p2p_absent.remote(list(self._p2p_pins)))
            for k in gone:
                self._p2p_pins.pop(k, None)

    def recv(self, like, opts: RecvOptions):
        import ray_tpu_torch

        pair = (opts.src_rank, self._rank)
        seq = self._p2p_seq.get(pair, 0) + 1
        key = f"sr:{opts.src_rank}:{self._rank}:{seq}"
        deadline = time.time() + opts.timeout_ms / 1000.0
        while True:
            boxed = ray_tpu_torch.get(self._store.take_p2p.remote(key))
            if boxed is not None:
                # Commit the sequence number only on success so a timed-out
                # recv can be retried without desynchronizing the pair.
                self._p2p_seq[pair] = seq
                value = self._unboxed(boxed[0])
                if boxed[0][0] == "r":
                    # bytes fetched: the store may now drop its pin
                    # (inline entries were popped by take_p2p itself)
                    ray_tpu_torch.get(self._store.confirm_p2p.remote(key))
                return self._from_wire(np.asarray(value), like)
            if time.time() > deadline:
                raise TimeoutError(
                    f"recv from rank {opts.src_rank} timed out "
                    f"(group {self._group_name!r})")
            time.sleep(_POLL_S)
