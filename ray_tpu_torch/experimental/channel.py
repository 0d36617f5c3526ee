# Copied from ray_tpu/experimental/channel.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Shared-memory channel for compiled DAGs (reference:
python/ray/experimental/channel.py, 171 LoC — the fixed buffer the
accelerated-DAG prototype reuses between executions instead of allocating a
fresh object per message).

Here: a ring of pre-created slots in the node's object store. ``write``
seals slot ``i % n``, ``read`` blocks for it and deletes after consumption,
so repeated DAG executions reuse at most ``n`` allocations' worth of shm
at a time while readers stay zero-copy.

A slot goes through the runtime's serializer: a ``torch.Tensor`` on a CUDA
card is brought to the host before it is written, and ``read`` gives back
a CPU tensor of the same dtype and shape (bf16 and non-contiguous tensors
through torch's own pickling). Nothing is put back on a device: a GPU
stage moves what it reads to its card.

Polling discipline: the hot path (compiled-DAG stage loops) spins with
``os.sched_yield`` first — on a core-constrained box a plain sleep adds a
full scheduler quantum per hop, while a yield hands the core straight to
the peer process that is about to produce/consume the slot — then falls
back to short sleeps so an idle channel costs ~no CPU.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Optional

from ray_tpu_torch._private.ids import ObjectID

_YIELD_ITERS = 64


def _poll(pred: Callable[[], bool], timeout: Optional[float],
          what: str, phase: int = 0) -> None:
    """Wait until pred() is true; sched_yield burst, then short sleeps.

    ``phase`` continues the escalation across retries (a caller re-polling
    the same still-empty slot must not restart the hot yield burst — an
    idle channel would otherwise cost ~500 wakeups/s forever). A raised
    TimeoutError carries the reached phase in ``.phase``.
    """
    if pred():
        return
    deadline = time.monotonic() + (timeout if timeout is not None else 1e9)
    i = phase
    while not pred():
        if time.monotonic() > deadline:
            e = TimeoutError(what)
            e.phase = i
            raise e
        if i < _YIELD_ITERS:
            os.sched_yield()
        else:
            time.sleep(0.0002 if i < _YIELD_ITERS + 256 else 0.005)
        i += 1


class Channel:
    """SPSC channel between two processes on one node."""

    def __init__(self, capacity: int = 2, _key: Optional[str] = None):
        self._key = _key or os.urandom(8).hex()
        self.capacity = capacity
        self._wseq = 0
        self._rseq = 0

    def _slot_id(self, seq: int) -> ObjectID:
        import hashlib

        h = hashlib.sha256(
            f"{self._key}:{seq}".encode()).digest()[:ObjectID.SIZE]
        return ObjectID(h)

    # ------------------------------------------------------------- writing
    def write(self, value: Any, timeout: Optional[float] = 30.0,
              _phase: int = 0) -> None:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        # backpressure: wait until the slot from `capacity` writes ago has
        # been consumed (deleted) by the reader
        if self._wseq >= self.capacity:
            old = self._slot_id(self._wseq - self.capacity)
            _poll(lambda: not w.store.contains(old), timeout,
                  "channel full: reader too slow", phase=_phase)
        sobj = w._serialize_value(value)
        oid = self._slot_id(self._wseq)
        view, handle = w.store.create(oid, sobj.total_size())
        sobj.write_into(view)
        w.store.seal(oid, handle)
        self._wseq += 1

    # ------------------------------------------------------------- reading
    def read(self, timeout: Optional[float] = 30.0,
             _phase: int = 0) -> Any:
        from ray_tpu_torch._private import worker as worker_mod

        w = worker_mod.global_worker
        oid = self._slot_id(self._rseq)
        view_box = []

        def ready() -> bool:
            v = w.store.get_view(oid)
            if v is None:
                return False
            view_box.append(v)
            return True

        _poll(ready, timeout, "channel read timed out", phase=_phase)
        # copy before deserializing: the slot must be deletable immediately
        # (the native arena refuses to delete while a pinned view aliases
        # it, which would wedge the writer's backpressure loop) — so every
        # alias of the view, including view_box's, must die before delete
        data = bytes(view_box[0])
        view_box.clear()
        value = w.serialization_context.deserialize(memoryview(data))
        w.store.delete(oid)
        self._rseq += 1
        return value

    def __reduce__(self):
        return (Channel, (self.capacity, self._key))
