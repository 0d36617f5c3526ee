# Ported from ray_tpu/data/iterator.py (ray_tpu -> ray_tpu_torch).
"""DataIterator: batch-level consumption of a block stream.

Reference: python/ray/data/iterator.py (iter_batches, iter_torch_batches).
Port of ``ray_tpu/data/iterator.py``: its ``iter_jax_batches`` (to the
device, optionally onto a ``NamedSharding``) and its CPU-only
``iter_torch_batches`` meet in one ``iter_torch_batches`` that ships each
batch to the card — optionally as DTensors on a mesh, each rank's rows its
shard — with background prefetch so the host-to-device copy overlaps the
train step.

Ingest is stall-free end to end: the underlying block stream
(``Dataset._iter_blocks``) initiates the next
``DataContext.iter_prefetch_blocks`` blocks' pulls one batched
non-blocking WaitObjects window ahead of consumption, so the network
transfer of block N+1 overlaps decode/batch/device-put of block N; the
``_prefetch`` thread below then overlaps host→device transfer with the
consumer. Residual time blocked on pulls is reported as
``consumer_stall_s`` in ``ExecutorStats`` (visible via ``stats()``).
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor


class _Batcher:
    """Re-chunk a stream of blocks into fixed-size batches."""

    def __init__(self, batch_size: Optional[int], drop_last: bool = False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self._buffer: collections.deque = collections.deque()
        self._buffered_rows = 0

    def add(self, block: Block) -> None:
        n = BlockAccessor(block).num_rows()
        if n:
            self._buffer.append(block)
            # raylint: disable=R13 -- single-consumer protocol: one
            # _Batcher instance is only ever driven by the one iterator
            # that owns it; the two domains the linter sees are distinct
            # pipelines with distinct instances, never one shared batcher
            self._buffered_rows += n

    def next_batches(self, final: bool = False) -> Iterator[Block]:
        bs = self.batch_size
        if bs is None:
            while self._buffer:
                self._buffered_rows -= BlockAccessor(
                    self._buffer[0]).num_rows()
                yield self._buffer.popleft()
            return
        while self._buffered_rows >= bs:
            yield self._take(bs)
        if final and self._buffered_rows and not self.drop_last:
            yield self._take(self._buffered_rows)

    def _take(self, n: int) -> Block:
        parts = []
        got = 0
        while got < n:
            block = self._buffer.popleft()
            acc = BlockAccessor(block)
            rows = acc.num_rows()
            if got + rows <= n:
                parts.append(block)
                got += rows
            else:
                need = n - got
                parts.append(acc.slice(0, need))
                self._buffer.appendleft(acc.slice(need, rows))
                got = n
        self._buffered_rows -= n
        return BlockAccessor.concat(parts)


class DataIterator:
    """Iterates batches over a (re-executable) stream of blocks."""

    def __init__(self, block_fn: Callable[[], Iterator[Block]],
                 stats_fn: Optional[Callable[[], str]] = None):
        self._block_fn = block_fn
        self._stats_fn = stats_fn

    def iter_blocks(self) -> Iterator[Block]:
        return self._block_fn()

    def iter_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
        prefetch_batches: int = 1,
    ) -> Iterator[Any]:
        def gen():
            batcher = _Batcher(batch_size, drop_last)
            shuffler = (_LocalShuffler(local_shuffle_buffer_size,
                                       local_shuffle_seed)
                        if local_shuffle_buffer_size else None)
            source = self.iter_blocks()
            if shuffler is not None:
                source = shuffler.shuffle(source)
            for block in source:
                batcher.add(block)
                for b in batcher.next_batches():
                    yield BlockAccessor(b).to_batch(batch_format)
            for b in batcher.next_batches(final=True):
                yield BlockAccessor(b).to_batch(batch_format)

        if prefetch_batches and prefetch_batches > 0:
            return _prefetch(gen(), prefetch_batches)
        return gen()

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for block in self.iter_blocks():
            yield from BlockAccessor(block).iter_rows()

    def iter_torch_batches(
        self,
        *,
        batch_size: Optional[int] = 256,
        dtypes: Optional[Dict[str, Any]] = None,
        sharding=None,
        device=None,
        drop_last: Optional[bool] = None,
        local_shuffle_buffer_size: Optional[int] = None,
        prefetch_batches: int = 2,
    ) -> Iterator[Dict[str, Any]]:
        """Batches as torch tensors on the card (``device`` None), or on
        ``device`` when asked (``device="cpu"``).

        ``dtypes`` maps a column to a ``torch.dtype``. ``sharding`` (a
        ``parallel.sharding.NamedSharding``) makes each column a DTensor
        on that mesh, laid out by the spec, its batch dim sharded: this
        rank's rows are its local shard (``jax.device_put(v, sharding)``
        cuts one global batch; here every rank iterates its own shard of
        the dataset, as each rank of a process group does). The mesh is
        carried by the argument, not taken from the ambient one, because
        the copy runs on the prefetch thread. ``drop_last`` None drops a
        short last batch on the card and on a mesh (fixed shapes), and
        keeps it on the CPU. Object columns (strings, bytes) stay numpy.
        """
        import torch

        from ray_tpu_torch._private.device import resolve_device

        if sharding is not None:
            from torch.distributed.tensor import DTensor

            from ray_tpu_torch.parallel.sharding import (
                PartitionSpec, spec_to_placements)

            mesh = sharding.mesh
            dev = resolve_device(mesh.device_type)
        else:
            dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # the prefetch thread does not inherit this thread's device
            dev = torch.device("cuda", torch.cuda.current_device())
        if drop_last is None:
            drop_last = sharding is not None or dev.type != "cpu"

        def to_torch(batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
            out = {}
            for k, v in batch.items():
                if v.dtype == object:
                    out[k] = v
                    continue
                t = torch.from_numpy(np.ascontiguousarray(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                t = t.to(dev)
                if sharding is not None:
                    spec = PartitionSpec(*tuple(sharding.spec)[:t.dim()])
                    t = DTensor.from_local(
                        t, mesh, spec_to_placements(spec, mesh),
                        run_check=False)
                out[k] = t
            return out

        it = self.iter_batches(
            batch_size=batch_size, batch_format="numpy",
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            prefetch_batches=0)
        return _prefetch(map(to_torch, it), prefetch_batches)

    def materialize(self):
        from ray_tpu_torch.data.dataset import from_blocks

        return from_blocks(list(self.iter_blocks()))

    def stats(self) -> str:
        return self._stats_fn() if self._stats_fn else ""


class _LocalShuffler:
    def __init__(self, buffer_rows: int, seed: Optional[int]):
        self.buffer_rows = buffer_rows
        self.rng = np.random.default_rng(seed)

    def shuffle(self, blocks: Iterator[Block]) -> Iterator[Block]:
        held = []
        held_rows = 0
        for block in blocks:
            held.append(block)
            held_rows += BlockAccessor(block).num_rows()
            if held_rows >= self.buffer_rows:
                merged = BlockAccessor.concat(held)
                acc = BlockAccessor(merged)
                yield acc.take_indices(self.rng.permutation(acc.num_rows()))
                held, held_rows = [], 0
        if held:
            merged = BlockAccessor.concat(held)
            acc = BlockAccessor(merged)
            yield acc.take_indices(self.rng.permutation(acc.num_rows()))


def _prefetch(it: Iterator, depth: int) -> Iterator:
    """Run the source iterator on a thread, buffering ``depth`` items.

    An abandoned consumer (``break`` mid-loop) closes this generator; the
    worker sees the stop flag on its next bounded put, closes the source
    iterator (which tears down the StreamingExecutor via its ``finally``)
    and exits instead of leaking a thread blocked on ``q.put``."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    DONE = object()
    err: list = []
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    break
        except BaseException as e:
            err.append(e)
        finally:
            if stop.is_set():
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
            q.put(DONE)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
