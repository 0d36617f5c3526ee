# Copied from ray_tpu/util/iter.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Parallel iterators (reference: python/ray/util/iter.py — from_items /
from_range / ParallelIterator with for_each/filter/batch/gather, sharded
over actors).

Each shard is an actor owning one slice of the source; transformations are
lazy per-shard programs executed where the shard lives. ``gather_sync``
round-robins shard outputs back to the driver.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Iterator, List, TypeVar

import ray_tpu_torch

T = TypeVar("T")


class _ShardActor:
    def __init__(self, items: List, ops: List):
        self._items = items
        self._ops = ops
        self._it: Iterator = iter(())
        self.reset()

    def reset(self):
        def gen():
            for item in self._items:
                out = [item]
                for kind, fn in self._ops:
                    if kind == "for_each":
                        out = [fn(x) for x in out]
                    elif kind == "filter":
                        out = [x for x in out if fn(x)]
                    elif kind == "flatten":
                        out = [y for x in out for y in x]
                yield from out

        self._it = gen()
        return True

    def next_batch(self, n: int) -> List:
        return list(itertools.islice(self._it, n))


class ParallelIterator:
    def __init__(self, source_shards: List[List], ops: List = None):
        self._shards = source_shards
        self._ops = ops or []

    # ------------------------------------------------------- transformations
    def for_each(self, fn: Callable) -> "ParallelIterator":
        return ParallelIterator(self._shards, self._ops + [("for_each", fn)])

    def filter(self, fn: Callable) -> "ParallelIterator":
        return ParallelIterator(self._shards, self._ops + [("filter", fn)])

    def flatten(self) -> "ParallelIterator":
        return ParallelIterator(self._shards, self._ops + [("flatten", None)])

    def batch(self, n: int) -> "_BatchedIterator":
        """Gather-side batching (shard programs stay stateless)."""
        return _BatchedIterator(self, n)

    def num_shards(self) -> int:
        return len(self._shards)

    # --------------------------------------------------------------- gather
    def gather_sync(self, batch: int = 64) -> Iterator[Any]:
        actors = [ray_tpu_torch.remote(_ShardActor).remote(s, self._ops)
                  for s in self._shards]
        try:
            live = list(actors)
            while live:
                refs = [a.next_batch.remote(batch) for a in live]
                results = ray_tpu_torch.get(refs, timeout=300)
                nxt = []
                for a, chunk in zip(live, results):
                    if chunk:
                        nxt.append(a)
                        yield from chunk
                live = nxt
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass

    def __iter__(self) -> Iterator[Any]:
        return self.gather_sync()

    def take(self, n: int) -> List:
        out = []
        for item in self:
            out.append(item)
            if len(out) >= n:
                break
        return out


class _BatchedIterator:
    def __init__(self, parent: ParallelIterator, n: int):
        self._parent = parent
        self._n = n

    def __iter__(self):
        buf: List = []
        for item in self._parent:
            buf.append(item)
            if len(buf) == self._n:
                yield list(buf)
                buf.clear()
        if buf:
            yield buf

    def take(self, n: int) -> List:
        out = []
        for item in self:
            out.append(item)
            if len(out) >= n:
                break
        return out


def from_items(items: List[T], num_shards: int = 2) -> ParallelIterator:
    shards: List[List] = [[] for _ in range(num_shards)]
    for i, item in enumerate(items):
        shards[i % num_shards].append(item)
    return ParallelIterator(shards)


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return from_items(list(range(n)), num_shards)
