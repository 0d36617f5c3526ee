# Copied from ray_tpu/util/multiprocessing/pool.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Pool implementation (reference: python/ray/util/multiprocessing/pool.py:
Pool's map/imap/apply family executed by a pool of actors so chunks inherit
the cluster's scheduling + fault tolerance instead of local forks)."""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class _PoolWorker:
    """One actor per pool slot; runs chunks of work."""

    def run_chunk(self, fn, chunk: List, is_starmap: bool, kwargs=None):
        if is_starmap:
            return [fn(*args, **(kwargs or {})) for args in chunk]
        return [fn(item, **(kwargs or {})) for item in chunk]


class AsyncResult:
    def __init__(self, refs: List, single: bool = False):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        parts = ray_tpu_torch.get(self._refs, timeout=timeout)
        flat = [x for part in parts for x in part]
        return flat[0] if self._single else flat

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                     timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                                timeout=0)
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """API-compatible subset of multiprocessing.Pool: apply, apply_async,
    map, map_async, starmap, imap, imap_unordered, close/terminate/join."""

    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = (), ray_remote_args: Optional[dict] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(int(ray_tpu_torch.cluster_resources().get("CPU", 1)), 1)
        self._size = processes
        args = ray_remote_args or {"resources": {"CPU": 1}}
        worker_cls = ray_tpu_torch.remote(_PoolWorker)
        if initializer is not None:
            init = initializer  # run per-actor before first chunk

            class _InitWorker(_PoolWorker):
                def __init__(self):
                    init(*initargs)

            worker_cls = ray_tpu_torch.remote(_InitWorker)
        self._workers = [worker_cls.options(**args).remote()
                         for _ in range(processes)]
        self._rr = itertools.cycle(range(processes))
        self._closed = False
        self._lock = threading.Lock()

    def _next_worker(self):
        with self._lock:
            return self._workers[next(self._rr)]

    def _check_open(self):
        if self._closed:
            raise ValueError("Pool not running")

    # ----------------------------------------------------------------- api
    def apply(self, fn: Callable, args: tuple = (), kwds: Optional[dict]
              = None) -> Any:
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check_open()
        ref = self._next_worker().run_chunk.remote(fn, [args], True, kwds)
        return AsyncResult([ref], single=True)

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        self._check_open()
        refs = [self._next_worker().run_chunk.remote(fn, chunk, False)
                for chunk in self._chunks(iterable, chunksize)]
        return AsyncResult(refs)

    def starmap(self, fn: Callable, iterable: Iterable,
                chunksize: Optional[int] = None) -> List:
        self._check_open()
        refs = [self._next_worker().run_chunk.remote(fn, chunk, True)
                for chunk in self._chunks(iterable, chunksize)]
        return AsyncResult(refs).get()

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: int = 1):
        self._check_open()
        refs = [self._next_worker().run_chunk.remote(fn, chunk, False)
                for chunk in self._chunks(iterable, chunksize)]
        for ref in refs:  # submission order
            for item in ray_tpu_torch.get(ref):
                yield item

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: int = 1):
        self._check_open()
        refs = [self._next_worker().run_chunk.remote(fn, chunk, False)
                for chunk in self._chunks(iterable, chunksize)]
        pending = list(refs)
        while pending:
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for item in ray_tpu_torch.get(ready[0]):
                yield item

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        # raylint: disable=R13 -- monotonic GIL-atomic bool flip (False
        # ->True only, mirroring close()); racy readers at worst submit
        # to a closing pool, which terminate's kill loop handles anyway
        self._closed = True
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
