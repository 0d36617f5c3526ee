# Copied from ray_tpu/experimental/tqdm_ray.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Distributed-safe progress bars (reference:
python/ray/experimental/tqdm_ray.py — worker-side bars proxied to the
driver so output interleaves cleanly).

Worker bars report through a named aggregator actor; the driver's log
stream shows consolidated ``[name] k/total`` lines instead of interleaved
escape codes from dozens of processes.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import ray_tpu_torch

_AGGREGATOR_NAME = "__tqdm_ray_aggregator"


class _Aggregator:
    def __init__(self):
        self.bars = {}

    def update(self, bar_id: str, desc: str, n: int, total: Optional[int],
               closed: bool = False):
        self.bars[bar_id] = {"desc": desc, "n": n, "total": total,
                             "closed": closed, "t": time.time()}
        line = " | ".join(
            f"[{b['desc']}] {b['n']}/{b['total'] or '?'}"
            for b in self.bars.values() if not b["closed"])
        if line:
            print(f"\r{line}", end="", file=sys.stderr, flush=True)
        return True

    def state(self):
        return dict(self.bars)


def _get_aggregator():
    try:
        return ray_tpu_torch.get_actor(_AGGREGATOR_NAME)
    except Exception:
        try:
            return ray_tpu_torch.remote(_Aggregator).options(
                name=_AGGREGATOR_NAME, lifetime="detached").remote()
        except Exception:
            return ray_tpu_torch.get_actor(_AGGREGATOR_NAME)  # lost creation race


class tqdm:
    """Drop-in subset of tqdm.tqdm (iterable wrapping, update, close)."""

    def __init__(self, iterable=None, desc: str = "", total: Optional[int]
                 = None, **_kwargs):
        import os

        self._iterable = iterable
        self.desc = desc or "progress"
        self.total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        self.n = 0
        self._id = f"{os.getpid()}-{id(self)}"
        self._agg = None
        self._last_push = 0.0
        try:
            self._agg = _get_aggregator()
        except Exception:
            pass  # outside a cluster: degrade to stderr
        self._push(force=True)

    def _push(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last_push < 0.2:  # rate-limit RPCs
            return
        self._last_push = now
        if self._agg is not None:
            try:
                self._agg.update.remote(self._id, self.desc, self.n,
                                        self.total)
                return
            except Exception:
                self._agg = None
        print(f"\r[{self.desc}] {self.n}/{self.total or '?'}",
              end="", file=sys.stderr, flush=True)

    def update(self, n: int = 1) -> None:
        self.n += n
        self._push()

    def close(self) -> None:
        if self._agg is not None:
            try:
                self._agg.update.remote(self._id, self.desc, self.n,
                                        self.total, True)
            except Exception:
                pass

    def __iter__(self):
        for item in self._iterable:
            yield item
            self.update(1)
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
