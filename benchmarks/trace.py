"""The device trace of a traced run: ``torch.profiler`` in the process that
holds the card, reduced there to a small summary that travels back to the
harness.

The summary holds the traced window's length, the seconds in which some
kernel ran (the union of the kernels' intervals), each kernel's device
seconds and launches by name, the device seconds of the kernels launched
inside each user range (``Optimizer.step#AdamW.step``, by the range's name
before the ``#``), and the longest idle gaps by what the host was doing: the
host operation that overlaps the gap most."""

from __future__ import annotations

import bisect
import collections
import re
from typing import Any, Dict, List, Optional, Tuple

# Kernel runtime calls: a kernel's correlation id ties it to the call.
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
_MIN_GAP_NS = 20_000  # idle stretches shorter than 20 us are not labelled


class Tracer:
    """``torch.profiler``'s Kineto tracer through its low-level calls, so
    that stopping it collects the events without building Python objects
    for them: ``start``, then ``finish`` (in the thread that started it),
    then ``summary`` (in any thread, later)."""

    def __init__(self):
        self._on = False
        self._t0 = 0.0
        self._result = None

    def start(self) -> None:
        import time

        import torch
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        from torch.autograd.profiler import (
            ProfilerConfig, ProfilerState, _enable_profiler,
            _prepare_profiler)

        if self._on:
            return
        acts = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.add(ProfilerActivity.CUDA)
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                             False, False, _ExperimentalConfig())
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)
        self._on = True
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._on

    def finish(self) -> float:
        """Stop the profiler and keep its events; returns the seconds the
        stop took."""
        import time

        import torch
        from torch.autograd.profiler import _disable_profiler

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t = time.perf_counter()
        window_s = t - self._t0
        self._result = (_disable_profiler(), window_s)
        self._on = False
        return time.perf_counter() - t

    def summary(self) -> Dict[str, Any]:
        import time

        result, window_s = self._result
        t0 = time.perf_counter()
        rows = _rows(result.events())
        out = summarize(rows, window_s)
        out["events"] = len(rows)
        out["reduce_s"] = time.perf_counter() - t0
        self._result = None
        return out


def _rows(events) -> List[Tuple[str, str, int, int, int, bool]]:
    """(kind, name, start ns, end ns, correlation id, user range) of each
    event; kind is "gpu" for device activity, else "cpu"."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    out = []
    for e in events:
        start = e.start_ns()
        out.append(("gpu" if e.device_type() == cuda else "cpu", e.name(),
                    start, start + e.duration_ns(), e.correlation_id(),
                    e.is_user_annotation()))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(rows, window_s: float) -> Dict[str, Any]:
    """The summary of a trace given as ``_rows`` gives it."""
    kernels = [r for r in rows if r[0] == "gpu" and not r[5]
               and r[3] > r[2] and not r[1].startswith("Memcpy")
               and not r[1].startswith("Memset")]
    copies = [r for r in rows if r[0] == "gpu" and not r[5]
              and (r[1].startswith("Memcpy") or r[1].startswith("Memset"))]
    busy = _union([(r[2], r[3]) for r in kernels + copies])
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name: Dict[str, List[float]] = collections.defaultdict(
        lambda: [0.0, 0])
    for r in kernels + copies:
        by_name[r[1]][0] += (r[3] - r[2]) / 1e9
        by_name[r[1]][1] += 1
    # kernels launched inside each user range on the host
    launches = {r[4]: r[2] for r in rows
                if r[0] == "cpu" and r[1] in _LAUNCH_CALLS}
    ranges = sorted((r[2], r[3], r[1].split("#", 1)[0]) for r in rows
                    if r[0] == "cpu" and r[5])
    starts = [s for s, _, _ in ranges]
    in_range: Dict[str, float] = collections.defaultdict(float)
    for r in kernels if ranges else ():
        t = launches.get(r[4])
        if t is None:
            continue
        # the ranges open at the launch: the last few that began before it
        # (ranges of one name do not nest)
        i = bisect.bisect_right(starts, t) - 1
        seen = set()
        for s, e, name in ranges[max(0, i - 7):i + 1]:
            if s <= t <= e and name not in seen:
                seen.add(name)
                in_range[name] += (r[3] - r[2]) / 1e9
    gaps = _idle_gaps(busy, [r for r in rows if r[0] == "cpu" and not r[5]])
    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernels": {k: [v[0], v[1]] for k, v in by_name.items()},
        "ranges": dict(in_range),
        "idle_gaps": gaps,
    }


def _idle_gaps(busy, host_ops, top: int = 10, labelled: int = 5000
               ) -> List[List[Any]]:
    """Idle stretches between busy intervals, summed by the host operation
    that overlaps each most; the ``top`` largest as [label, seconds]. Only
    the ``labelled`` longest stretches are labelled, each against the 64
    host operations that began last before it ended (a launch-bound step
    has tens of thousands of short stretches); the rest are summed under
    one label."""
    gaps = sorted(((busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                   if busy[i + 1][0] - busy[i][1] >= _MIN_GAP_NS),
                  key=lambda g: g[0] - g[1])
    if not gaps:
        return []
    ops = sorted((r[2], r[3], r[1]) for r in host_ops)
    starts = [o[0] for o in ops]
    by_label: Dict[str, float] = collections.defaultdict(float)
    for gs, ge in gaps[:labelled]:
        best, label = 0, "host: no operation traced"
        hi = bisect.bisect_right(starts, ge)
        lo = max(bisect.bisect_left(starts, gs - 2_000_000), hi - 64)
        for s, e, name in ops[lo:hi]:
            ov = min(e, ge) - max(s, gs)
            if ov > best:
                best, label = ov, name
        by_label[label] += (ge - gs) / 1e9
    rest = sum(ge - gs for gs, ge in gaps[labelled:])
    if rest:
        by_label["shorter stretches, not labelled"] += rest / 1e9
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:top]]


_NAME_NOISE = re.compile(r"void |at::native::|[(]anonymous namespace[)]::")


def short_name(name: str) -> str:
    """A kernel's name without its namespaces, cut to 120 characters."""
    return _NAME_NOISE.sub("", name)[:120]


def top_device_ops(summary: Dict[str, Any], top: int = 10
                   ) -> List[List[Any]]:
    ks = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])
    return [[short_name(name), v[0]] for name, v in ks[:top]]


def breakdown(summary: Optional[Dict[str, Any]]) -> Optional[Dict]:
    if not summary:
        return None
    return {"device_ops": top_device_ops(summary),
            "idle_gaps": summary["idle_gaps"][:10]}
