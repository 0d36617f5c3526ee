# Copied from ray_tpu/util/tracing/tracing_helper.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""OpenTelemetry-optional tracing (reference:
python/ray/util/tracing/tracing_helper.py — lazy opentelemetry import at
:36-57, context inject/extract around task submit/execute).

``opentelemetry`` is not bundled; when absent every helper degrades to a
no-op so instrumented code never pays for the option. Spans also mirror
into the task-event timeline so ``ray_tpu_torch.timeline()`` shows user spans
next to task lifecycles even without an OTel backend.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Dict, Iterator, Optional

_tracer = None
_checked = False


def trace_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_TRACING_ENABLED", "0") == "1"


def get_tracer():
    """The opentelemetry tracer, or None when the SDK is unavailable."""
    global _tracer, _checked
    if _checked:
        return _tracer
    _checked = True
    if not trace_enabled():
        return None
    try:
        from opentelemetry import trace  # optional dependency

        _tracer = trace.get_tracer("ray_tpu_torch")
    except ImportError:
        _tracer = None
    return _tracer


@contextlib.contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None
         ) -> Iterator[None]:
    """Context manager: an OTel span when available, else a timeline event."""
    tracer = get_tracer()
    start = time.time()
    if tracer is not None:
        with tracer.start_as_current_span(name, attributes=attributes or {}):
            yield
        return
    try:
        yield
    finally:
        _mirror_to_timeline(name, start, time.time(), attributes)


def _mirror_to_timeline(name: str, start: float, end: float,
                        attributes: Optional[Dict]) -> None:
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None or not getattr(w, "connected", False):
        return
    key = f"span-{os.getpid()}-{start:.6f}"
    for state, ts in (("PENDING", start), ("FINISHED", end)):
        w.task_events.append({
            "task_id": key,
            "job_id": w.job_id.hex() if w.job_id else "",
            "name": f"span::{name}", "state": state, "type": 0,
            "time": ts, "node_id": w.node_id or "",
        })


def traced(name: Optional[str] = None):
    """Decorator form of ``span``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name or fn.__qualname__):
                return fn(*args, **kwargs)

        return wrapper

    return deco
