"""Exceptions the port raises, copied from ``ray_tpu/exceptions.py``.

Only what the port uses: the base class and ``BackPressureError``, which the
continuous batching engine raises when its pending cap sheds a request.
"""

from __future__ import annotations

from typing import Dict, Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class BackPressureError(RayTpuError):
    """The serving plane shed this request: every candidate replica's
    admission queue was full (``max_queued_requests``), or a batching
    engine's pending cap was hit. Typed so clients can tell overload
    (retry later, with backoff, against a load-shedding system that
    stays responsive) from failure — the replacement for the old
    reject-and-spin retry loop (reference: serve's
    ``BackPressureError`` on ``max_queued_requests``)."""

    def __init__(self, message: str = "",
                 deployment: str = "",
                 queue_depths: Optional[Dict[str, int]] = None):
        self.deployment = deployment
        self.queue_depths = dict(queue_depths or {})
        if not message:
            message = (f"request to {deployment or 'deployment'} shed under "
                       f"backpressure")
            if self.queue_depths:
                depths = ", ".join(
                    f"{n[-18:]}={d}" for n, d in self.queue_depths.items())
                message += f" (queue depths: {depths})"
        super().__init__(message)
        self.message = message

    def __reduce__(self):
        return (_rebuild_backpressure_error,
                (self.message, self.deployment, self.queue_depths))


def _rebuild_backpressure_error(message, deployment, queue_depths):
    return BackPressureError(message, deployment, queue_depths)
