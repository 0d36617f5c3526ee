# Copied from ray_tpu/data/context.py (ray_tpu -> ray_tpu_torch).
"""DataContext — per-process execution configuration (reference:
python/ray/data/context.py DataContext / DatasetContext: a thread-safe
singleton of tunables read by the planner and streaming executor).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import ClassVar, Optional

from ray_tpu_torch._private.config import CONFIG


@dataclasses.dataclass
class DataContext:
    """Knobs for the streaming execution engine.

    - ``read_parallelism``: default number of read tasks per datasource
    - ``max_tasks_in_flight_per_op``: bounded concurrent tasks per map op
    - ``per_op_buffer``: bundles buffered between operators (backpressure)
    - ``output_buffer``: bundles buffered at the consumer edge

    The ``shuffle_*`` / ``iter_prefetch`` / ``exec_idle_wait`` knobs
    seed from the
    ``data_*`` config flags so they stay env-overridable per process.
    """

    read_parallelism: int = 8
    max_tasks_in_flight_per_op: int = 8
    per_op_buffer: int = 32
    output_buffer: int = 16
    # bytes of queued block payload the pipeline may hold before dispatch
    # is restricted to the most-downstream op (0 = unlimited); enforced by
    # ResourceBudgetBackpressurePolicy via the ResourceManager
    execution_memory_limit: int = 0
    # policy classes consulted on every dispatch (None = defaults:
    # concurrency cap, streaming output buffer, resource budget)
    backpressure_policies: Optional[list] = None
    # --- streaming shuffle ---
    # False = legacy materializing AllToAll exchange for shuffle/sort
    streaming_shuffle: bool = dataclasses.field(
        default_factory=lambda: bool(CONFIG.data_streaming_shuffle))
    # byte budget over admitted-but-unfinished reducers' input shards
    shuffle_max_inflight_shard_bytes: int = dataclasses.field(
        default_factory=lambda: int(CONFIG.data_shuffle_inflight_bytes))
    shuffle_max_reduce_retries: int = dataclasses.field(
        default_factory=lambda: int(
            CONFIG.data_shuffle_max_reduce_retries))
    shuffle_max_concurrency: int = dataclasses.field(
        default_factory=lambda: int(CONFIG.data_shuffle_max_concurrency))
    # extra .options() for shuffle map / reduce tasks (resource pinning)
    shuffle_map_remote_args: Optional[dict] = None
    shuffle_reduce_remote_args: Optional[dict] = None
    # consumer-side block prefetch window (Dataset._iter_blocks)
    iter_prefetch_blocks: int = dataclasses.field(
        default_factory=lambda: int(CONFIG.data_iter_prefetch_blocks))
    # executor drive loop fallback wake period (event-paced)
    exec_idle_wait_s: float = dataclasses.field(
        default_factory=lambda: float(CONFIG.data_exec_idle_wait_s))

    _lock: ClassVar[threading.Lock] = threading.Lock()
    _current: ClassVar[Optional["DataContext"]] = None

    @classmethod
    def get_current(cls) -> "DataContext":
        with cls._lock:
            if cls._current is None:
                cls._current = cls()
            return cls._current

    @classmethod
    def _set_current(cls, ctx: "DataContext") -> None:
        with cls._lock:
            cls._current = ctx
