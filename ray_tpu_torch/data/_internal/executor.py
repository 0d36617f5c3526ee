# Copied from ray_tpu/data/_internal/executor.py (ray_tpu -> ray_tpu_torch).
"""Streaming executor.

Reference: python/ray/data/_internal/execution/streaming_executor.py —
a daemon thread runs a scheduling loop (``_scheduling_loop_step``
:241) that polls operator completions, moves bundles downstream, and
dispatches new tasks on the operator chosen by
``select_operator_to_run`` (streaming_executor_state.py:501) under
backpressure. We keep the same shape: bounded in-flight work per operator,
bounded final-output buffer so a slow consumer (the training loop) throttles
upstream reads instead of buffering the dataset in RAM.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.data._internal.physical import (
    PhysicalOperator, RefBundle, UnionOperator, ZipOperator)


class Topology:
    """Operators in topological order plus edges (who feeds whom)."""

    def __init__(self):
        self.ops: List[PhysicalOperator] = []
        self.edges: Dict[int, List[Tuple[int, str]]] = {}  # src -> (dst, port)

    def add(self, op: PhysicalOperator) -> int:
        self.ops.append(op)
        return len(self.ops) - 1

    def connect(self, src: int, dst: int, port: str = "in") -> None:
        self.edges.setdefault(src, []).append((dst, port))


class ExecutorStats:
    """Per-operator execution accounting, rendered like the reference's
    ``ds.stats()`` report (reference: python/ray/data/_internal/stats.py —
    DatasetStats.to_summary / OpRuntimeMetrics, wired through
    streaming_executor.py)."""

    def __init__(self):
        self.start_time = time.perf_counter()
        self.wall_s = 0.0
        self.per_op: List[Dict] = []
        # event-paced drive loop accounting: scheduling-loop
        # iterations and how many ended parked on the wake event — the
        # busy-poll regression guard asserts iters stays O(completions)
        self.loop_iters = 0
        self.idle_waits = 0
        # consumer-side ingest accounting: wall seconds the block
        # iterator spent blocked inside ray_tpu_torch.get despite the prefetch
        # window, and how many blocks it pulled
        self.consumer_stall_s = 0.0
        self.blocks_consumed = 0

    @staticmethod
    def _fmt_bytes(n: int) -> str:
        for unit in ("B", "KB", "MB", "GB"):
            if n < 1024 or unit == "GB":
                return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
            n /= 1024
        return f"{n}B"

    def summary(self) -> str:
        lines = []
        for i, rec in enumerate(self.per_op):
            lines.append(
                f"Operator {i} {rec['name']}: {rec['tasks']} tasks "
                f"executed, {rec['blocks_out']} blocks produced in "
                f"{rec['wall_s']:.2f}s")
            lines.append(
                f"* Rows: {rec['rows_in']} in / {rec['rows_out']} out, "
                f"bytes: {self._fmt_bytes(rec['bytes_in'])} in / "
                f"{self._fmt_bytes(rec['bytes_out'])} out")
            lines.append(
                f"* Task time: {rec['exec_s']:.3f}s total"
                + (f", {rec['exec_s'] / rec['tasks']:.3f}s mean"
                   if rec['tasks'] else ""))
            ex = rec.get("extra") or {}
            if "shuffle_maps" in ex:
                lines.append(
                    f"* Shuffle: {ex['shuffle_maps']} maps -> "
                    f"{ex['shuffle_reducers']} reducers, "
                    f"{self._fmt_bytes(ex['shuffle_shard_bytes'])} shards "
                    f"(peak in-flight "
                    f"{self._fmt_bytes(ex['shuffle_inflight_peak_bytes'])}),"
                    f" stall {ex['shuffle_stall_fraction']:.2f}, "
                    f"re-execs {ex['shuffle_map_reexecs']}")
        lines.append(f"Dataset: {self.wall_s:.2f}s wall, "
                     f"{sum(r['tasks'] for r in self.per_op)} tasks, "
                     f"{self.loop_iters} scheduler iterations "
                     f"({self.idle_waits} idle waits)")
        if self.blocks_consumed:
            lines.append(
                f"Consumer: {self.blocks_consumed} blocks pulled, "
                f"{self.consumer_stall_s:.3f}s stalled on pulls")
        return "\n".join(lines)

    def to_dict(self) -> Dict:
        return {"wall_s": round(self.wall_s, 4), "ops": self.per_op,
                "loop_iters": self.loop_iters,
                "idle_waits": self.idle_waits,
                "consumer_stall_s": round(self.consumer_stall_s, 4),
                "blocks_consumed": self.blocks_consumed}


class StreamingExecutor:
    """Drives a Topology on a daemon thread; final bundles land in a bounded
    queue consumed by ``iter_bundles``.

    The drive loop is EVENT-PACED: when a step makes no
    progress, the thread parks on a wake event instead of busy-polling.
    Wake sources: any memory-store put (every task completion —
    inline value, plasma marker, or error — lands there), consumer
    drains of the output queue (frees the output-buffer policy), and
    shutdown. A bounded fallback wait (``DataContext.exec_idle_wait_s``)
    covers anything that completes without a local put (e.g. a seal
    notification lost to a dying worker)."""

    def __init__(self, topology: Topology, stats: Optional[ExecutorStats] = None):
        from ray_tpu_torch.data.context import DataContext
        from ray_tpu_torch.data._internal.backpressure import (
            DEFAULT_BACKPRESSURE_POLICIES, ResourceManager)

        ctx = DataContext.get_current()
        self.topology = topology
        self.out: "queue.Queue[Optional[RefBundle]]" = queue.Queue()
        self.error: Optional[BaseException] = None
        self.stats = stats or ExecutorStats()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._idle_wait_s = ctx.exec_idle_wait_s
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="raytpu-data-exec")
        self.resource_manager = ResourceManager(
            topology, ctx.execution_memory_limit)
        policy_classes = (ctx.backpressure_policies
                          if ctx.backpressure_policies is not None
                          else DEFAULT_BACKPRESSURE_POLICIES)
        self.policies = [cls(topology, self) for cls in policy_classes]

    def _wake_cb(self) -> None:
        self._wake.set()

    def start(self) -> "StreamingExecutor":
        self._listening_store = None
        try:
            from ray_tpu_torch._private import worker as worker_mod

            w = worker_mod.global_worker
            if w is not None and getattr(w, "memory_store", None) is not None:
                w.memory_store.add_put_listener(self._wake_cb)
                self._listening_store = w.memory_store
        except Exception:
            pass
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)
        store = getattr(self, "_listening_store", None)
        if store is not None:
            store.remove_put_listener(self._wake_cb)
            self._listening_store = None
        for op in self.topology.ops:
            if hasattr(op, "shutdown"):
                op.shutdown()

    # ---------------------------------------------------------------- loop
    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                # clear BEFORE stepping: a completion landing mid-step
                # re-arms the event and the next wait falls through
                self._wake.clear()
                self.stats.loop_iters += 1
                progressed = self._step()
                if self._all_done():
                    break
                if not progressed:
                    self.stats.idle_waits += 1
                    self._wake.wait(self._idle_wait_s)
        except BaseException as e:  # surfaced via iter_bundles
            self.error = e
        finally:
            self._record_stats()
            self.out.put(None)

    def _step(self) -> bool:
        progressed = False
        ops = self.topology.ops
        # 1. poll completions + propagate outputs downstream.
        for i, op in enumerate(ops):
            op.poll()
            while op.output_queue:
                bundle = op.output_queue.popleft()
                dsts = self.topology.edges.get(i, [])
                if not dsts:
                    self.out.put(bundle)
                for dst, port in dsts:
                    target = ops[dst]
                    target._note_input(bundle)
                    if isinstance(target, ZipOperator) and port == "right":
                        target.add_right(bundle)
                    elif isinstance(target, ZipOperator):
                        target.add_left(bundle)
                    else:
                        target.input_queue.append(bundle)
                progressed = True
            # propagate completion edges
            if op.completed():
                for dst, port in self.topology.edges.get(i, []):
                    target = ops[dst]
                    if isinstance(target, UnionOperator):
                        if not getattr(op, f"_union_done_{dst}", False):
                            setattr(op, f"_union_done_{dst}", True)
                            target.branch_done()
                    elif isinstance(target, ZipOperator):
                        if port == "right":
                            target._right_done = True
                        else:
                            target._left_done = True
                    else:
                        target.inputs_complete = True
        # 2. dispatch under the backpressure-policy chain — most-downstream
        #    runnable op first, so the pipeline drains toward the consumer
        #    (reference: select_operator_to_run prefers ops with less queued
        #    output; the policy chain replaces the old hardcoded caps).
        for i in reversed(range(len(ops))):
            op = ops[i]
            while op.can_dispatch() and \
                    all(p.can_dispatch(i) for p in self.policies):
                op.dispatch()
                progressed = True
        return progressed

    def _all_done(self) -> bool:
        return all(op.completed() for op in self.topology.ops) and not any(
            op.output_queue for op in self.topology.ops)

    def _record_stats(self):
        self.stats.wall_s = time.perf_counter() - self.stats.start_time
        per_op = []
        for op in self.topology.ops:
            rec = {"name": op.name, "tasks": op.tasks_launched,
                   "rows": op.rows_out, "rows_in": op.rows_in,
                   "rows_out": op.rows_out, "bytes_in": op.bytes_in,
                   "bytes_out": op.bytes_out, "blocks_out": op.blocks_out,
                   "exec_s": round(op.exec_time_s, 4),
                   "wall_s": round(max(0.0, op.last_activity_t
                                       - op.first_activity_t), 4)}
            extras = op.stats_extras()
            if extras:
                rec["extra"] = extras
            per_op.append(rec)
        self.stats.per_op = per_op

    # ------------------------------------------------------------- consume
    def iter_bundles(self):
        while True:
            bundle = self.out.get()
            # a drained output slot can unblock the output-buffer policy
            self._wake.set()
            if bundle is None:
                if self.error is not None:
                    raise self.error
                return
            yield bundle
