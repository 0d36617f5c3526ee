# Copied from ray_tpu/data/_internal/physical.py (ray_tpu -> ray_tpu_torch).
"""Physical operators for the streaming executor.

Reference: python/ray/data/_internal/execution/operators/ —
``TaskPoolMapOperator``, ``ActorPoolMapOperator``, ``InputDataBuffer``,
limit/union/zip, and the all-to-all planner (_internal/planner/). Blocks flow
as ``RefBundle``s (block ObjectRef + metadata); payloads stay in the object
store and only metadata crosses the executor.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data._internal.logical import MapSpec


class RefBundle:
    __slots__ = ("block_ref", "meta")

    def __init__(self, block_ref, meta: BlockMetadata):
        self.block_ref = block_ref
        self.meta = meta


# --------------------------------------------------------------------- UDFs
def _apply_specs(specs: List[MapSpec], block: Block) -> Block:
    """Run a fused chain of transforms over one block inside a task.

    Zero-copy fusion (reference: _internal/logical/rules/
    zero_copy_map_fusion.py): a RUN of consecutive whole-block "batches"
    transforms with the same batch_format passes each UDF's output batch
    STRAIGHT into the next UDF — no block materialization + re-extraction
    round-trip between fused stages."""
    acc = BlockAccessor(block)
    i = 0
    while i < len(specs):
        spec = specs[i]
        fn = spec.fn
        kwargs = spec.fn_kwargs or {}
        if spec.kind == "batches":
            bs = spec.batch_size
            n = acc.num_rows()
            if bs is None or n <= bs:
                fmt = spec.batch_format
                out = acc.to_batch(fmt)
                # drain the whole same-format whole-block run zero-copy;
                # n is re-derived after every UDF — an expanding UDF must
                # not smuggle an oversized batch past a downstream
                # batch_size (fixed-shape jitted fns depend on it)
                while i < len(specs) and specs[i].kind == "batches" \
                        and specs[i].batch_format == fmt \
                        and (specs[i].batch_size is None
                             or n <= specs[i].batch_size):
                    s = specs[i]
                    out = s.fn(out, *s.fn_args, **(s.fn_kwargs or {}))
                    i += 1
                    try:
                        n = len(next(iter(out.values())))
                    except Exception:
                        break  # unknown shape: fall back to block path
                block = BlockAccessor.batch_to_block(out)
                acc = BlockAccessor(block)
                continue
            else:
                # honor batch_size by re-chunking the block — critical for
                # fixed-shape jitted UDFs (reference: block_batching/)
                outs = []
                for s in range(0, n, bs):
                    chunk = BlockAccessor(acc.slice(s, min(s + bs, n)))
                    out = fn(chunk.to_batch(spec.batch_format),
                             *spec.fn_args, **kwargs)
                    outs.append(BlockAccessor.batch_to_block(out))
                block = BlockAccessor.concat(outs)
        elif spec.kind == "rows":
            rows = [fn(r, *spec.fn_args, **kwargs) for r in acc.iter_rows()]
            block = BlockAccessor.rows_to_block(rows)
        elif spec.kind == "flat":
            rows = []
            for r in acc.iter_rows():
                rows.extend(fn(r, *spec.fn_args, **kwargs))
            block = BlockAccessor.rows_to_block(rows)
        elif spec.kind == "block":
            # whole-block transform (zero-copy Arrow ops: select/drop/rename)
            block = fn(block, *spec.fn_args, **kwargs)
        elif spec.kind == "filter":
            keep = np.asarray(
                [bool(fn(r, *spec.fn_args, **kwargs))
                 for r in acc.iter_rows()])
            idx = np.nonzero(keep)[0]
            block = acc.take_indices(idx)
        else:
            raise ValueError(f"unknown map kind {spec.kind!r}")
        acc = BlockAccessor(block)
        i += 1
    return block


def _map_task(specs: List[MapSpec], block: Block):
    t0 = time.perf_counter()
    out = _apply_specs(specs, block)
    meta = BlockAccessor(out).metadata(exec_time_s=time.perf_counter() - t0)
    return out, meta


def _read_task(read_fn: Callable[[], Any], specs: List[MapSpec]):
    """Run a datasource read and any fused transforms; one output block."""
    t0 = time.perf_counter()
    out = read_fn()
    blocks = list(out) if isinstance(out, (list, tuple)) else [out]
    blocks = [BlockAccessor.batch_to_block(b) if isinstance(b, (dict, list))
              else b for b in blocks]
    block = BlockAccessor.concat(blocks) if len(blocks) != 1 else blocks[0]
    if specs:
        block = _apply_specs(specs, block)
    meta = BlockAccessor(block).metadata(exec_time_s=time.perf_counter() - t0)
    return block, meta


class _MapWorker:
    """Actor for class-based UDFs (reference: ActorPoolMapOperator's
    _MapWorker). The UDF class is constructed once per actor; batches stream
    through it — the pattern for carrying an expensive jitted model."""

    def __init__(self, fn_cls_blob: bytes, args: tuple, kwargs: dict):
        import cloudpickle

        cls = cloudpickle.loads(fn_cls_blob)
        self._udf = cls(*args, **(kwargs or {}))

    def map(self, specs: List[MapSpec], block: Block):
        specs = [MapSpec(**{**s.__dict__, "fn": self._udf})
                 if s.fn is None else s for s in specs]
        return _map_task(specs, block)

    def ready(self):
        return True


# ---------------------------------------------------------------- operators
class PhysicalOperator:
    """Base: pull bundles from ``input_queue``, expose them on
    ``output_queue``. The executor wires queues and drives ``poll``/
    ``dispatch``."""

    def __init__(self, name: str):
        self.name = name
        self.input_queue: collections.deque = collections.deque()
        self.output_queue: collections.deque = collections.deque()
        self.inputs_complete = False
        # per-operator accounting surfaced by Dataset.stats() (reference:
        # python/ray/data/_internal/stats.py OpRuntimeMetrics)
        self.rows_in = 0
        self.bytes_in = 0
        self.rows_out = 0
        self.bytes_out = 0
        self.blocks_out = 0
        self.exec_time_s = 0.0
        self.tasks_launched = 0
        self.first_activity_t: float = 0.0
        self.last_activity_t: float = 0.0

    # --- scheduling interface
    def num_active_tasks(self) -> int:
        return 0

    def can_dispatch(self) -> bool:
        return bool(self.input_queue)

    def dispatch(self) -> None:
        raise NotImplementedError

    def poll(self) -> None:
        pass

    def all_inputs_done(self) -> None:
        self.inputs_complete = True

    def completed(self) -> bool:
        return (self.inputs_complete and not self.input_queue
                and self.num_active_tasks() == 0)

    def extra_usage_bytes(self) -> int:
        """Bytes this operator holds OUTSIDE its input/output queues
        (e.g. the shuffle's sealed shards); counted by the
        ResourceManager toward the global memory budget."""
        return 0

    def stats_extras(self) -> Dict:
        """Operator-specific counters merged into the stats record."""
        return {}

    def _emit(self, bundle: RefBundle) -> None:
        import time as _t

        now = _t.perf_counter()
        if not self.first_activity_t:
            self.first_activity_t = now
        self.last_activity_t = now
        self.rows_out += bundle.meta.num_rows
        self.bytes_out += bundle.meta.size_bytes or 0
        self.blocks_out += 1
        self.exec_time_s += bundle.meta.exec_time_s
        self.output_queue.append(bundle)

    def _note_input(self, bundle: RefBundle) -> None:
        import time as _t

        if not self.first_activity_t:
            self.first_activity_t = _t.perf_counter()
        self.rows_in += bundle.meta.num_rows
        self.bytes_in += bundle.meta.size_bytes or 0


class InputDataBuffer(PhysicalOperator):
    def __init__(self, bundles: List[RefBundle]):
        super().__init__("Input")
        self.output_queue.extend(bundles)
        self.inputs_complete = True

    def can_dispatch(self) -> bool:
        return False

    def completed(self) -> bool:
        return True


class TaskPoolMapOperator(PhysicalOperator):
    """Map via stateless tasks; also hosts fused Read stages
    (reference: operators/task_pool_map_operator.py)."""

    def __init__(self, name: str, specs: List[MapSpec],
                 read_tasks: Optional[List[Callable]] = None,
                 max_concurrency: Optional[int] = None,
                 ray_remote_args: Optional[Dict] = None):
        super().__init__(name)
        self.specs = specs
        if max_concurrency is None:
            from ray_tpu_torch.data.context import DataContext

            max_concurrency = \
                DataContext.get_current().max_tasks_in_flight_per_op
        self.max_concurrency = max_concurrency
        self.ray_remote_args = dict(ray_remote_args or {})
        self._inflight: List[Tuple[Any, Any]] = []  # (block_ref, meta_ref)
        if read_tasks is not None:
            self.input_queue.extend(read_tasks)
            self.inputs_complete = True
        self._is_read = read_tasks is not None

    def num_active_tasks(self) -> int:
        return len(self._inflight)

    def can_dispatch(self) -> bool:
        # the concurrency cap lives in ConcurrencyCapBackpressurePolicy
        # (data/_internal/backpressure.py) — ONE source of truth, so
        # replacing the policy chain actually changes the rule
        return bool(self.input_queue)

    def dispatch(self) -> None:
        item = self.input_queue.popleft()
        opts = {"num_returns": 2, "name": f"Data::{self.name}",
                **self.ray_remote_args}
        if self._is_read:
            refs = ray_tpu_torch.remote(_read_task).options(**opts).remote(
                item, self.specs)
        else:
            refs = ray_tpu_torch.remote(_map_task).options(**opts).remote(
                self.specs, item.block_ref)
        self.tasks_launched += 1
        self._inflight.append((refs[0], refs[1]))

    def poll(self) -> None:
        # Emit strictly in dispatch order so downstream zip/take see blocks
        # in input order (reference: execution_options.preserve_order).
        while self._inflight:
            block_ref, meta_ref = self._inflight[0]
            ready, _ = ray_tpu_torch.wait([meta_ref], num_returns=1, timeout=0)
            if not ready:
                return
            self._inflight.pop(0)
            meta = ray_tpu_torch.get(meta_ref)  # raises on task error
            self._emit(RefBundle(block_ref, meta))


class ActorPoolMapOperator(PhysicalOperator):
    """Map via a fixed pool of UDF actors
    (reference: operators/actor_pool_map_operator.py)."""

    MAX_TASKS_PER_ACTOR = 2

    def __init__(self, name: str, specs: List[MapSpec], fn_cls,
                 pool_size: int = 2,
                 fn_constructor_args: tuple = (),
                 fn_constructor_kwargs: Optional[dict] = None,
                 ray_remote_args: Optional[Dict] = None):
        super().__init__(name)
        import cloudpickle

        self.specs = [MapSpec(**{**s.__dict__, "fn": None}) for s in specs]
        self._actors = []
        self._load: Dict[int, int] = {}
        blob = cloudpickle.dumps(fn_cls)
        opts = dict(ray_remote_args or {})
        actor_cls = ray_tpu_torch.remote(_MapWorker)
        for i in range(pool_size):
            a = (actor_cls.options(**opts) if opts else actor_cls).remote(
                blob, fn_constructor_args, fn_constructor_kwargs or {})
            self._actors.append(a)
            self._load[i] = 0
        self._inflight: List[Tuple[int, Any, Any]] = []

    def num_active_tasks(self) -> int:
        return len(self._inflight)

    def can_dispatch(self) -> bool:
        return (bool(self.input_queue)
                and any(v < self.MAX_TASKS_PER_ACTOR
                        for v in self._load.values()))

    def dispatch(self) -> None:
        idx = min(self._load, key=self._load.get)
        bundle = self.input_queue.popleft()
        refs = self._actors[idx].map.options(num_returns=2).remote(
            self.specs, bundle.block_ref)
        self.tasks_launched += 1
        self._load[idx] += 1
        self._inflight.append((idx, refs[0], refs[1]))

    def poll(self) -> None:
        while self._inflight:
            idx, block_ref, meta_ref = self._inflight[0]
            ready, _ = ray_tpu_torch.wait([meta_ref], num_returns=1, timeout=0)
            if not ready:
                return
            self._inflight.pop(0)
            meta = ray_tpu_torch.get(meta_ref)
            self._load[idx] -= 1
            self._emit(RefBundle(block_ref, meta))

    def shutdown(self) -> None:
        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class LimitOperator(PhysicalOperator):
    def __init__(self, limit: int):
        super().__init__(f"Limit[{limit}]")
        self.limit = limit
        self._taken = 0
        # the one boundary-slice task in flight: (block_ref, meta_ref).
        # Its metadata resolves in poll() — the old synchronous
        # ray_tpu_torch.get here stalled the whole scheduling loop for a full
        # task round trip.
        self._slice_inflight: Optional[Tuple[Any, Any]] = None

    def num_active_tasks(self) -> int:
        return 1 if self._slice_inflight else 0

    def can_dispatch(self) -> bool:
        return (bool(self.input_queue) and self._taken < self.limit
                and self._slice_inflight is None)

    def dispatch(self) -> None:
        bundle = self.input_queue.popleft()
        remaining = self.limit - self._taken
        if bundle.meta.num_rows <= remaining:
            self._taken += bundle.meta.num_rows
            self._emit(bundle)
        else:
            refs = ray_tpu_torch.remote(_slice_task).options(num_returns=2).remote(
                bundle.block_ref, 0, remaining)
            self.tasks_launched += 1
            # the slice is exactly `remaining` rows (the bundle had
            # more): account now so the limit closes without waiting
            self._taken += remaining
            self._slice_inflight = (refs[0], refs[1])

    def poll(self) -> None:
        if self._slice_inflight is not None:
            block_ref, meta_ref = self._slice_inflight
            ready, _ = ray_tpu_torch.wait([meta_ref], num_returns=1, timeout=0)
            if ready:
                self._slice_inflight = None
                self._emit(RefBundle(block_ref, ray_tpu_torch.get(meta_ref)))
        if self._taken >= self.limit:
            self.input_queue.clear()
            self.inputs_complete = True

    def completed(self) -> bool:
        if self._slice_inflight is not None:
            return False
        return self._taken >= self.limit or super().completed()


def _slice_task(block: Block, start: int, end: int):
    out = BlockAccessor(block).slice(start, end)
    return out, BlockAccessor(out).metadata()


class AllToAllOperator(PhysicalOperator):
    """Barrier operator: buffers every input bundle, then runs ``bulk_fn``
    once (reference: planner/exchange/ shuffle task scheme)."""

    def __init__(self, name: str,
                 bulk_fn: Callable[[List[RefBundle]], List[RefBundle]]):
        super().__init__(name)
        self.bulk_fn = bulk_fn
        self._ran = False

    def can_dispatch(self) -> bool:
        return self.inputs_complete and not self._ran

    def dispatch(self) -> None:
        bundles = list(self.input_queue)
        self.input_queue.clear()
        t0 = time.perf_counter()
        for out in self.bulk_fn(bundles):
            self._emit(out)
        self.exec_time_s += time.perf_counter() - t0
        self._ran = True

    def completed(self) -> bool:
        return self._ran


class UnionOperator(PhysicalOperator):
    """Pass-through merge of several upstream branches; the executor wires
    every branch's output here."""

    def __init__(self, n_branches: int):
        super().__init__("Union")
        self._branches_done = 0
        self.n_branches = n_branches

    def can_dispatch(self) -> bool:
        return bool(self.input_queue)

    def dispatch(self) -> None:
        self._emit(self.input_queue.popleft())

    def branch_done(self) -> None:
        self._branches_done += 1
        if self._branches_done >= self.n_branches:
            self.inputs_complete = True


class ZipOperator(PhysicalOperator):
    """Barrier zip of two branches by row position."""

    def __init__(self):
        super().__init__("Zip")
        self.left: List[RefBundle] = []
        self.right: List[RefBundle] = []
        self._left_done = False
        self._right_done = False
        self._ran = False
        self._inflight: Optional[Tuple[Any, Any]] = None

    def add_left(self, b: RefBundle):
        self.left.append(b)

    def add_right(self, b: RefBundle):
        self.right.append(b)

    def can_dispatch(self) -> bool:
        return self._left_done and self._right_done and not self._ran

    def dispatch(self) -> None:
        lrefs = [b.block_ref for b in self.left]
        rrefs = [b.block_ref for b in self.right]
        refs = ray_tpu_torch.remote(_zip_task).options(num_returns=2).remote(
            lrefs, rrefs)
        self.tasks_launched += 1
        self._inflight = (refs[0], refs[1])
        self._ran = True

    def num_active_tasks(self) -> int:
        return 1 if getattr(self, "_inflight", None) else 0

    def poll(self) -> None:
        # resolve the zip's metadata here instead of blocking dispatch
        # (the scheduling loop kept running other operators meanwhile)
        inflight = getattr(self, "_inflight", None)
        if inflight is None:
            return
        block_ref, meta_ref = inflight
        ready, _ = ray_tpu_torch.wait([meta_ref], num_returns=1, timeout=0)
        if ready:
            self._inflight = None
            self._emit(RefBundle(block_ref, ray_tpu_torch.get(meta_ref)))

    def completed(self) -> bool:
        return self._ran and getattr(self, "_inflight", None) is None


def _zip_task(left_refs, right_refs):
    lblocks = [ray_tpu_torch.get(r) for r in left_refs]
    rblocks = [ray_tpu_torch.get(r) for r in right_refs]
    lb = BlockAccessor.concat(lblocks)
    rb = BlockAccessor.concat(rblocks)
    la, ra = BlockAccessor(lb), BlockAccessor(rb)
    if la.num_rows() != ra.num_rows():
        raise ValueError(
            f"zip: datasets have different row counts "
            f"({la.num_rows()} vs {ra.num_rows()})")
    ld, rd = la.to_numpy_dict(), ra.to_numpy_dict()
    for k, v in rd.items():
        name = k
        while name in ld:
            name = name + "_1"
        ld[name] = v
    out = BlockAccessor.batch_to_block(ld)
    return out, BlockAccessor(out).metadata()
