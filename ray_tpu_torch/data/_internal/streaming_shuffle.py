# Copied from ray_tpu/data/_internal/streaming_shuffle.py (ray_tpu -> ray_tpu_torch).
"""Streaming multi-node shuffle on the device object plane.

Replaces the materialize-everything exchange for ``random_shuffle`` and
``sort``: the old ``AllToAllOperator`` bulk functions had every reducer
``ray_tpu_torch.get`` EVERY map output and slice one shard — shuffle bytes
scaled O(M×R), reduce could not start until the barrier, and every block
crossed the wire as pickle.

Here the exchange is a single streaming ``PhysicalOperator``:

- **Per-shard map outputs.** Each map task returns R separate store
  objects (``num_returns=R+1``: R packed shards + one inline metadata
  list), each shard a contiguous uint8 array encoded by ``shard_codec``
  so it rides the ``ZeroCopyArray`` fast path. A reducer pulls only its
  own O(bytes/R) shards over the per-peer data channels.
- **Pipelined reduce.** Maps dispatch as input blocks arrive (sort first
  runs a pipelined sample pass, then fixes boundaries once). Reducers
  are admitted as soon as the first map's shards seal — no map→reduce
  barrier — with two admission gates: a CPU-reservation gate (blocked
  reducers must never occupy every cluster slot while maps still need
  one: that is a distributed deadlock) and a byte budget
  (``DataContext.shuffle_max_inflight_shard_bytes``) so a slow reducer
  backpressures admission instead of OOMing workers. The operator's
  held shard bytes also feed the executor's
  ``ResourceBudgetBackpressurePolicy`` via ``extra_usage_bytes``.
- **Recovery = thin client of ownership lineage.** Most
  losses never reach the operator any more: a reducer pulling a lost
  shard triggers the owner's chained lineage replay from inside its own
  ``get``. When a loss does surface here (reduce meta lost, or lineage
  evicted), the operator maps the hex back to the producing map record
  and calls ``Worker.recover_task_returns`` — the general machinery
  replays the map under its original task/object ids and recursively
  reconstructs a lost map INPUT too, so the operator keeps no recovery
  logic of its own beyond a fresh-dispatch fallback for lineage-less
  records; one node death degrades throughput instead of killing the
  job.

Map/reduce task bodies in this module run in shuffle workers and must
never import torch: the port's workers stay free of it
(tests/test_torch_data.py checks a worker's modules after a shuffle).
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private import events as _ev
from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data._internal.physical import PhysicalOperator, RefBundle
from ray_tpu_torch.data._internal.shard_codec import decode_shard, encode_shard
from ray_tpu_torch.exceptions import ObjectLostError


# --------------------------------------------------------------------------
# map / reduce task bodies (run in workers; no torch, no driver state)
# --------------------------------------------------------------------------
def _shuffle_map_shards(block, n: int, seed: int, salt: int):
    """Partition one block into n packed shards + an inline size list."""
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    # seed is ALWAYS concrete (the operator draws one for seedless
    # shuffles): re-execution after a node death must re-produce
    # byte-identical shards or recovery would corrupt the output
    rng = np.random.default_rng(seed + salt)
    assign = rng.integers(0, n, rows)
    perm = rng.permutation(rows)
    outs: List[Any] = []
    sizes: List[List[int]] = []
    for i in range(n):
        idx = perm[assign[perm] == i]
        packed = encode_shard(acc.take_indices(idx))
        sizes.append([int(len(idx)), int(packed.nbytes)])
        outs.append(packed)
    outs.append(sizes)
    return outs


def _sort_map_shards(block, key, boundaries, n: int):
    acc = BlockAccessor(block)
    first = key if isinstance(key, str) else key[0]
    col = acc.to_numpy_dict()[first]
    assign = np.searchsorted(boundaries, col, side="right")
    outs: List[Any] = []
    sizes: List[List[int]] = []
    for i in range(n):
        idx = np.nonzero(assign == i)[0]
        packed = encode_shard(acc.take_indices(idx))
        sizes.append([int(len(idx)), int(packed.nbytes)])
        outs.append(packed)
    outs.append(sizes)
    return outs


def _pull_shards(shard_refs):
    """Reducer-side shard fetch with a ``shard_pull`` flight-recorder
    slice: the single batched ``get`` resolves every borrow and starts
    every pull in one WaitObjects window, and when the enclosing task is
    sampled the pull time lands as its own nested slice (the "lease wait
    vs pull vs merge?" answer per reducer)."""
    rec = _ev.REC
    ctx = _ev.current_ctx() if rec.enabled else None
    if ctx is None:
        return ray_tpu_torch.get(list(shard_refs))
    t0 = time.time()
    try:
        return ray_tpu_torch.get(list(shard_refs))
    finally:
        rec.record("shard_pull", "data", t0, time.time() - t0,
                   ctx[0], rec.next_id(), ctx[1],
                   {"shards": len(shard_refs)})


def _shuffle_reduce_shards(shard_refs, i: int, seed: int):
    """Merge this reducer's M shards (see ``_pull_shards``)."""
    shards = [decode_shard(s) for s in _pull_shards(shard_refs)]
    out = BlockAccessor.concat(shards)
    acc = BlockAccessor(out)
    rng = np.random.default_rng(seed * 7919 + i)
    out = acc.take_indices(rng.permutation(acc.num_rows()))
    return out, BlockAccessor(out).metadata()


def _sort_reduce_shards(shard_refs, i: int, key, descending: bool):
    shards = [decode_shard(s) for s in _pull_shards(shard_refs)]
    out = BlockAccessor.concat(shards)
    acc = BlockAccessor(out)
    if acc.num_rows():
        out = acc.take_indices(acc.sort_indices(key, descending))
    return out, BlockAccessor(out).metadata()


def _sample_boundaries_task(block, key, k: int):
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return np.asarray([])
    idx = np.linspace(0, n - 1, min(k, n)).astype(np.int64)
    col = acc.to_numpy_dict()[key if isinstance(key, str) else key[0]]
    return col[idx]


# --------------------------------------------------------------------------
# exchange strategies
# --------------------------------------------------------------------------
class _ShuffleAlgo:
    """How maps shard and reducers merge; the operator drives the rest."""

    needs_prepare = False

    def __init__(self, map_remote_args: Optional[Dict] = None,
                 reduce_remote_args: Optional[Dict] = None):
        self.map_remote_args = dict(map_remote_args or {})
        self.reduce_remote_args = dict(reduce_remote_args or {})

    def fixed_reducers(self) -> Optional[int]:
        return None  # None: R = number of input blocks, known at barrier

    # prepare stage (sort sampling); default: none
    def prepare_submit(self, block_ref):  # pragma: no cover - abstract
        raise NotImplementedError

    def finish_prepare(self, samples: List[Any]) -> None:
        pass

    def map_submit(self, block_ref, salt: int, n: int) -> List[Any]:
        raise NotImplementedError

    def map_submit_many(self, block_refs: List[Any], salts: List[int],
                        n: int) -> List[List[Any]]:
        """Vectorized map dispatch: one driver pass for a run
        of map tasks. Default falls back to per-call map_submit; algos
        override with ``fn.map`` so the whole run rides one id block /
        registration batch / wire frame. MUST be byte-identical to the
        sequential loop — same salts, same seed, same num_returns."""
        return [self.map_submit(b, s, n)
                for b, s in zip(block_refs, salts)]

    def reduce_submit(self, shard_refs, i: int):
        raise NotImplementedError

    def emit_order(self, n: int):
        return range(n)


class RandomShuffleAlgo(_ShuffleAlgo):
    def __init__(self, seed: Optional[int], num_blocks: Optional[int],
                 **kw):
        super().__init__(**kw)
        if seed is None:
            # draw once so map re-execution is deterministic
            import os as _os

            seed = int.from_bytes(_os.urandom(4), "little")
        self.seed = int(seed)
        self.num_blocks = num_blocks

    def fixed_reducers(self) -> Optional[int]:
        return self.num_blocks

    def map_submit(self, block_ref, salt: int, n: int):
        return ray_tpu_torch.remote(_shuffle_map_shards).options(
            name="Data::ShuffleMap", num_returns=n + 1,
            **self.map_remote_args).remote(block_ref, n, self.seed, salt)

    def map_submit_many(self, block_refs, salts, n):
        from itertools import repeat

        return ray_tpu_torch.remote(_shuffle_map_shards).options(
            name="Data::ShuffleMap", num_returns=n + 1,
            **self.map_remote_args).map(
                block_refs, repeat(n), repeat(self.seed), salts)

    def reduce_submit(self, shard_refs, i: int):
        return ray_tpu_torch.remote(_shuffle_reduce_shards).options(
            name="Data::ShuffleReduce", num_returns=2,
            **self.reduce_remote_args).remote(
                list(shard_refs), i, self.seed)


class SortAlgo(_ShuffleAlgo):
    needs_prepare = True

    def __init__(self, key, descending: bool = False, **kw):
        super().__init__(**kw)
        self.key = key
        self.descending = descending
        self.boundaries: Optional[np.ndarray] = None

    def prepare_submit(self, block_ref):
        return ray_tpu_torch.remote(_sample_boundaries_task).options(
            name="Data::SortSample", **self.map_remote_args).remote(
                block_ref, self.key, 20)

    def finish_prepare(self, samples: List[Any]) -> None:
        n = max(1, len(samples))
        allsamp = np.sort(np.concatenate(
            [s for s in samples if len(s)] or [np.asarray([])]))
        if len(allsamp) == 0:
            self.boundaries = np.asarray([])
            return
        q = np.linspace(0, len(allsamp) - 1, n + 1)[1:-1].astype(np.int64)
        self.boundaries = allsamp[q]

    def map_submit(self, block_ref, salt: int, n: int):
        return ray_tpu_torch.remote(_sort_map_shards).options(
            name="Data::SortMap", num_returns=n + 1,
            **self.map_remote_args).remote(
                block_ref, self.key, self.boundaries, n)

    def map_submit_many(self, block_refs, salts, n):
        # salt does not enter the sort map; arg order matches map_submit
        from itertools import repeat

        return ray_tpu_torch.remote(_sort_map_shards).options(
            name="Data::SortMap", num_returns=n + 1,
            **self.map_remote_args).map(
                block_refs, repeat(self.key), repeat(self.boundaries),
                repeat(n))

    def reduce_submit(self, shard_refs, i: int):
        return ray_tpu_torch.remote(_sort_reduce_shards).options(
            name="Data::SortReduce", num_returns=2,
            **self.reduce_remote_args).remote(
                list(shard_refs), i, self.key, self.descending)

    def emit_order(self, n: int):
        return range(n - 1, -1, -1) if self.descending else range(n)


# --------------------------------------------------------------------------
# operator
# --------------------------------------------------------------------------
class _MapRec:
    __slots__ = ("bundle", "salt", "shard_refs", "meta_ref", "done",
                 "sizes", "reexecs", "reexec_inflight", "t0")

    def __init__(self, bundle: RefBundle, salt: int, refs):
        self.t0 = time.time()
        self.bundle = bundle
        self.salt = salt
        self.shard_refs = list(refs[:-1])
        self.meta_ref = refs[-1]
        self.done = False
        self.sizes: Optional[List[List[int]]] = None  # [rows, nbytes] per shard
        self.reexecs = 0
        self.reexec_inflight = False


class _ReduceRec:
    __slots__ = ("index", "block_ref", "meta_ref", "running", "done",
                 "bundle", "attempts", "bytes_in", "t0")

    def __init__(self, index: int):
        self.t0 = 0.0
        self.index = index
        self.block_ref = None
        self.meta_ref = None
        self.running = False
        self.done = False
        self.bundle: Optional[RefBundle] = None
        self.attempts = 0
        self.bytes_in = 0


class StreamingShuffleOperator(PhysicalOperator):
    """Pipelined map/shuffle/reduce exchange (see module docstring)."""

    def __init__(self, name: str, algo: _ShuffleAlgo):
        super().__init__(name)
        from ray_tpu_torch.data.context import DataContext

        ctx = DataContext.get_current()
        self.algo = algo
        self.max_concurrency = ctx.shuffle_max_concurrency
        self._budget = ctx.shuffle_max_inflight_shard_bytes
        self._max_retries = ctx.shuffle_max_reduce_retries
        self._n: Optional[int] = algo.fixed_reducers()
        self._maps: List[_MapRec] = []
        self._map_ready: collections.deque = collections.deque()
        self._parked: List[RefBundle] = []  # awaiting R / boundaries
        self._prepare_pending: List[Any] = []  # outstanding sample refs
        self._prepare_results: List[Any] = []
        self._prepare_done = not algo.needs_prepare
        # shard ids retired by a fresh (non-lineage) map re-dispatch: a
        # reduce already in flight can still fail on one; its retry reads
        # the CURRENT refs, so the loss needs no further action
        self._retired_shards: set = set()
        self._reducers: Optional[List[_ReduceRec]] = None
        self._emit_order: Optional[List[int]] = None
        self._emit_pos = 0
        self._cluster_cpus = self._total_cpus()
        # counters surfaced through stats_extras() / ExecutorStats
        self.map_reexecs = 0
        self.reduce_retries = 0
        self.shard_bytes_total = 0
        self.shard_inflight_peak = 0
        # incremental store-held shard accounting: += full map output on
        # its FIRST completion, -= that map's shard for each reducer
        # that finishes. extra_usage_bytes() is consulted by the
        # backpressure chain once per dispatch — recomputing an O(M*R)
        # walk there would make the scheduling loop quadratic
        self._held_shard_bytes = 0
        self._t_map_first_done = 0.0
        self._t_map_last_done = 0.0
        self._t_reduce_first_admit = 0.0
        self._t_start = time.perf_counter()
        # flight recorder: one sampled trace per exchange;
        # every map/reduce task submitted under trace_parent joins it, so
        # `ray_tpu_torch trace` shows map -> shard_pull -> reduce as one tree
        self._trace = (_ev.REC.new_trace()
                       if _ev.REC.enabled and _ev.REC.sample() else None)
        self._trace_t0 = time.time()
        self._trace_closed = False
        # Most shard losses resolve inside the owner's pull path now
        # and never reach _recover_lost — subscribe to the
        # ledger's replay feed so a lineage re-execution of one of OUR
        # maps still shows up in map_reexecs. Weakly held: this exchange
        # dying IS the unsubscribe.
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod.global_worker
        if w is not None:
            w._lineage.add_listener(self._on_lineage_replay)

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _total_cpus() -> float:
        try:
            return float(ray_tpu_torch.cluster_resources().get("CPU") or 4.0)
        except Exception:
            return 4.0

    def _maps_all_dispatched(self) -> bool:
        return (self.inputs_complete and not self.input_queue
                and not self._map_ready and not self._parked
                and not self._prepare_pending and self._prepare_done)

    def _maps_done(self) -> int:
        return sum(1 for m in self._maps if m.done)

    def _maps_all_done(self) -> bool:
        return self._maps_all_dispatched() and all(
            m.done for m in self._maps)

    def _running_reducers(self) -> int:
        if not self._reducers:
            return 0
        return sum(1 for r in self._reducers if r.running and not r.done)

    def num_active_tasks(self) -> int:
        maps_running = sum(1 for m in self._maps if not m.done)
        return (maps_running + len(self._prepare_pending)
                + self._running_reducers())

    # ------------------------------------------------- admission decisions
    def _reduce_slots(self) -> int:
        """Concurrent-reducer cap. While maps are still executing,
        reserve CPU slots for them: an admitted reducer BLOCKS on shards
        the remaining maps have yet to produce, so reducers occupying
        every cluster slot would deadlock the exchange (reducers wait on
        maps, maps wait on CPUs)."""
        if self._maps_all_done():
            return self.max_concurrency
        reserve = max(1.0, min(
            float(len(self._maps) - self._maps_done()) or 1.0,
            self._cluster_cpus // 2))
        return int(min(self.max_concurrency,
                       max(0.0, self._cluster_cpus - reserve)))

    def _reducer_bytes_estimate(self, idx: int) -> int:
        """Input bytes of reducer ``idx``: exact for finished maps,
        mean-shard estimate for the rest."""
        known = 0
        known_maps = 0
        for m in self._maps:
            if m.sizes is not None:
                known += m.sizes[idx][1]
                known_maps += 1
        if known_maps and known_maps < len(self._maps):
            known += int(known / known_maps) * (len(self._maps) - known_maps)
        return known

    def _inflight_reduce_bytes(self) -> int:
        if not self._reducers:
            return 0
        return sum(r.bytes_in for r in self._reducers
                   if r.running and not r.done)

    def _admittable_reducer(self) -> Optional[_ReduceRec]:
        if self._reducers is None or not self._maps_all_dispatched():
            return None
        if self._maps and self._maps_done() == 0:
            return None  # admit as the first map's shards seal
        running = self._running_reducers()
        if running >= self._reduce_slots():
            return None
        # admit in EMIT order: a descending sort emits n-1..0, and
        # admitting 0..n-1 would make the first emittable output the
        # LAST admitted reducer — re-creating the barrier
        for idx in (self._emit_order or ()):
            r = self._reducers[idx]
            if r.running or r.done:
                continue
            est = self._reducer_bytes_estimate(r.index)
            if (self._budget > 0 and running > 0
                    and self._inflight_reduce_bytes() + est > self._budget):
                return None  # budget: backpressure admission, never stall
            return r
        return None

    # --------------------------------------------------------- scheduling
    def can_dispatch(self) -> bool:
        if self.input_queue:
            return True
        if self._map_ready:
            return True
        return self._admittable_reducer() is not None

    def dispatch(self) -> None:
        # Priority: drain (admit a reducer) over fill (launch a map) —
        # with the byte budget this is what makes a slow reducer
        # backpressure the map side instead of growing the store.
        red = self._admittable_reducer()
        if red is not None:
            self._admit_reduce(red)
            return
        if self._map_ready:
            # the plan is fixed by the time _map_ready fills (every map
            # must launch before any reducer is admitted), so the whole
            # run rides ONE vectorized submission
            self._dispatch_map_batch()
            return
        if self.input_queue:
            bundle = self.input_queue.popleft()
            if self.algo.needs_prepare:
                self._prepare_pending.append(
                    self.algo.prepare_submit(bundle.block_ref))
                self._parked.append(bundle)
                self.tasks_launched += 1
            elif self._n is None:
                self._parked.append(bundle)
            else:
                self._dispatch_map(bundle)

    def _dispatch_map(self, bundle: RefBundle) -> None:
        salt = len(self._maps)
        with _ev.trace_parent(self._trace):
            refs = self.algo.map_submit(bundle.block_ref, salt, self._n)
        self.tasks_launched += 1
        self._maps.append(_MapRec(bundle, salt, refs))

    def _dispatch_map_batch(self) -> None:
        bundles = list(self._map_ready)
        self._map_ready.clear()
        if len(bundles) == 1:
            self._dispatch_map(bundles[0])
            return
        # sequential salts in list order — byte-identical to the popleft
        # loop this replaces (the sha256 asserts in scale_bench hold)
        base = len(self._maps)
        salts = [base + i for i in range(len(bundles))]
        with _ev.trace_parent(self._trace):
            refs_list = self.algo.map_submit_many(
                [b.block_ref for b in bundles], salts, self._n)
        self.tasks_launched += len(bundles)
        for bundle, salt, refs in zip(bundles, salts, refs_list):
            self._maps.append(_MapRec(bundle, salt, refs))

    def _admit_reduce(self, r: _ReduceRec) -> None:
        shard_refs = [m.shard_refs[r.index] for m in self._maps]
        with _ev.trace_parent(self._trace):
            r.block_ref, r.meta_ref = self.algo.reduce_submit(
                shard_refs, r.index)
        r.t0 = time.time()
        r.bytes_in = self._reducer_bytes_estimate(r.index)
        r.running = True
        self.tasks_launched += 1
        if not self._t_reduce_first_admit:
            self._t_reduce_first_admit = time.perf_counter()
        inflight = self._inflight_reduce_bytes()
        if inflight > self.shard_inflight_peak:
            self.shard_inflight_peak = inflight

    # -------------------------------------------------------------- poll
    def poll(self) -> None:
        self._poll_prepares()
        self._maybe_fix_plan()
        self._poll_maps()
        self._poll_reduces()
        self._emit_ready()

    def _poll_prepares(self) -> None:
        if not self._prepare_pending:
            return
        ready, not_ready = ray_tpu_torch.wait(
            self._prepare_pending, num_returns=len(self._prepare_pending),
            timeout=0)
        if not ready:
            return
        # sample order is irrelevant (finish_prepare sorts the union)
        self._prepare_results.extend(ray_tpu_torch.get(ready))
        self._prepare_pending = not_ready

    def _maybe_fix_plan(self) -> None:
        """Once every input has arrived (and, for sort, every sample has
        landed), fix R and release the parked bundles to the map stage."""
        if self._n is not None and self._prepare_done:
            if self._reducers is None and self._maps_all_dispatched() \
                    and not self._map_ready:
                self._make_reducers()
            return
        if not (self.inputs_complete and not self.input_queue):
            return
        if self.algo.needs_prepare and not self._prepare_done:
            if self._prepare_pending:
                return
            self.algo.finish_prepare(self._prepare_results)
            self._prepare_done = True
        if self._n is None:
            self._n = len(self._parked) + len(self._maps)
        self._map_ready.extend(self._parked)
        self._parked = []

    def _make_reducers(self) -> None:
        # zero input blocks -> zero outputs (the legacy exchange's `if
        # not bundles: return []`), even with a fixed num_blocks: R
        # no-op reducers would hand the consumer R empty batches
        n = self._n if self._maps else 0
        self._reducers = [_ReduceRec(i) for i in range(n)]
        self._emit_order = list(self.algo.emit_order(n)) if n else []

    def _poll_maps(self) -> None:
        pending = [m for m in self._maps if not m.done]
        if not pending:
            return
        metas = [m.meta_ref for m in pending]
        ready, _ = ray_tpu_torch.wait(metas, num_returns=len(metas), timeout=0)
        if not ready:
            return
        ready_set = set(ready)
        done_maps = [m for m in pending if m.meta_ref in ready_set]
        try:
            sizes = ray_tpu_torch.get([m.meta_ref for m in done_maps])
        except ObjectLostError as e:
            self._recover_lost(e.object_id_hex)
            return
        now = time.perf_counter()
        done_idx = {r.index for r in (self._reducers or []) if r.done}
        for m, sz in zip(done_maps, sizes):
            first_completion = m.sizes is None
            m.done = True
            m.reexec_inflight = False
            m.sizes = sz
            if first_completion:
                self.shard_bytes_total += sum(s[1] for s in sz)
                self._held_shard_bytes += sum(
                    s[1] for i, s in enumerate(sz) if i not in done_idx)
                if self._trace is not None:
                    _ev.REC.record(
                        "shuffle_map", "data", m.t0, time.time() - m.t0,
                        self._trace[0], _ev.REC.next_id(), self._trace[1],
                        {"salt": m.salt,
                         "bytes": int(sum(x[1] for x in sz))})
        if not self._t_map_first_done:
            self._t_map_first_done = now
        self._t_map_last_done = now

    def _poll_reduces(self) -> None:
        if not self._reducers:
            return
        running = [r for r in self._reducers if r.running and not r.done]
        if not running:
            return
        metas = [r.meta_ref for r in running]
        ready, _ = ray_tpu_torch.wait(metas, num_returns=len(metas), timeout=0)
        if not ready:
            return
        ready_set = set(ready)
        for r in running:
            if r.meta_ref not in ready_set:
                continue
            try:
                meta = ray_tpu_torch.get(r.meta_ref)
            except ObjectLostError as e:
                self._retry_reduce(r, e.object_id_hex)
                continue
            r.done = True
            r.running = False
            if self._trace is not None:
                _ev.REC.record(
                    "shuffle_reduce", "data", r.t0, time.time() - r.t0,
                    self._trace[0], _ev.REC.next_id(), self._trace[1],
                    {"index": r.index, "bytes": int(r.bytes_in)})
            r.bundle = RefBundle(r.block_ref, meta)
            for m in self._maps:
                if m.sizes is not None:
                    self._held_shard_bytes -= m.sizes[r.index][1]
            # NOTE: shard refs are kept until the operator dies (end of
            # execution), NOT freed per-reducer: a reduce OUTPUT block
            # lost after emission re-executes its reduce through normal
            # driver lineage, and that rerun must still find its input
            # shards owned. Store pressure is handled by tiered spill;
            # the refs die with the topology.

    # ---------------------------------------------------------- recovery
    def _retry_reduce(self, r: _ReduceRec, lost_hex: str) -> None:
        r.attempts += 1
        self.reduce_retries += 1
        if r.attempts > self._max_retries:
            raise ObjectLostError(
                lost_hex,
                f"lost and shuffle recovery exhausted after "
                f"{r.attempts - 1} map re-executions")
        self._recover_lost(lost_hex)
        shard_refs = [m.shard_refs[r.index] for m in self._maps]
        r.block_ref, r.meta_ref = self.algo.reduce_submit(
            shard_refs, r.index)
        self.tasks_launched += 1

    def _recover_lost(self, lost_hex: str) -> None:
        """Map a lost object id back to the map record that produced (or
        consumed) it and replay that map through the general lineage
        machinery. A lost map INPUT needs no special casing any more:
        ``Worker._recover_chain`` recursively reconstructs lost owned
        arguments before resubmitting, so one call covers the chain."""
        from ray_tpu_torch._private import worker as worker_mod

        if lost_hex in self._retired_shards:
            return  # already re-dispatched fresh; retries read current refs
        w = worker_mod.global_worker
        for m in self._maps:
            if (m.bundle.block_ref.hex() == lost_hex
                    or any(ref is not None and ref.hex() == lost_hex
                           for ref in m.shard_refs)):
                self._reexec_map(w, m)
                return
        raise ObjectLostError(
            lost_hex, "lost and not produced by this shuffle")

    def _reexec_map(self, w, m: _MapRec) -> None:
        if m.reexec_inflight:
            return  # one re-execution covers every lost shard of this map
        m.reexecs += 1
        if m.reexecs > self._max_retries:
            raise ObjectLostError(
                m.shard_refs[0].hex(),
                f"lost; map re-executed {m.reexecs - 1} times without "
                "sticking")
        # general machinery: resubmits the map under its
        # original task/object ids, replay-seeded for byte-identical
        # shards, recursively reconstructing lost inputs; returns False
        # (never raises here) when the record is evicted or opted out
        recovered = False
        if w is not None:
            recovered = w.recover_task_returns(m.meta_ref)
        if not recovered:
            # lineage record gone (or retries opted out): fresh dispatch
            # under new object ids; reducers re-read current refs on
            # their own retry
            for ref in m.shard_refs:
                if ref is not None:
                    self._retired_shards.add(ref.hex())
            refs = self.algo.map_submit(m.bundle.block_ref, m.salt,
                                        self._n)
            m.shard_refs = list(refs[:-1])
            m.meta_ref = refs[-1]
            self.tasks_launched += 1
            # the lineage path is counted by _on_lineage_replay (the
            # ledger notifies on resubmit); only the fresh dispatch
            # needs a manual bump or map_reexecs would double-count
            self.map_reexecs += 1
        m.done = False
        m.reexec_inflight = True

    def _on_lineage_replay(self, task_binary: bytes) -> None:
        """Ledger callback: the owner resubmitted ``task_binary`` from
        lineage. When it is one of our maps the map genuinely ran again
        — whether we asked (_reexec_map) or a reducer's failed pull
        triggered it behind our back — so it belongs in map_reexecs."""
        for m in self._maps:
            if m.meta_ref is not None and \
                    m.meta_ref.id().task_id().binary() == task_binary:
                self.map_reexecs += 1
                return

    # -------------------------------------------------------------- emit
    def _emit_ready(self) -> None:
        if not self._reducers or self._emit_order is None:
            return
        while self._emit_pos < len(self._emit_order):
            r = self._reducers[self._emit_order[self._emit_pos]]
            if not r.done:
                return
            self._emit(r.bundle)
            r.bundle = None
            self._emit_pos += 1

    def completed(self) -> bool:
        if self._n == 0 and self.inputs_complete and not self.input_queue:
            done = True
        else:
            done = (self._reducers is not None
                    and self._emit_order is not None
                    and self._emit_pos >= len(self._emit_order))
        if done and self._trace is not None and not self._trace_closed:
            self._trace_closed = True
            _ev.REC.record(
                "shuffle::" + self.name, "data", self._trace_t0,
                time.time() - self._trace_t0, self._trace[0],
                self._trace[1], 0,
                {"maps": len(self._maps),
                 "reducers": len(self._reducers or [])})
        return done

    # ------------------------------------------------------------- stats
    def extra_usage_bytes(self) -> int:
        """Shard bytes this exchange currently holds in the store plane:
        sealed map outputs whose reducer has not finished (incremental
        counter — see __init__). Feeds the
        ResourceBudgetBackpressurePolicy's global accounting."""
        return max(0, self._held_shard_bytes)

    def stats_extras(self) -> Dict[str, Any]:
        wall = max(time.perf_counter() - self._t_start, 1e-9)
        if self._t_reduce_first_admit and self._t_map_first_done:
            stall = max(0.0, self._t_reduce_first_admit
                        - self._t_map_first_done) / wall
        else:
            stall = 1.0 if self._maps else 0.0
        return {
            "shuffle_maps": len(self._maps),
            "shuffle_reducers": self._n or 0,
            "shuffle_map_reexecs": self.map_reexecs,
            "shuffle_reduce_retries": self.reduce_retries,
            "shuffle_shard_bytes": self.shard_bytes_total,
            "shuffle_inflight_peak_bytes": self.shard_inflight_peak,
            "shuffle_stall_fraction": round(stall, 4),
            "shuffle_reduce_overlapped_maps": bool(
                self._t_reduce_first_admit and self._t_map_last_done
                and self._t_reduce_first_admit < self._t_map_last_done),
        }


def build_streaming_shuffle(op) -> StreamingShuffleOperator:
    """Planner entry: logical AbstractAllToAll -> streaming operator."""
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    kw = op.kwargs
    common = dict(map_remote_args=ctx.shuffle_map_remote_args,
                  reduce_remote_args=ctx.shuffle_reduce_remote_args)
    if op.kind == "random_shuffle":
        algo = RandomShuffleAlgo(kw.get("seed"), kw.get("num_blocks"),
                                 **common)
    elif op.kind == "sort":
        algo = SortAlgo(kw["key"], kw.get("descending", False), **common)
    else:  # pragma: no cover - planner routes only the two kinds here
        raise ValueError(f"no streaming exchange for {op.kind!r}")
    return StreamingShuffleOperator(op.name, algo)
