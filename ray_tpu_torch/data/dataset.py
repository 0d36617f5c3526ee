# Ported from ray_tpu/data/dataset.py (ray_tpu -> ray_tpu_torch).
"""Dataset: the user-facing lazy, streaming dataset.

Reference: python/ray/data/dataset.py (5.1k LoC: map_batches, iter_batches
:3599, materialize :4498). A Dataset is an immutable logical-operator chain;
execution happens on consumption through the streaming executor
(SURVEY §3.6 call stack).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import aggregate as agg_mod
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data._internal import logical as L
from ray_tpu_torch.data._internal.executor import ExecutorStats, StreamingExecutor
from ray_tpu_torch.data._internal.physical import RefBundle
from ray_tpu_torch.data._internal.planner import optimize, plan
from ray_tpu_torch.data.iterator import DataIterator


class ActorPoolStrategy:
    """compute= for class-based UDFs (reference: data/_internal/compute.py)."""

    is_actor_pool = True

    def __init__(self, size: int = 2, min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        self.size = min_size or size


class Dataset:
    def __init__(self, last_op: L.LogicalOperator,
                 max_concurrency: Optional[int] = None):
        self._last_op = last_op
        if max_concurrency is None:
            from ray_tpu_torch.data.context import DataContext

            max_concurrency = \
                DataContext.get_current().max_tasks_in_flight_per_op
        self._max_concurrency = max_concurrency
        self._last_stats: Optional[ExecutorStats] = None

    # ------------------------------------------------------------ transforms
    def _append(self, op: L.LogicalOperator) -> "Dataset":
        return Dataset(op, self._max_concurrency)

    def map_batches(
        self,
        fn: Union[Callable, type],
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional[ActorPoolStrategy] = None,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
        fn_constructor_args: tuple = (),
        fn_constructor_kwargs: Optional[dict] = None,
        concurrency: Optional[int] = None,
        num_cpus: Optional[float] = None,
        num_gpus: Optional[float] = None,
        **ray_remote_args,
    ) -> "Dataset":
        if isinstance(fn, type):
            if compute is None:
                compute = ActorPoolStrategy(size=concurrency or 2)
        if num_cpus is not None:
            ray_remote_args["num_cpus"] = num_cpus
        if num_gpus is not None:
            # a GPU lease: the worker sees its card as CUDA_VISIBLE_DEVICES
            ray_remote_args["num_gpus"] = num_gpus
        spec = L.MapSpec(kind="batches", fn=fn, fn_args=fn_args,
                         fn_kwargs=fn_kwargs, batch_size=batch_size,
                         batch_format=batch_format,
                         fn_constructor_args=fn_constructor_args,
                         fn_constructor_kwargs=fn_constructor_kwargs)
        name = f"MapBatches({getattr(fn, '__name__', type(fn).__name__)})"
        return self._append(L.AbstractMap(
            self._last_op, spec, name, compute=compute,
            ray_remote_args=ray_remote_args))

    def map(self, fn: Callable, **ray_remote_args) -> "Dataset":
        spec = L.MapSpec(kind="rows", fn=fn)
        return self._append(L.AbstractMap(
            self._last_op, spec, f"Map({getattr(fn, '__name__', 'fn')})",
            ray_remote_args=ray_remote_args))

    def flat_map(self, fn: Callable, **ray_remote_args) -> "Dataset":
        spec = L.MapSpec(kind="flat", fn=fn)
        return self._append(L.AbstractMap(
            self._last_op, spec, f"FlatMap({getattr(fn, '__name__', 'fn')})",
            ray_remote_args=ray_remote_args))

    def filter(self, fn: Callable, **ray_remote_args) -> "Dataset":
        spec = L.MapSpec(kind="filter", fn=fn)
        return self._append(L.AbstractMap(
            self._last_op, spec, f"Filter({getattr(fn, '__name__', 'fn')})",
            ray_remote_args=ray_remote_args))

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def add(batch, _name=name, _fn=fn):
            batch[_name] = np.asarray(_fn(batch))
            return batch

        return self.map_batches(add)

    def _map_blocks(self, fn: Callable, name: str) -> "Dataset":
        spec = L.MapSpec(kind="block", fn=fn)
        return self._append(L.AbstractMap(self._last_op, spec, name))

    def drop_columns(self, cols: List[str]) -> "Dataset":
        return self._map_blocks(
            lambda b: BlockAccessor(b).drop(cols), f"DropColumns{cols}")

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self._map_blocks(
            lambda b: BlockAccessor(b).select(cols), f"SelectColumns{cols}")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self._map_blocks(
            lambda b: BlockAccessor(b).rename(mapping), "RenameColumns")

    def limit(self, n: int) -> "Dataset":
        return self._append(L.Limit(self._last_op, n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._append(L.AbstractAllToAll(
            self._last_op, "repartition", f"Repartition[{num_blocks}]",
            num_blocks=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        return self._append(L.AbstractAllToAll(
            self._last_op, "random_shuffle", "RandomShuffle",
            seed=seed, num_blocks=num_blocks))

    def sort(self, key: Union[str, List[str]],
             descending: bool = False) -> "Dataset":
        return self._append(L.AbstractAllToAll(
            self._last_op, "sort", f"Sort[{key}]", key=key,
            descending=descending))

    def groupby(self, key: str) -> "GroupedData":
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        return self._append(L.Union(
            self._last_op, [o._last_op for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._append(L.Zip(self._last_op, other._last_op))

    def random_sample(self, fraction: float,
                      *, seed: Optional[int] = None) -> "Dataset":
        def sample(batch):
            import zlib

            n = len(next(iter(batch.values()))) if batch else 0
            if seed is None:
                rng = np.random.default_rng()
            else:
                # salt by block content: a bare seed would draw the same
                # mask positions in every block
                first = next(iter(batch.values()))
                salt = zlib.crc32(np.ascontiguousarray(first).tobytes()
                                  if first.dtype != object
                                  else str(first[:4]).encode())
                rng = np.random.default_rng((seed, salt))
            keep = rng.random(n) < fraction
            return {k: v[keep] for k, v in batch.items()}

        return self.map_batches(sample)

    # -------------------------------------------------------------- writes
    def write_parquet(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_parquet_fn

        self._consume_write(write_parquet_fn(path), "WriteParquet")

    def write_csv(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_csv_fn

        self._consume_write(write_csv_fn(path), "WriteCSV")

    def write_json(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_json_fn

        self._consume_write(write_json_fn(path), "WriteJSON")

    def write_tfrecords(self, path: str) -> None:
        from ray_tpu_torch.data.datasource import write_tfrecords_fn

        self._consume_write(write_tfrecords_fn(path), "WriteTFRecords")

    def iter_torch_batches(self, **kw) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_torch_batches(**kw)

    def _consume_write(self, write_fn, name: str) -> None:
        ds = self._append(L.Write(self._last_op, write_fn, name))
        for _ in ds._execute_bundles():
            pass

    # ----------------------------------------------------------- execution
    def _execute_bundles(self, publish: bool = True) -> Iterator[RefBundle]:
        stats = ExecutorStats()
        topo = plan(optimize(self._last_op.chain()),
                    max_concurrency=self._max_concurrency)
        executor = StreamingExecutor(topo, stats).start()
        self._last_stats = stats
        try:
            yield from executor.iter_bundles()
        finally:
            executor.shutdown()
            # publish=False: a windowed consumer (_iter_blocks) keeps
            # pulling blocks AFTER this generator exhausts; it publishes
            # itself once the stall/consume counters are final
            if publish:
                self._publish_stats(stats)

    def _publish_stats(self, stats: ExecutorStats) -> None:
        """Best-effort: per-operator stats land in the head KV so the
        dashboard's /api/data_stats can render them cluster-wide
        (reference: data stats surface in the dashboard's Ray Data tab)."""
        try:
            import json as _json
            import time as _time

            from ray_tpu_torch.experimental.internal_kv import (
                _internal_kv_del, _internal_kv_list, _internal_kv_put)

            # zero-padded ms timestamp first => lexicographic == recency
            key = (f"__data_stats__:{int(_time.time() * 1000):015d}"
                   f":{id(self):x}")
            _internal_kv_put(key.encode(), _json.dumps(
                stats.to_dict()).encode())
            # bound head-KV growth: keep only the most recent entries
            stale = sorted(_internal_kv_list(b"__data_stats__:"))[:-100]
            for k in stale:
                _internal_kv_del(k)
        except Exception:
            pass

    def iter_internal_ref_bundles(self) -> Iterator[RefBundle]:
        return self._execute_bundles()

    def _iter_blocks(self) -> Iterator[Block]:
        """Consumer-edge block stream with pull prefetch.

        The old loop blocked on each block's pull in turn — on a
        multi-node pipeline every cross-node block cost a full pull
        latency on the consumer's critical path. Here the next
        ``iter_prefetch_blocks`` bundles' pulls are INITIATED (one
        batched, non-blocking WaitObjects frame) while the current block
        is being consumed, so ``iter_torch_batches`` overlaps network with
        host→device transfer. Stall time that still leaks through is
        reported in ``ExecutorStats.consumer_stall_s``.
        """
        import queue as _queue
        import threading as _threading
        import time as _time

        from ray_tpu_torch.data.context import DataContext

        depth = max(0, DataContext.get_current().iter_prefetch_blocks)
        it = self._execute_bundles(publish=False)
        # Feeder thread: drains bundles AS THE EXECUTOR PRODUCES THEM,
        # initiating each block's pull immediately (off the consumer's
        # critical path, one frame per bundle), and parks them in a
        # bounded window. The consumer below blocks only when NOTHING
        # is available — never on filling the window ahead (a
        # window-first loop would delay every yield behind producer
        # progress, the opposite of overlap).
        q: "_queue.Queue" = _queue.Queue(maxsize=depth + 1)
        DONE = object()
        err: list = []
        stop = _threading.Event()

        def initiate(bundle):
            try:
                from ray_tpu_torch._private import worker as worker_mod

                w = worker_mod.global_worker
                if w is not None and w.connected:
                    w._prefetch_plasma([bundle.block_ref], min_need=1)
            except Exception:
                pass  # prefetch is advisory; get() below is the contract

        def feeder():
            try:
                for bundle in it:
                    initiate(bundle)
                    while not stop.is_set():
                        try:
                            q.put(bundle, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    if stop.is_set():
                        break
            except BaseException as e:  # noqa: BLE001 — re-raised below
                err.append(e)
            finally:
                if stop.is_set():
                    # abandoned consumer: close the source HERE (the
                    # generator is owned by this thread) so the
                    # executor tears down instead of leaking
                    try:
                        it.close()
                    except Exception:
                        pass
                # DONE must reach a still-draining consumer even if the
                # window is momentarily full (e.g. feeder errored with a
                # full queue) — a dropped sentinel wedges q.get() forever
                while True:
                    try:
                        q.put(DONE, timeout=0.1)
                        break
                    except _queue.Full:
                        if stop.is_set():
                            break

        t = _threading.Thread(target=feeder, daemon=True,
                              name="raytpu-data-ingest")
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    if err:
                        raise err[0]
                    return
                # stall = time blocked in the PULL only (the stat's
                # contract); producer wait shows up as executor wall
                t0 = _time.perf_counter()
                block = ray_tpu_torch.get(item.block_ref)
                stall = _time.perf_counter() - t0
                stats = self._last_stats
                if stats is not None:
                    stats.consumer_stall_s += stall
                    stats.blocks_consumed += 1
                yield block
        finally:
            stop.set()
            t.join(timeout=5)
            if self._last_stats is not None:
                self._publish_stats(self._last_stats)

    def iterator(self) -> DataIterator:
        return DataIterator(self._iter_blocks, stats_fn=self.stats)

    # ---------------------------------------------------------- consumption
    def iter_batches(self, **kw) -> Iterator[Any]:
        return self.iterator().iter_batches(**kw)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        return self.iterator().iter_rows()

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out = []
        for row in self.limit(n).iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20,
                   batch_format: str = "numpy") -> Any:
        for b in self.limit(batch_size).iter_batches(
                batch_size=batch_size, batch_format=batch_format,
                prefetch_batches=0):
            return b
        return {}

    def count(self) -> int:
        return sum(b.meta.num_rows for b in self._execute_bundles())

    def schema(self) -> Optional[Dict[str, str]]:
        for bundle in self._execute_bundles():
            if bundle.meta.schema:
                return bundle.meta.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s) if s else []

    def to_pandas(self):
        import pandas as pd

        dfs = [BlockAccessor(b).to_pandas() for b in self._iter_blocks()]
        if not dfs:
            return pd.DataFrame()
        return pd.concat(dfs, ignore_index=True)

    def to_arrow(self):
        return BlockAccessor(
            BlockAccessor.concat(list(self._iter_blocks()))).to_arrow()

    def materialize(self) -> "MaterializedDataset":
        bundles = [(b.block_ref, b.meta) for b in self._execute_bundles()]
        return MaterializedDataset(
            L.InputData(bundles), self._max_concurrency)

    # simple aggregates
    def sum(self, on: str):
        return self.aggregate(agg_mod.Sum(on))

    def min(self, on: str):
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: str):
        return self.aggregate(agg_mod.Max(on))

    def mean(self, on: str):
        return self.aggregate(agg_mod.Mean(on))

    def std(self, on: str, ddof: int = 1):
        return self.aggregate(agg_mod.Std(on, ddof=ddof))

    def aggregate(self, *aggs: agg_mod.AggregateFn):
        ds = self._append(L.AbstractAllToAll(
            self._last_op, "global_agg", "Aggregate", aggs=list(aggs)))
        rows = ds.take_all()
        row = rows[0] if rows else {}
        vals = [row.get(a.output_name(None)) for a in aggs]
        return vals[0] if len(vals) == 1 else tuple(vals)

    # ----------------------------------------------------------- splitting
    def split(self, n: int, *, equal: bool = False) -> List["MaterializedDataset"]:
        mat = self.materialize()
        bundles = mat._last_op.bundles
        if equal:
            total = sum(m.num_rows for _, m in bundles)
            per = total // n
            mat2 = mat.repartition(n) if per else mat
            rows_target = [per] * n
            blocks = list(mat2._iter_blocks())
            merged = BlockAccessor.concat(blocks)
            acc = BlockAccessor(merged)
            out = []
            pos = 0
            for t in rows_target:
                out.append(from_blocks([acc.slice(pos, pos + t)]))
                pos += t
            return out
        groups: List[List[Tuple[Any, BlockMetadata]]] = [[] for _ in range(n)]
        for i, b in enumerate(bundles):
            groups[i % n].append(b)
        return [MaterializedDataset(L.InputData(g), self._max_concurrency)
                for g in groups]

    def split_at_indices(self, indices: List[int]
                         ) -> List["MaterializedDataset"]:
        """Split at global row offsets (reference: dataset.py
        split_at_indices): [3, 8] → rows [0,3), [3,8), [8,end)."""
        if any(i < 0 for i in indices) or list(indices) != sorted(indices):
            raise ValueError(
                f"indices must be non-negative and sorted; got {indices}")
        mat = self.materialize()
        blocks = list(mat._iter_blocks())
        merged = BlockAccessor.concat(blocks)
        acc = BlockAccessor(merged)
        total = acc.num_rows()
        out = []
        bounds = [0] + [min(i, total) for i in indices] + [total]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            out.append(from_blocks([acc.slice(lo, hi)]))
        return out

    def split_proportionately(self, proportions: List[float]
                              ) -> List["MaterializedDataset"]:
        """Split by fractions; the remainder forms the final split
        (reference: dataset.py split_proportionately)."""
        if not proportions or any(p <= 0 for p in proportions) or \
                sum(proportions) >= 1.0:
            raise ValueError(
                "proportions must be positive and sum to < 1 "
                f"(the remainder is the last split); got {proportions}")
        mat = self.materialize()  # one execution feeds count AND split
        total = mat.count()
        indices = []
        acc = 0.0
        for p in proportions:
            acc += p
            indices.append(int(total * acc))
        return mat.split_at_indices(indices)

    def train_test_split(self, test_size: Union[float, int], *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["MaterializedDataset",
                                    "MaterializedDataset"]:
        """(train, test) split (reference: dataset.py train_test_split)."""
        ds: Dataset = self
        if shuffle:
            ds = ds.random_shuffle(seed=seed)
        mat = ds.materialize()  # one execution feeds count AND split
        total = mat.count()
        if isinstance(test_size, float):
            if not 0.0 < test_size < 1.0:
                raise ValueError("float test_size must be in (0, 1)")
            n_test = int(total * test_size)
        else:
            if not 0 < test_size < total:
                raise ValueError(
                    f"int test_size must be in (0, {total})")
            n_test = int(test_size)
        train, test = mat.split_at_indices([total - n_test])
        return train, test

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (reference: dataset.py unique)."""
        seen = set()
        out = []
        for batch in self.iter_batches(batch_format="numpy"):
            for v in batch[column]:
                key = v.item() if hasattr(v, "item") else v
                if key not in seen:
                    seen.add(key)
                    out.append(key)
        return out

    def to_torch(self, **iter_kwargs):
        """A torch IterableDataset over this Dataset's batches
        (reference: dataset.py to_torch; batches come through
        iter_torch_batches so dtype/device handling stays in one place)."""
        import torch

        outer = self

        class _TorchIterable(torch.utils.data.IterableDataset):
            def __iter__(self):
                return outer.iter_torch_batches(**iter_kwargs)

        return _TorchIterable()

    def streaming_split(self, n: int, *, equality: bool = False,
                        locality_hints=None) -> List[DataIterator]:
        """N coordinated iterators backed by one execution (reference:
        dataset.streaming_split / _internal/execution/operators/
        output_splitter.py). A coordinator actor runs the stream and hands
        out bundles round-robin; per-consumer iterators pull from it."""
        coordinator = _SplitCoordinator.options(name=None).remote(
            _serialize_plan(self), n)

        def make_block_fn(idx: int):
            def block_fn():
                import time as _time

                # client-side epoch counter; the coordinator gates epoch
                # starts on ALL consumers having drained the previous one.
                epoch = getattr(block_fn, "_epoch", 0)
                block_fn._epoch = epoch + 1
                while True:
                    ref = ray_tpu_torch.get(coordinator.next_ref.remote(idx, epoch))
                    if ref is None:
                        return
                    if ref == "WAIT":
                        _time.sleep(0.02)
                        continue
                    yield ray_tpu_torch.get(ref)

            return block_fn

        return [DataIterator(make_block_fn(i)) for i in range(n)]

    def show(self, limit: int = 20) -> None:
        """Print up to ``limit`` rows (reference: Dataset.show)."""
        for row in self.take(limit):
            print(row)

    # ------------------------------------------------------------- misc
    def stats(self) -> str:
        return self._last_stats.summary() if self._last_stats else ""

    def num_blocks(self) -> Optional[int]:
        op = self._last_op
        if isinstance(op, L.InputData):
            return len(op.bundles)
        if isinstance(op, L.Read):
            return len(op.read_tasks)
        return None

    def __repr__(self):
        names = [op.name for op in self._last_op.chain()]
        return f"Dataset({' -> '.join(names)})"

    # pickling a Dataset ships the logical plan (used by trainers)
    def __reduce__(self):
        return (Dataset, (self._last_op, self._max_concurrency))


class MaterializedDataset(Dataset):
    """Fully-executed dataset: blocks pinned in the object store."""

    def count(self) -> int:
        return sum(m.num_rows for _, m in self._last_op.bundles)


class GroupedData:
    """Reference: python/ray/data/grouped_data.py."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: agg_mod.AggregateFn) -> Dataset:
        return self._ds._append(L.AbstractAllToAll(
            self._ds._last_op, "groupby_agg", f"GroupBy[{self._key}]",
            key=self._key, aggs=list(aggs)))

    def count(self) -> Dataset:
        return self.aggregate(agg_mod.Count())

    def sum(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Sum(on))

    def min(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Min(on))

    def max(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Max(on))

    def mean(self, on: str) -> Dataset:
        return self.aggregate(agg_mod.Mean(on))

    def map_groups(self, fn: Callable) -> Dataset:
        """Sort by key, then apply fn per contiguous group."""
        key = self._key

        def apply_groups(batch):
            col = batch[key]
            uniq, inverse = np.unique(col, return_inverse=True)
            outs = []
            for g in range(len(uniq)):
                mask = inverse == g
                out = fn({k: v[mask] for k, v in batch.items()})
                outs.append(out)
            merged: Dict[str, list] = {}
            for o in outs:
                for k, v in o.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            return {k: np.concatenate(v) for k, v in merged.items()}

        return self._ds.repartition(1).map_batches(apply_groups)


# ---------------------------------------------------------- split coordinator
def _serialize_plan(ds: Dataset) -> bytes:
    import cloudpickle

    return cloudpickle.dumps(ds)


@ray_tpu_torch.remote
class _SplitCoordinator:
    """Owns one streaming execution per epoch; consumers pull bundles
    round-robin. Epoch e+1 starts only after every consumer drained epoch e
    — a consumer arriving early gets "WAIT" so it never observes an empty
    epoch (reference: output_splitter.py's epoch barrier)."""

    def __init__(self, plan_blob: bytes, n: int):
        import cloudpickle

        self._ds: Dataset = cloudpickle.loads(plan_blob)
        self._n = n
        self._epoch = -1
        self._gen = None
        self._queues: List[List] = [[] for _ in range(n)]
        self._done = False
        self._rr = 0
        self._finished = set(range(n))  # everyone "drained" epoch -1
        # Hand-outs stay pinned until the consumer's NEXT request: a
        # consumer fetches each block before asking for another, so holding
        # the last two refs per consumer keeps fetches safe while bounding
        # object-store usage (instead of pinning the whole epoch).
        import collections as _c

        self._hold: List = [_c.deque(maxlen=2) for _ in range(n)]

    def _start_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        import collections as _c

        self._gen = self._ds._execute_bundles()
        self._queues = [[] for _ in range(self._n)]
        self._hold = [_c.deque(maxlen=2) for _ in range(self._n)]
        self._done = False
        self._rr = 0
        self._finished = set()

    def next_ref(self, idx: int, epoch: int):
        if epoch > self._epoch:
            if len(self._finished) == self._n:
                self._start_epoch(epoch)
            else:
                return "WAIT"  # peers still draining the previous epoch
        elif epoch < self._epoch:
            return None  # stale consumer; its epoch is gone
        while not self._queues[idx] and not self._done:
            try:
                bundle = next(self._gen)
            except StopIteration:
                self._done = True
                break
            self._queues[self._rr].append(bundle.block_ref)
            self._rr = (self._rr + 1) % self._n
        if self._queues[idx]:
            ref = self._queues[idx].pop(0)
            self._hold[idx].append(ref)
            return ref
        if self._done and not self._queues[idx]:
            self._finished.add(idx)
        return None


def from_blocks(blocks: List[Block]) -> MaterializedDataset:
    bundles = []
    for b in blocks:
        acc = BlockAccessor(b)
        bundles.append((ray_tpu_torch.put(b), acc.metadata()))
    return MaterializedDataset(L.InputData(bundles))
