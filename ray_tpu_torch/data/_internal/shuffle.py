# Copied from ray_tpu/data/_internal/shuffle.py (ray_tpu -> ray_tpu_torch).
"""All-to-all bulk implementations: repartition, random_shuffle, sort,
groupby-aggregate (reference: python/ray/data/_internal/planner/exchange/ —
map-stage partitions each block, reduce-stage merges per output partition).

Each returns a ``bulk_fn(bundles) -> bundles`` closure run by
``AllToAllOperator`` at the barrier. Map/reduce stages are ray_tpu_torch tasks, so
the exchange parallelizes across the cluster like the reference's
push-based shuffle.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor
from ray_tpu_torch.data._internal.physical import RefBundle


def _get_many(refs):
    return ray_tpu_torch.get(list(refs))


# -------------------------------------------------------------- repartition
def _slice_concat_task(parts: List[Tuple[Any, int, int]]):
    """parts: (block_ref, start, end) triples → one output block."""
    # one batched get: every source pull starts in the same WaitObjects
    # window instead of paying a sequential round trip per part
    blocks_in = ray_tpu_torch.get([ref for ref, _, _ in parts])
    blocks = [BlockAccessor(b).slice(start, end)
              for b, (_, start, end) in zip(blocks_in, parts)]
    out = BlockAccessor.concat(blocks)
    return out, BlockAccessor(out).metadata()


def repartition_fn(num_blocks: int) -> Callable:
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        total = sum(b.meta.num_rows for b in bundles)
        # Global row-range split: output i covers [i*total/n, (i+1)*total/n).
        bounds = [(i * total) // num_blocks for i in range(num_blocks + 1)]
        # For each output, find the (block, start, end) spans covering it.
        starts = []
        acc = 0
        for b in bundles:
            starts.append(acc)
            acc += b.meta.num_rows
        out_refs = []
        for i in range(num_blocks):
            lo, hi = bounds[i], bounds[i + 1]
            parts = []
            for b, s in zip(bundles, starts):
                e = s + b.meta.num_rows
                a, z = max(lo, s), min(hi, e)
                if a < z:
                    parts.append((b.block_ref, a - s, z - s))
            out_refs.append(ray_tpu_torch.remote(_slice_concat_task)
                            .options(name="Data::Repartition",
                                     num_returns=2).remote(parts))
        # payloads stay in the object store; metadata comes back in ONE
        # batched get (the per-bundle blocking get serialized the whole
        # repartition behind its slowest predecessor)
        metas = ray_tpu_torch.get([r[1] for r in out_refs])
        return [RefBundle(r[0], meta)
                for r, meta in zip(out_refs, metas)]

    return bulk


# ----------------------------------------------------------- random shuffle
def _shuffle_map(block: Block, n: int, seed: Optional[int], salt: int):
    acc = BlockAccessor(block)
    rows = acc.num_rows()
    rng = np.random.default_rng(None if seed is None else seed + salt)
    assign = rng.integers(0, n, rows)
    perm = rng.permutation(rows)
    shards = []
    for i in range(n):
        idx = perm[assign[perm] == i]
        shards.append(acc.take_indices(idx))
    return shards


def _shuffle_reduce(map_refs, i: int, seed: Optional[int]):
    # one batched get: all map outputs pull in one WaitObjects window
    shards = [b[i] for b in ray_tpu_torch.get(list(map_refs))]
    out = BlockAccessor.concat(shards)
    acc = BlockAccessor(out)
    rng = np.random.default_rng(None if seed is None else seed * 7919 + i)
    out = acc.take_indices(rng.permutation(acc.num_rows()))
    return out, BlockAccessor(out).metadata()


def _exchange_remote_args():
    """The shuffle map/reduce pinning knobs apply to BOTH exchange
    implementations so streaming-vs-materializing comparisons (and the
    data_shuffle bench) measure the exchange, not task placement."""
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    return (dict(ctx.shuffle_map_remote_args or {}),
            dict(ctx.shuffle_reduce_remote_args or {}))


def random_shuffle_fn(seed: Optional[int] = None,
                      num_blocks: Optional[int] = None) -> Callable:
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        if not bundles:
            return []
        map_args, red_args = _exchange_remote_args()
        n = num_blocks or len(bundles)
        map_refs = [
            ray_tpu_torch.remote(_shuffle_map).options(
                name="Data::ShuffleMap", **map_args)
            .remote(b.block_ref, n, seed, salt)
            for salt, b in enumerate(bundles)]
        red_refs = [
            ray_tpu_torch.remote(_shuffle_reduce).options(
                name="Data::ShuffleReduce", num_returns=2, **red_args)
            .remote(map_refs, i, seed)
            for i in range(n)]
        metas = ray_tpu_torch.get([r[1] for r in red_refs])
        return [RefBundle(r[0], meta)
                for r, meta in zip(red_refs, metas)]

    return bulk


# -------------------------------------------------------------------- sort
def _sample_task(block: Block, key, k: int):
    acc = BlockAccessor(block)
    n = acc.num_rows()
    if n == 0:
        return np.asarray([])
    idx = np.linspace(0, n - 1, min(k, n)).astype(np.int64)
    col = acc.to_numpy_dict()[key if isinstance(key, str) else key[0]]
    return col[idx]


def _sort_map(block: Block, key, boundaries):
    acc = BlockAccessor(block)
    first = key if isinstance(key, str) else key[0]
    col = acc.to_numpy_dict()[first]
    assign = np.searchsorted(boundaries, col, side="right")
    return [acc.take_indices(np.nonzero(assign == i)[0])
            for i in range(len(boundaries) + 1)]


def _sort_reduce(map_refs, i: int, key, descending: bool):
    shards = [b[i] for b in ray_tpu_torch.get(list(map_refs))]
    out = BlockAccessor.concat(shards)
    acc = BlockAccessor(out)
    if acc.num_rows():
        out = acc.take_indices(acc.sort_indices(key, descending))
    return out, BlockAccessor(out).metadata()


def sort_fn(key: Union[str, List[str]], descending: bool = False) -> Callable:
    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        if not bundles:
            return []
        n = len(bundles)
        samples = ray_tpu_torch.get([
            ray_tpu_torch.remote(_sample_task).remote(b.block_ref, key, 20)
            for b in bundles])
        allsamp = np.sort(np.concatenate([s for s in samples if len(s)]))
        if len(allsamp) == 0:
            return bundles
        q = np.linspace(0, len(allsamp) - 1, n + 1)[1:-1].astype(np.int64)
        boundaries = allsamp[q]
        map_refs = [ray_tpu_torch.remote(_sort_map).options(name="Data::SortMap")
                    .remote(b.block_ref, key, boundaries) for b in bundles]
        red_refs = [ray_tpu_torch.remote(_sort_reduce)
                    .options(name="Data::SortReduce", num_returns=2)
                    .remote(map_refs, i, key, descending) for i in range(n)]
        order = range(n - 1, -1, -1) if descending else range(n)
        metas = ray_tpu_torch.get([r[1] for r in red_refs])
        return [RefBundle(red_refs[i][0], metas[i]) for i in order]

    return bulk


# ------------------------------------------------------------- groupby/agg
def _hash_partition(block: Block, key: str, n: int):
    import zlib

    acc = BlockAccessor(block)
    col = acc.to_numpy_dict()[key]
    if col.dtype.kind in "OUS":
        # crc32, not hash(): Python's str hash is salted per process, and
        # map tasks for different blocks run in different workers — the same
        # key must land in the same partition everywhere.
        hashes = np.asarray(
            [zlib.crc32(str(x).encode()) % n for x in col])
    else:
        hashes = np.abs(col.astype(np.int64, copy=False)) % n
    return [acc.take_indices(np.nonzero(hashes == i)[0]) for i in range(n)]


def _agg_reduce(map_refs, i: int, key: str, agg_blobs: bytes):
    import cloudpickle

    aggs = cloudpickle.loads(agg_blobs)
    shards = [b[i] for b in ray_tpu_torch.get(list(map_refs))]
    merged = BlockAccessor.concat(shards)
    acc = BlockAccessor(merged)
    nd = acc.to_numpy_dict()
    if acc.num_rows() == 0:
        return BlockAccessor.batch_to_block({}), BlockAccessor({}).metadata()
    col = nd[key]
    uniq, inverse = np.unique(col, return_inverse=True)
    out: Dict[str, np.ndarray] = {key: uniq}
    for agg in aggs:
        vals = []
        src = nd[agg.on] if agg.on else None
        for g in range(len(uniq)):
            mask = inverse == g
            vals.append(agg.apply(
                {k: v[mask] for k, v in nd.items()}, src[mask]
                if src is not None else None))
        out[agg.output_name(key)] = np.asarray(vals)
    block = BlockAccessor.batch_to_block(out)
    return block, BlockAccessor(block).metadata()


def groupby_agg_fn(key: str, aggs: List[Any],
                   num_partitions: Optional[int] = None) -> Callable:
    import cloudpickle

    blobs = cloudpickle.dumps(aggs)

    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        if not bundles:
            return []
        n = num_partitions or min(len(bundles), 8)
        map_refs = [ray_tpu_torch.remote(_hash_partition)
                    .options(name="Data::GroupByMap")
                    .remote(b.block_ref, key, n) for b in bundles]
        red_refs = [ray_tpu_torch.remote(_agg_reduce)
                    .options(name="Data::GroupByReduce", num_returns=2)
                    .remote(map_refs, i, key, blobs) for i in range(n)]
        metas = ray_tpu_torch.get([r[1] for r in red_refs])
        return [RefBundle(r[0], meta)
                for r, meta in zip(red_refs, metas) if meta.num_rows]

    return bulk


# ---------------------------------------------------------------- global agg
def global_agg_fn(aggs: List[Any]) -> Callable:
    """Aggregate with no grouping → a single one-row block."""
    import cloudpickle

    blobs = cloudpickle.dumps(aggs)

    def _partial(block: Block, blob: bytes):
        aggs = cloudpickle.loads(blob)
        nd = BlockAccessor(block).to_numpy_dict()
        return [a.partial(nd) for a in aggs]

    def bulk(bundles: List[RefBundle]) -> List[RefBundle]:
        partial_refs = [ray_tpu_torch.remote(_partial).remote(b.block_ref, blobs)
                        for b in bundles]
        partials = ray_tpu_torch.get(partial_refs)
        out = {}
        for i, agg in enumerate(aggs):
            out[agg.output_name(None)] = np.asarray(
                [agg.finalize([p[i] for p in partials])])
        block = BlockAccessor.batch_to_block(out)
        return [RefBundle(ray_tpu_torch.put(block), BlockAccessor(block).metadata())]

    return bulk
