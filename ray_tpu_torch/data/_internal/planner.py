# Copied from ray_tpu/data/_internal/planner.py (ray_tpu -> ray_tpu_torch).
"""Optimizer + planner: logical chain → physical Topology.

Reference: python/ray/data/_internal/logical/optimizers.py (rule pipeline)
and _internal/planner/planner.py. Rules implemented:

- **Operator fusion** (rules/operator_fusion.py): consecutive task-compute
  map stages collapse into one task per block; a map stage directly above a
  Read fuses into the read task, so e.g. ``read_parquet(...).map_batches(f)``
  is one task per file.
- **Limit pushdown** (rules/limit_pushdown.py): Limit moves below pure
  per-row maps so slicing happens before the transform.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.data._internal import logical as L
from ray_tpu_torch.data._internal.executor import Topology
from ray_tpu_torch.data._internal import physical as P
from ray_tpu_torch.data._internal import shuffle as S


# ------------------------------------------------------------- optimizer
def _fusable(op: L.LogicalOperator) -> bool:
    return isinstance(op, L.AbstractMap) and op.compute is None


def optimize(ops: List[L.LogicalOperator]) -> List[L.LogicalOperator]:
    ops = _limit_pushdown(ops)
    return _fuse(ops)


def _limit_pushdown(ops: List[L.LogicalOperator]) -> List[L.LogicalOperator]:
    out = list(ops)
    changed = True
    while changed:
        changed = False
        for i in range(1, len(out)):
            if (isinstance(out[i], L.Limit)
                    and isinstance(out[i - 1], L.AbstractMap)
                    and all(s.kind == "rows" for s in out[i - 1].specs)):
                out[i - 1], out[i] = out[i], out[i - 1]
                changed = True
    return out


def _fuse(ops: List[L.LogicalOperator]) -> List[L.LogicalOperator]:
    # Logical nodes are shared across derived Datasets (the chain is
    # immutable); fusion works on per-plan copies.
    import copy

    out: List[L.LogicalOperator] = []
    for op in ops:
        if (_fusable(op) and out and _fusable(out[-1])
                and (not out[-1].ray_remote_args or not op.ray_remote_args
                     or out[-1].ray_remote_args == op.ray_remote_args)):
            # refuse to fuse stages with conflicting resource requests
            # (reference: rules/operator_fusion.py _can_fuse)
            prev = out[-1]
            prev.specs = prev.specs + op.specs
            prev.name = f"{prev.name}->{op.name}"
            prev.ray_remote_args = op.ray_remote_args or prev.ray_remote_args
        elif (_fusable(op) and not op.ray_remote_args and out
              and isinstance(out[-1], L.Read)
              and not getattr(out[-1], "_no_fuse", False)):
            read = out[-1]
            read._fused_specs = getattr(read, "_fused_specs", []) + op.specs
            read.name = f"{read.name}->{op.name}"
        else:
            node = copy.copy(op)
            if isinstance(node, L.AbstractMap):
                node.specs = list(node.specs)
            out.append(node)
    return out


# --------------------------------------------------------------- planner
def plan(ops: List[L.LogicalOperator],
         max_concurrency: Optional[int] = None) -> Topology:
    if max_concurrency is None:
        from ray_tpu_torch.data.context import DataContext

        max_concurrency = DataContext.get_current() \
            .max_tasks_in_flight_per_op
    topo = Topology()
    last = _plan_chain(ops, topo, max_concurrency)
    if last is None:
        raise ValueError("empty plan")
    return topo


def _plan_chain(ops: List[L.LogicalOperator], topo: Topology,
                max_concurrency: int) -> Optional[int]:
    last: Optional[int] = None
    for op in ops:
        if isinstance(op, L.Read):
            idx = topo.add(P.TaskPoolMapOperator(
                op.name, getattr(op, "_fused_specs", []),
                read_tasks=list(op.read_tasks),
                max_concurrency=max_concurrency))
        elif isinstance(op, L.InputData):
            idx = topo.add(P.InputDataBuffer(
                [P.RefBundle(ref, meta) for ref, meta in op.bundles]))
        elif isinstance(op, L.AbstractMap):
            compute = op.compute
            if compute is not None and getattr(compute, "is_actor_pool", False):
                spec = op.specs[0]
                idx = topo.add(P.ActorPoolMapOperator(
                    op.name, op.specs, spec.fn,
                    pool_size=compute.size,
                    fn_constructor_args=spec.fn_constructor_args,
                    fn_constructor_kwargs=spec.fn_constructor_kwargs,
                    ray_remote_args=op.ray_remote_args))
            else:
                idx = topo.add(P.TaskPoolMapOperator(
                    op.name, op.specs, max_concurrency=max_concurrency,
                    ray_remote_args=op.ray_remote_args))
        elif isinstance(op, L.Limit):
            idx = topo.add(P.LimitOperator(op.limit))
        elif isinstance(op, L.AbstractAllToAll):
            from ray_tpu_torch.data.context import DataContext

            if (op.kind in ("random_shuffle", "sort")
                    and DataContext.get_current().streaming_shuffle):
                # pipelined per-shard exchange; the
                # materializing barrier below stays as the kill-switch
                # path and for the remaining bulk kinds
                from ray_tpu_torch.data._internal.streaming_shuffle import (
                    build_streaming_shuffle)

                idx = topo.add(build_streaming_shuffle(op))
            else:
                idx = topo.add(P.AllToAllOperator(op.name, _bulk_fn(op)))
        elif isinstance(op, L.Union):
            idx = topo.add(P.UnionOperator(1 + len(op.others)))
            for branch in op.others:
                b_last = _plan_chain(
                    optimize(branch.chain()), topo, max_concurrency)
                topo.connect(b_last, idx)
        elif isinstance(op, L.Zip):
            idx = topo.add(P.ZipOperator())
            b_last = _plan_chain(
                optimize(op.other.chain()), topo, max_concurrency)
            topo.connect(b_last, idx, port="right")
        elif isinstance(op, L.Write):
            spec = L.MapSpec(kind="batches", fn=op.write_fn,
                             batch_format="default")
            idx = topo.add(P.TaskPoolMapOperator(
                op.name, [spec], max_concurrency=max_concurrency))
        else:
            raise TypeError(f"cannot plan {type(op).__name__}")
        if last is not None:
            topo.connect(last, idx)
        last = idx
    return last


def _bulk_fn(op: L.AbstractAllToAll):
    kw = op.kwargs
    if op.kind == "repartition":
        return S.repartition_fn(kw["num_blocks"])
    if op.kind == "random_shuffle":
        return S.random_shuffle_fn(kw.get("seed"), kw.get("num_blocks"))
    if op.kind == "sort":
        return S.sort_fn(kw["key"], kw.get("descending", False))
    if op.kind == "groupby_agg":
        return S.groupby_agg_fn(kw["key"], kw["aggs"],
                                kw.get("num_partitions"))
    if op.kind == "global_agg":
        return S.global_agg_fn(kw["aggs"])
    raise ValueError(f"unknown all-to-all kind {op.kind!r}")
