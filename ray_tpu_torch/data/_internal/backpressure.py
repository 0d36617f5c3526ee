# Copied from ray_tpu/data/_internal/backpressure.py (ray_tpu -> ray_tpu_torch).
"""Pluggable backpressure policies + resource manager for the streaming
executor.

Reference: python/ray/data/_internal/execution/backpressure_policy/
backpressure_policy.py (the ABC consulted by the scheduling loop via
``can_add_input``), concurrency_cap_backpressure_policy.py,
streaming_output_backpressure_policy.py, and
execution/resource_manager.py (per-op memory accounting + global budget).

Here the policies replace the executor's two hardcoded caps: every
dispatch decision asks each policy ``can_dispatch(op_index)``; a policy
list lives on the DataContext so users can extend or reorder it.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Type

if TYPE_CHECKING:
    from ray_tpu_torch.data._internal.executor import StreamingExecutor, Topology


class BackpressurePolicy:
    """One throttling rule. Policies are constructed per-execution with the
    topology and executor, and consulted on every dispatch attempt; a
    single False vetoes the dispatch."""

    def __init__(self, topology: "Topology", executor: "StreamingExecutor"):
        self.topology = topology
        self.executor = executor

    def can_dispatch(self, op_index: int) -> bool:
        return True


class ConcurrencyCapBackpressurePolicy(BackpressurePolicy):
    """Bound concurrent tasks per operator. The cap comes from the
    operator itself (``max_concurrency``, set by the user via
    ``map_batches(concurrency=...)``) or the context default — moved here
    from the operators' own ``can_dispatch`` so the rule is uniform and
    overridable (reference: concurrency_cap_backpressure_policy.py)."""

    def __init__(self, topology, executor):
        super().__init__(topology, executor)
        from ray_tpu_torch.data.context import DataContext

        self._default_cap = DataContext.get_current() \
            .max_tasks_in_flight_per_op

    def can_dispatch(self, op_index: int) -> bool:
        op = self.topology.ops[op_index]
        cap = getattr(op, "max_concurrency", None) or self._default_cap
        return op.num_active_tasks() < cap


class StreamingOutputBackpressurePolicy(BackpressurePolicy):
    """Bound the bundles buffered at each operator's output edge and at the
    consumer edge, so a slow consumer throttles the whole pipeline instead
    of the dataset accumulating in RAM (reference:
    streaming_output_backpressure_policy.py
    MAX_BLOCKS_IN_OP_OUTPUT_QUEUE / MAX_BLOCKS_IN_GENERATOR_BUFFER)."""

    def __init__(self, topology, executor):
        super().__init__(topology, executor)
        from ray_tpu_torch.data.context import DataContext

        ctx = DataContext.get_current()
        self.per_op_buffer = ctx.per_op_buffer
        self.output_buffer = ctx.output_buffer

    def can_dispatch(self, op_index: int) -> bool:
        if self.executor.out.qsize() >= self.output_buffer:
            return False
        op = self.topology.ops[op_index]
        backlog = len(op.output_queue)
        for dst, _ in self.topology.edges.get(op_index, []):
            backlog += len(self.topology.ops[dst].input_queue)
        return backlog < self.per_op_buffer


class ResourceBudgetBackpressurePolicy(BackpressurePolicy):
    """Global memory budget over buffered block bytes (the ResourceManager
    below does the accounting). When the pipeline holds more than
    ``DataContext.execution_memory_limit`` bytes of queued blocks, only the
    most-downstream dispatchable operator may run — draining toward the
    consumer frees memory; letting upstream reads run would grow it
    (reference: resource_manager.py ReservationOpResourceAllocator's
    downstream-first eviction order)."""

    def __init__(self, topology, executor):
        super().__init__(topology, executor)
        self.manager = executor.resource_manager

    def can_dispatch(self, op_index: int) -> bool:
        if self.manager.budget_bytes <= 0:   # unlimited
            return True
        if self.manager.usage_bytes() < self.manager.budget_bytes:
            return True
        # over budget: permit only the most-downstream op that could run,
        # so progress (and memory release) is still possible — never a
        # full stall
        return op_index == self.manager.most_downstream_dispatchable()


DEFAULT_BACKPRESSURE_POLICIES: List[Type[BackpressurePolicy]] = [
    ConcurrencyCapBackpressurePolicy,
    StreamingOutputBackpressurePolicy,
    ResourceBudgetBackpressurePolicy,
]


class ResourceManager:
    """Tracks how many bytes of block payload each operator currently holds
    in its queues (input + output edges, by block metadata — payloads stay
    in the object store, reference: execution/resource_manager.py
    update_usages). Cheap to recompute per scheduling step: topologies are
    a handful of ops with bounded queues."""

    def __init__(self, topology: "Topology", budget_bytes: int):
        self.topology = topology
        self.budget_bytes = budget_bytes

    def op_usage_bytes(self, op_index: int) -> int:
        op = self.topology.ops[op_index]
        total = 0
        for q in (op.input_queue, op.output_queue):
            for bundle in q:
                meta = getattr(bundle, "meta", None)
                if meta is not None:
                    total += meta.size_bytes
        # bytes held outside the queues: the streaming shuffle's sealed
        # shard objects — without this the budget policy was
        # blind to the exchange's working set
        total += op.extra_usage_bytes()
        return total

    def usage_bytes(self) -> int:
        return sum(self.op_usage_bytes(i)
                   for i in range(len(self.topology.ops)))

    def most_downstream_dispatchable(self) -> Optional[int]:
        for i in reversed(range(len(self.topology.ops))):
            if self.topology.ops[i].can_dispatch():
                return i
        return None

    def usage_report(self) -> Dict[str, int]:
        return {op.name: self.op_usage_bytes(i)
                for i, op in enumerate(self.topology.ops)}
