# Copied from ray_tpu/data/_internal/logical.py (ray_tpu -> ray_tpu_torch).
"""Logical plan for ray_tpu_torch.data.

A ``Dataset`` is an immutable chain of ``LogicalOperator`` nodes (reference:
python/ray/data/_internal/logical/operators/). The optimizer rewrites the
chain (fusion, limit pushdown — reference: _internal/logical/rules/) before
the planner lowers it to physical operators.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union


class LogicalOperator:
    name: str = "op"

    def __init__(self, input_op: Optional["LogicalOperator"] = None):
        self.input_op = input_op

    def chain(self) -> List["LogicalOperator"]:
        ops: List[LogicalOperator] = []
        op: Optional[LogicalOperator] = self
        while op is not None:
            ops.append(op)
            op = op.input_op
        return list(reversed(ops))

    def __repr__(self):
        return self.name


class Read(LogicalOperator):
    """Source: a list of read tasks, each producing one or more blocks
    (reference: logical/operators/read_operator.py)."""

    def __init__(self, read_tasks: List[Callable[[], Any]], name: str = "Read"):
        super().__init__(None)
        self.read_tasks = read_tasks
        self.name = name


class InputData(LogicalOperator):
    """Source: pre-materialized (block_ref, metadata) bundles."""

    name = "FromBlocks"

    def __init__(self, bundles: List[Tuple[Any, Any]]):
        super().__init__(None)
        self.bundles = bundles


@dataclasses.dataclass
class MapSpec:
    """One fused-able row/batch transform stage."""

    kind: str  # "batches" | "rows" | "filter" | "flat"
    fn: Any  # callable, or class for actor compute
    fn_args: tuple = ()
    fn_kwargs: Optional[dict] = None
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: Optional[dict] = None
    batch_size: Optional[int] = None
    batch_format: str = "numpy"


class AbstractMap(LogicalOperator):
    """Any 1-in/1-out transform executed as parallel tasks or an actor pool
    (reference: logical/operators/map_operator.py)."""

    def __init__(self, input_op: LogicalOperator, spec: MapSpec, name: str,
                 compute: Optional[Any] = None,
                 ray_remote_args: Optional[Dict] = None):
        super().__init__(input_op)
        self.specs = [spec]
        self.name = name
        self.compute = compute
        self.ray_remote_args = ray_remote_args or {}


class Limit(LogicalOperator):
    def __init__(self, input_op: LogicalOperator, limit: int):
        super().__init__(input_op)
        self.limit = limit
        self.name = f"Limit[{limit}]"


class AbstractAllToAll(LogicalOperator):
    """Barrier ops: repartition / shuffle / sort / aggregate
    (reference: logical/operators/all_to_all_operator.py)."""

    def __init__(self, input_op: LogicalOperator, kind: str, name: str,
                 **kwargs):
        super().__init__(input_op)
        self.kind = kind
        self.name = name
        self.kwargs = kwargs


class Union(LogicalOperator):
    def __init__(self, input_op: LogicalOperator,
                 others: List[LogicalOperator]):
        super().__init__(input_op)
        self.others = others
        self.name = "Union"


class Zip(LogicalOperator):
    def __init__(self, input_op: LogicalOperator, other: LogicalOperator):
        super().__init__(input_op)
        self.other = other
        self.name = "Zip"


class Write(LogicalOperator):
    def __init__(self, input_op: LogicalOperator, write_fn: Callable,
                 name: str = "Write"):
        super().__init__(input_op)
        self.write_fn = write_fn
        self.name = name
