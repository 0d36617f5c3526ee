# Copied from ray_tpu/data/aggregate.py (ray_tpu -> ray_tpu_torch).
"""Aggregations (reference: python/ray/data/aggregate.py — AggregateFn with
Count/Sum/Min/Max/Mean/Std/AbsMax).

Two protocols:
- grouped: ``apply(group_dict, col_values) -> scalar`` per group;
- global: ``partial(block_dict) -> partial_state`` per block, then
  ``finalize(partials) -> scalar`` (distributive / algebraic aggregation).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class AggregateFn:
    agg_name = "agg"

    def __init__(self, on: Optional[str] = None, alias_name: Optional[str] = None):
        self.on = on
        self.alias = alias_name

    def output_name(self, key: Optional[str]) -> str:
        if self.alias:
            return self.alias
        return f"{self.agg_name}({self.on})" if self.on else f"{self.agg_name}()"

    # grouped path
    def apply(self, group: Dict[str, np.ndarray],
              col: Optional[np.ndarray]) -> Any:
        raise NotImplementedError

    # global path
    def partial(self, block: Dict[str, np.ndarray]) -> Any:
        raise NotImplementedError

    def finalize(self, partials: List[Any]) -> Any:
        raise NotImplementedError


class Count(AggregateFn):
    agg_name = "count"

    def apply(self, group, col):
        return len(next(iter(group.values()))) if group else 0

    def partial(self, block):
        return len(next(iter(block.values()))) if block else 0

    def finalize(self, partials):
        return int(sum(partials))


class Sum(AggregateFn):
    agg_name = "sum"

    def apply(self, group, col):
        return col.sum()

    def partial(self, block):
        return block[self.on].sum()

    def finalize(self, partials):
        return np.sum(partials)


class Min(AggregateFn):
    agg_name = "min"

    def apply(self, group, col):
        return col.min()

    def partial(self, block):
        v = block[self.on]
        return v.min() if len(v) else np.inf

    def finalize(self, partials):
        return np.min(partials)


class Max(AggregateFn):
    agg_name = "max"

    def apply(self, group, col):
        return col.max()

    def partial(self, block):
        v = block[self.on]
        return v.max() if len(v) else -np.inf

    def finalize(self, partials):
        return np.max(partials)


class Mean(AggregateFn):
    agg_name = "mean"

    def apply(self, group, col):
        return col.mean()

    def partial(self, block):
        v = block[self.on]
        return (v.sum(), len(v))

    def finalize(self, partials):
        total = sum(p[0] for p in partials)
        n = sum(p[1] for p in partials)
        return total / n if n else float("nan")


class Std(AggregateFn):
    agg_name = "std"

    def __init__(self, on=None, ddof: int = 1, alias_name=None):
        super().__init__(on, alias_name)
        self.ddof = ddof

    def apply(self, group, col):
        return col.std(ddof=self.ddof)

    def partial(self, block):
        v = block[self.on].astype(np.float64)
        return (v.sum(), (v * v).sum(), len(v))

    def finalize(self, partials):
        s = sum(p[0] for p in partials)
        s2 = sum(p[1] for p in partials)
        n = sum(p[2] for p in partials)
        if n - self.ddof <= 0:
            return float("nan")
        var = (s2 - s * s / n) / (n - self.ddof)
        return float(np.sqrt(max(var, 0.0)))


class AbsMax(AggregateFn):
    agg_name = "abs_max"

    def apply(self, group, col):
        return np.abs(col).max()

    def partial(self, block):
        v = block[self.on]
        return np.abs(v).max() if len(v) else 0

    def finalize(self, partials):
        return np.max(partials)
