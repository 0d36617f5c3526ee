# Copied from ray_tpu/remote_function.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""@ray_tpu_torch.remote functions.

Parity with the reference (reference: ``python/ray/remote_function.py``):
``RemoteFunction`` wraps the user function, ``.remote(...)`` submits through
the core worker, ``.options(...)`` returns a per-call override view validated
the same way (reference: ``python/ray/_private/ray_option_utils.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod

_VALID_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "resources", "num_returns",
    "max_retries", "retry_exceptions", "scheduling_strategy", "name",
    "placement_group", "placement_group_bundle_index", "runtime_env",
    "memory", "_metadata",
}


def _resources_from_options(opts: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    if opts.get("num_cpus") is not None:
        resources["CPU"] = float(opts["num_cpus"])
    if opts.get("num_gpus") is not None:
        resources["GPU"] = float(opts["num_gpus"])
    if opts.get("num_tpus") is not None:
        resources["TPU"] = float(opts["num_tpus"])
    if opts.get("memory") is not None:
        resources["memory"] = float(opts["memory"])
    return resources


def validate_options(opts: Dict[str, Any]) -> None:
    for k in opts:
        if k not in _VALID_OPTIONS and k not in (
            "max_restarts", "max_task_retries", "max_concurrency", "lifetime",
            "namespace", "get_if_exists", "max_pending_calls",
        ):
            raise ValueError(f"invalid option '{k}'")
    nr = opts.get("num_returns")
    if nr is not None:
        if isinstance(nr, str):
            if nr not in ("streaming", "dynamic"):
                raise ValueError(
                    "num_returns must be an int >= 0, 'streaming', or "
                    f"'dynamic', got {nr!r}")
            opts["num_returns"] = -1  # wire sentinel for streaming
        elif nr < 0:
            raise ValueError("num_returns must be >= 0")
    num_tpus = opts.get("num_tpus")
    if num_tpus:
        from ray_tpu_torch._private.accelerators.tpu import TPUAcceleratorManager

        ok, msg = TPUAcceleratorManager.validate_resource_request_quantity(num_tpus)
        if not ok:
            raise ValueError(msg)


class RemoteFunction:
    def __init__(self, function, **default_options):
        validate_options(default_options)
        self._function = function
        self._default_options = default_options
        functools.update_wrapper(self, function)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            "Remote functions cannot be called directly. "
            f"Use {self._function.__name__}.remote(...) instead."
        )

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def map(self, *iterables):
        """Vectorized submission: ``fn.map(xs)`` submits
        ``fn(x)`` for each x — ``builtins.map``/``zip`` semantics, so
        ``fn.map(xs, ys)`` submits ``fn(x, y)`` pairwise and stops at the
        shortest iterable (share a constant via ``itertools.repeat``).
        The whole batch is built in one pass through the driver
        (``Worker.submit_many``): one id block, one ownership
        registration, one trace stamp, one wire frame per destination.
        Returns one ObjectRef per call (a list of ref-lists when
        ``num_returns > 1``), in argument order."""
        return self._map(iterables, self._default_options)

    def bind(self, *args, **kwargs):
        """Lazy DAG node (reference: dag/dag_node.py bind)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def options(self, **options):
        validate_options(options)
        merged = {**self._default_options, **options}
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, merged)

            def map(self, *iterables):
                return parent._map(iterables, merged)

            def bind(self, *args, **kwargs):
                from ray_tpu_torch.dag import FunctionNode

                # self.remote already applies the merged options
                return FunctionNode(self, args, kwargs)

            def __getattr__(self, item):
                return getattr(parent, item)

        return _Wrapped()

    def _remote(self, args, kwargs, opts):
        w = worker_mod.global_worker
        if w is None or not w.connected:
            raise RuntimeError(
                "ray_tpu_torch.init() must be called before invoking remote functions"
            )
        refs = w.submit_task(
            self._function,
            args,
            kwargs,
            num_returns=opts.get("num_returns", 1),
            resources=_resources_from_options(opts),
            max_retries=opts.get("max_retries", -1),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            scheduling_strategy=opts.get("scheduling_strategy"),
            placement_group=_resolve_pg(opts),
            placement_group_bundle_index=_resolve_pg_bundle_index(opts),
            runtime_env=opts.get("runtime_env"),
            name=opts.get("name", ""),
        )
        if opts.get("num_returns", 1) == -1:
            return refs  # ObjectRefGenerator
        if opts.get("num_returns", 1) == 1:
            return refs[0]
        return refs

    def _map(self, iterables, opts):
        w = worker_mod.global_worker
        if w is None or not w.connected:
            raise RuntimeError(
                "ray_tpu_torch.init() must be called before invoking remote functions"
            )
        num_returns = opts.get("num_returns", 1)
        if num_returns == -1:
            raise ValueError("map() does not support streaming tasks")
        args_list = list(zip(*iterables)) if iterables else []
        batches = w.submit_many(
            self._function,
            args_list,
            num_returns=num_returns,
            resources=_resources_from_options(opts),
            max_retries=opts.get("max_retries", -1),
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            scheduling_strategy=opts.get("scheduling_strategy"),
            placement_group=_resolve_pg(opts),
            placement_group_bundle_index=_resolve_pg_bundle_index(opts),
            runtime_env=opts.get("runtime_env"),
            name=opts.get("name", ""),
        )
        if num_returns == 1:
            return [refs[0] for refs in batches]
        return batches

    @property
    def underlying_function(self):
        return self._function


def _resolve_pg(opts):
    strategy = opts.get("scheduling_strategy")
    if strategy is not None and type(strategy).__name__ == "PlacementGroupSchedulingStrategy":
        return strategy.placement_group
    return opts.get("placement_group")


def _resolve_pg_bundle_index(opts) -> int:
    strategy = opts.get("scheduling_strategy")
    if (strategy is not None
            and type(strategy).__name__ == "PlacementGroupSchedulingStrategy"
            and opts.get("placement_group_bundle_index") is None):
        return strategy.placement_group_bundle_index
    idx = opts.get("placement_group_bundle_index")
    return -1 if idx is None else idx
