# Copied from ray_tpu/util/dask.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Dask-on-ray_tpu_torch scheduler (reference: python/ray/util/dask/ —
ray_dask_get: a dask scheduler executing graph tasks as framework tasks).

Gated on `dask` being importable (not in this image's baked set). The
scheduler walks the dask graph in topological order, submitting each task
as a remote task whose arguments are the upstream ObjectRefs — dependency
resolution and scheduling then ride the framework's own object plane.
"""

from __future__ import annotations

from typing import Any, Dict

import ray_tpu_torch


def _require_dask():
    try:
        import dask  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "ray_tpu_torch.util.dask requires `dask`, which is not installed "
            "in this environment.") from e


def ray_dask_get(dsk: Dict, keys, **kwargs) -> Any:
    """Drop-in dask scheduler: ``dask.compute(x, scheduler=ray_dask_get)``
    (reference: util/dask/scheduler.py ray_dask_get)."""
    _require_dask()
    import dask

    from dask.core import istask, toposort

    refs: Dict[Any, Any] = {}

    @ray_tpu_torch.remote
    def run_task(func, *args):
        return func(*args)

    def _hashable(x):
        try:
            hash(x)
            return True
        except TypeError:
            return False

    def resolve(arg):
        """Swap graph keys for their (ref) results, recursing into
        collections AND nested task tuples the way dask graphs nest
        them — (add, (inc, 1), 2) executes inner tasks too."""
        if _hashable(arg) and arg in refs:
            return refs[arg]
        if istask(arg):
            return submit(arg)
        if isinstance(arg, list):
            return [resolve(a) for a in arg]
        if isinstance(arg, tuple):
            return tuple(resolve(a) for a in arg)
        return arg

    def submit(task_tuple):
        func, *args = task_tuple
        # refs pass straight through as task args: the runtime resolves
        # them to values before the function runs
        return run_task.remote(func, *[resolve(a) for a in args])

    for key in toposort(dsk):
        val = dsk[key]
        refs[key] = submit(val) if istask(val) else resolve(val)

    def fetch(k):
        v = refs[k]
        return ray_tpu_torch.get(v) if isinstance(v, ray_tpu_torch.ObjectRef) else v

    if isinstance(keys, list):
        return [fetch(k) if _hashable(k) and k in refs else k
                for k in keys]
    return fetch(keys)


def enable_dask_on_ray() -> None:
    """Set ray_dask_get as dask's default scheduler (reference:
    util/dask enable_dask_on_ray)."""
    _require_dask()
    import dask

    dask.config.set(scheduler=ray_dask_get)
