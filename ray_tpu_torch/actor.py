# Copied from ray_tpu/actor.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Actor classes and handles.

Parity with the reference (reference: ``python/ray/actor.py``): ``ActorClass``
from ``@ray_tpu_torch.remote`` on a class, ``.remote(...)`` creates the actor
through the head, ``ActorHandle.method.remote(...)`` submits ordered actor
tasks directly to the actor process, handles are serializable and survive a
trip through task args.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch.remote_function import (
    _resources_from_options, validate_options, _resolve_pg,
    _resolve_pg_bundle_index)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str, num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, {})

    def bind(self, *args, **kwargs):
        """Lazy DAG node on an actor method (reference: dag ClassMethodNode)."""
        from ray_tpu_torch.dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._method_name, args, kwargs)

    def options(self, **opts):
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, opts)

            def bind(self, *args, **kwargs):
                from ray_tpu_torch.dag import ClassMethodNode

                return ClassMethodNode(parent._handle, parent._method_name,
                                       args, kwargs, opts)

        return _Wrapped()

    def _remote(self, args, kwargs, opts):
        w = worker_mod.global_worker
        num_returns = opts.get("num_returns", self._num_returns)
        if isinstance(num_returns, str):
            if num_returns not in ("streaming", "dynamic"):
                raise ValueError(f"bad num_returns {num_returns!r}")
            num_returns = -1
        refs = w.submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=num_returns,
            max_retries=opts.get(
                "max_task_retries",
                getattr(self._handle, "_max_task_retries", 0)),
        )
        if num_returns == -1:
            return refs  # ObjectRefGenerator
        if num_returns == 1:
            return refs[0]
        return refs


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = "Actor",
                 method_num_returns: Optional[Dict[str, int]] = None,
                 max_task_retries: int = 0):
        self._actor_id = actor_id
        self._class_name = class_name
        self._method_num_returns = method_num_returns or {}
        # creation-time opt-in: in-flight calls resubmit after a restart
        # (at-least-once; reference actor.py max_task_retries semantics)
        self._max_task_retries = max_task_retries

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        method = ActorMethod(self, item,
                             self._method_num_returns.get(item, 1))
        # cache on the instance: __getattr__ only fires on misses, so the
        # next `handle.method` costs a plain attribute lookup instead of a
        # fresh ActorMethod per call (hot in n:n actor benchmarks)
        self.__dict__[item] = method
        return method

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()})"

    def __reduce__(self):
        return (
            ActorHandle,
            (self._actor_id, self._class_name, self._method_num_returns,
             self._max_task_retries),
        )

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id


class ActorClass:
    def __init__(self, cls, **default_options):
        validate_options(default_options)
        self._cls = cls
        self._default_options = default_options
        functools.update_wrapper(self, cls, updated=[])

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actors cannot be instantiated directly. "
            f"Use {self._cls.__name__}.remote(...) instead."
        )

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._default_options)

    def options(self, **options):
        validate_options(options)
        merged = {**self._default_options, **options}
        parent = self

        class _Wrapped:
            def remote(self, *args, **kwargs):
                return parent._remote(args, kwargs, merged)

        return _Wrapped()

    def _remote(self, args, kwargs, opts) -> ActorHandle:
        w = worker_mod.global_worker
        if w is None or not w.connected:
            raise RuntimeError("ray_tpu_torch.init() must be called before creating actors")
        actor_id, _view = w.create_actor(
            self._cls,
            args,
            kwargs,
            resources=_resources_from_options(opts),
            max_restarts=opts.get("max_restarts",
                                  CONFIG.actor_max_restarts_default),
            max_concurrency=opts.get("max_concurrency", 1),
            name=opts.get("name", ""),
            namespace=opts.get("namespace", "default"),
            lifetime=opts.get("lifetime"),
            get_if_exists=bool(opts.get("get_if_exists", False)),
            scheduling_strategy=opts.get("scheduling_strategy"),
            placement_group=_resolve_pg(opts),
            placement_group_bundle_index=_resolve_pg_bundle_index(opts),
            runtime_env=opts.get("runtime_env"),
        )
        method_num_returns = {}
        for name in dir(self._cls):
            attr = getattr(self._cls, name, None)
            if callable(attr) and hasattr(attr, "_num_returns"):
                method_num_returns[name] = attr._num_returns
        return ActorHandle(actor_id, self._cls.__name__, method_num_returns,
                           max_task_retries=int(
                               opts.get("max_task_retries", 0)))


def method(num_returns: int = 1):
    """Decorator for actor methods with multiple returns
    (reference: python/ray/actor.py ray.method)."""

    def deco(fn):
        fn._num_returns = num_returns
        return fn

    return deco


def exit_actor():
    """Terminate the current actor process after the in-flight call replies
    (reference: ray.actor.exit_actor)."""
    import os
    import threading

    def later():
        import time

        time.sleep(0.1)
        os._exit(0)

    threading.Thread(target=later, daemon=True).start()
    raise SystemExit(0)
