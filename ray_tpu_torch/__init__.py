# Copied from ray_tpu/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu.

A package beside ``ray_tpu``: it imports ``torch`` and numpy, never ``jax``
and never a module of ``ray_tpu``; what it needs from there it keeps its own
copy of. It holds:

- the runtime (tasks, actors, objects; the head, the agents, the workers and
  the object store), copied from ``ray_tpu`` with a session root of each
  checkout's own (``/dev/shm/ray_tpu_torch-<hash>``) and its own
  ``RAY_TPU_TORCH_`` settings, and
  booted with ``ray_tpu_torch.init(num_gpus=...)``. Each copied file is
  headed "Copied from ray_tpu/<path>" and is the original with
  ``ray_tpu`` renamed ``ray_tpu_torch``, ``RAY_TPU_`` renamed
  ``RAY_TPU_TORCH_`` and the original's tracker references left out, so a
  later fix carries across by diff; the ported places differ beyond that;
- the DAG API (``ray_tpu_torch.dag``: ``bind``, ``experimental_compile``
  over ``experimental.Channel``) and the ``ray://`` client
  (``init(address="ray://host:port")`` to a ``util.client.serve`` server);
- the operator's surface: job submission (``job_submission``), the
  dashboard's REST API and Grafana dashboards (``dashboard``), the CLI
  (``python -m ray_tpu_torch.scripts.cli``), durable workflows over the DAG
  API (``workflow``), ``experimental.tqdm_ray``,
  ``experimental.dynamic_resources`` and ``cross_language``;
- the Serve control plane (``ray_tpu_torch.serve``), whose
  ``serve.llm.build_llama_app`` serves Llama generation from a replica that
  holds a GPU;
- the compute path: Llama generation through ``LlamaGenerator``
  (``ray_tpu_torch.serve.llm``), the Llama train step, LoRA or dense
  (``ray_tpu_torch.parallel.train_step`` with ``models.llama.llama_loss``),
  with attention, forward and backward, in hand-written CUDA kernels
  (``ray_tpu_torch.ops.cuda.flash_attention``), trained with ``adamw`` or
  ``adafactor``; beside them kv-cache decode, ``merge_lora``, blockwise
  attention, the MLP family and the Mixtral-style MoE.

Its entry points run on the CUDA card unless the caller passes
``device="cpu"``. Importing the package does not import ``torch``: the
runtime's daemons (head, agent, forkserver) and its parked workers import
it, and keep torch out as the JAX runtime keeps jax out.

Public core API parity (reference: ``python/ray/__init__.py``):
``init/shutdown/is_initialized/remote/get/put/wait/kill/cancel/
get_actor/method/nodes/cluster_resources/available_resources/timeline``.
"""

from __future__ import annotations

import atexit
import inspect
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID
from ray_tpu_torch._private.node import Node
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.streaming import (
    DynamicObjectRefGenerator, ObjectRefGenerator)
from ray_tpu_torch.actor import ActorClass, ActorHandle, method, exit_actor
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "exit_actor", "nodes",
    "cluster_resources", "available_resources", "ObjectRef", "ActorHandle",
    "get_runtime_context", "exceptions", "timeline", "__version__",
    "ObjectRefGenerator", "DynamicObjectRefGenerator", "resolve_device",
]


def __getattr__(name: str):
    # ``resolve_device`` imports torch: load it on first use, so that the
    # runtime's processes, which import this package, never import torch
    if name == "resolve_device":
        from ray_tpu_torch._private.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


_init_lock = threading.Lock()
_global_node: Optional[Node] = None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_tpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    labels: Optional[Dict[str, str]] = None,
    namespace: str = "default",
    ignore_reinit_error: bool = False,
    _node: Optional[Node] = None,
    **_kwargs,
) -> "ClientContext":
    """Start (or connect to) a cluster and attach this process as a driver.

    - ``init()`` boots a local head + agent (reference: worker.py:1225).
    - ``init(address="host:port")`` connects to an existing head by starting a
      local agent joined to it.
    - ``init(_node=...)`` attaches to an already-running Node (tests).
    """
    global _global_node
    if address and address.startswith("ray://"):
        # client mode: proxy the API to a remote driver (reference:
        # client_builder.py ray.init("ray://...") path). Named params ride
        # along so e.g. namespace reaches the server-side driver.
        from ray_tpu_torch.util.client import connect as _client_connect

        named = {"num_cpus": num_cpus, "num_tpus": num_tpus,
                 "num_gpus": num_gpus, "resources": resources,
                 "object_store_memory": object_store_memory,
                 "labels": labels, "namespace": namespace}
        fwd = {k: v for k, v in named.items() if v is not None}
        fwd.update(_kwargs)
        return _client_connect(address, **fwd)
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return ClientContext(_worker_mod.global_worker)
            raise RuntimeError("ray_tpu_torch.init() called twice")
        # stale-session GC: reclaim /dev/shm segments and session dirs
        # whose registered pids are all dead — a previous run's leak must
        # not starve this one (lifecycle supervisor contract)
        try:
            from ray_tpu_torch._private import lifecycle as _lifecycle

            _lifecycle.gc_stale_sessions()
        except Exception:
            pass
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        if num_tpus is not None:
            res["TPU"] = float(num_tpus)
        if num_gpus is not None:
            res["GPU"] = float(num_gpus)
        if _node is not None:
            node = _node
        elif address is None or address == "local":
            node = Node(head=True, resources=res or None, labels=labels,
                        object_store_memory=object_store_memory)
            node.start()
            _global_node = node
        else:
            host, _, port = address.partition(":")
            node = Node(head=False, head_host=host or "127.0.0.1",
                        head_port=int(port), resources=res or None, labels=labels,
                        object_store_memory=object_store_memory)
            node.start()
            _global_node = node
        w = _worker_mod.Worker()
        w.namespace = namespace
        w.connect(node.agent_unix_path, mode=_worker_mod.Worker.MODE_DRIVER)
        atexit.register(shutdown)
        return ClientContext(w)


def shutdown() -> None:
    global _global_node
    w = _worker_mod.global_worker
    if w is not None:
        try:
            # acked flush: events/spans recorded right before shutdown
            # survive into the head ring instead of racing the disconnect
            w.flush_task_events(wait=True)
        except Exception:
            pass
        w.disconnect()
    if _global_node is not None:
        _global_node.stop(cleanup_session=True)
        _global_node = None
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass


def is_initialized() -> bool:
    return _worker_mod.global_worker is not None and _worker_mod.global_worker.connected


def _require_worker() -> _worker_mod.Worker:
    w = _worker_mod.global_worker
    if w is None or not w.connected:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    return w


def remote(*args, **options):
    """``@ray_tpu_torch.remote`` for functions and classes
    (reference: python/ray/_private/worker.py remote)."""
    if len(args) == 1 and not options and (inspect.isfunction(args[0]) or
                                           inspect.isclass(args[0])):
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target)
        return RemoteFunction(target)

    def deco(target):
        if inspect.isclass(target):
            return ActorClass(target, **options)
        return RemoteFunction(target, **options)

    return deco


def get(
    refs: Union[ObjectRef, Sequence[ObjectRef]],
    *,
    timeout: Optional[float] = None,
) -> Any:
    w = _require_worker()
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout=timeout)[0]
    # compiled-DAG result handles resolve through their channel, not the
    # object store (reference: CompiledDAGRef supports ray.get)
    compiled_get = getattr(refs, "_compiled_get", None)
    if compiled_get is not None:
        return compiled_get(timeout=timeout)
    if not isinstance(refs, (list, tuple)):
        raise TypeError("ray_tpu_torch.get() expects an ObjectRef or a list of them")
    if refs and any(hasattr(r, "_compiled_get") for r in refs):
        if not all(hasattr(r, "_compiled_get") for r in refs):
            raise TypeError(
                "ray_tpu_torch.get() cannot mix CompiledDAGRefs with ObjectRefs "
                "in one list")
        return [r._compiled_get(timeout=timeout) for r in refs]
    return w.get(list(refs), timeout=timeout)


def put(value: Any) -> ObjectRef:
    w = _require_worker()
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return w.put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    w = _require_worker()
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return w.wait(refs, num_returns, timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    w = _require_worker()
    w.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    w = _require_worker()
    w.cancel_task(ref, force=force)


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    w = _require_worker()
    actor_id, view = w.get_named_actor(name, namespace)
    return ActorHandle(actor_id, view.get("class_name", "Actor"))


def nodes() -> List[Dict]:
    w = _require_worker()
    return w._acall(w.head.call("ListNodes", {}, timeout=CONFIG.control_rpc_timeout_s))


def cluster_resources() -> Dict[str, float]:
    from ray_tpu_torch._private.resources import ResourceSet

    total: Dict[str, float] = {}
    for n in nodes():
        if not n["alive"]:
            continue
        for k, v in ResourceSet.from_wire(n["resources_total"]).to_dict().items():
            total[k] = total.get(k, 0.0) + v
    return total


def available_resources() -> Dict[str, float]:
    from ray_tpu_torch._private.resources import ResourceSet

    total: Dict[str, float] = {}
    for n in nodes():
        if not n["alive"]:
            continue
        for k, v in ResourceSet.from_wire(n["resources_available"]).to_dict().items():
            total[k] = total.get(k, 0.0) + v
    return total


def timeline(filename: Optional[str] = None) -> List[Dict]:
    """Chrome-trace / Perfetto timeline (reference:
    python/ray/_private/state.py:924 ``ray.timeline``).

    Built from the cluster flight recorder: nested per-phase
    ``X`` slices — submit → lease-wait → exec (arg-resolve / return-put),
    put/pull/broadcast object slices, actor-call enqueue→exec — grouped
    into one lane per trace with ``M`` process metadata, plus instant
    markers for legacy task state transitions. Spans exist only when
    ``task_event_sample_rate`` > 0; the state-transition instants are
    always present.

    The flush is ACKED through the head before reading (read-your-writes
    — the old ``time.sleep(0.05)`` race is gone).
    """
    from ray_tpu_torch._private.events import to_chrome_trace

    w = _require_worker()
    w.flush_task_events(wait=True)
    events = w._acall(w.head.call("ListTaskEvents", {"limit": 100000},
                                  timeout=CONFIG.control_rpc_timeout_s))
    spans = w._acall(w.head.call("ListSpans", {"limit": 100000},
                                 timeout=CONFIG.control_rpc_timeout_s))
    out = to_chrome_trace(spans, events)
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(out, f)
    return out


class ClientContext:
    def __init__(self, worker):
        self._worker = worker
        self.address_info = {
            "node_id": worker.node_id,
            "session_dir": getattr(_global_node, "session_dir", ""),
        }

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        shutdown()

    def disconnect(self):
        shutdown()
