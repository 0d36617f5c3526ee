# Copied from ray_tpu/workflow/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Durable workflows (reference: python/ray/workflow/ — workflow.run
api.py:123, run_async :177, WorkflowExecutor + step checkpointing
workflow_storage.py, continuations workflow_executor.py, event system
http_event_provider.py).

Executes a ``ray_tpu_torch.dag`` graph with every step's result checkpointed to
storage; ``resume`` re-runs the graph, skipping steps whose checkpoints
exist — lineage-on-disk rather than lineage-in-memory.

Dynamic workflows: a step may return ``workflow.continuation(sub_dag)``;
the engine executes the sub-DAG as that step's continuation, each sub-step
durably checkpointed under the parent step's key prefix, so a crash inside
a continuation resumes mid-continuation (reference:
workflow_executor.py's continuation handling).

Storage is scheme-pluggable: ``init("mock://bucket/workflows")`` (or any
registered backend, _private/storage.py) persists checkpoints remotely —
the reference's equivalent of workflow storage on S3/GCS.

Port deviation (the reference checkpoints ``jax.Array`` results as host
numpy): a step's result and its checkpoint go through the port's
serializer, which brings a CUDA tensor to the host. A step that returns a
tensor on the card hands the driver a CPU tensor of the same dtype, shape
and bits, and ``resume`` reads the same CPU tensor back from its
checkpoint without running the step. Nothing is put back on a device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode, FunctionNode, InputNode, MultiOutputNode

_storage_root = os.path.expanduser("~/ray_tpu_torch_workflows")


def init(storage: Optional[str] = None) -> None:
    global _storage_root
    if storage:
        _storage_root = storage
    _Store(_storage_root).makedirs("")


# --------------------------------------------------------------- storage
class _Store:
    """Workflow storage over a local dir OR a remote URI (scheme resolves
    a StorageBackend — reference: workflow_storage.py over pyarrow fs)."""

    def __init__(self, root: str):
        from ray_tpu_torch._private.storage import is_remote_uri

        self.root = root
        self.remote = is_remote_uri(root)

    def _backend(self):
        from ray_tpu_torch._private.storage import get_storage_backend

        return get_storage_backend(self.root)

    def _join(self, *parts: str) -> str:
        from ray_tpu_torch._private.storage import join_uri

        if self.remote:
            return join_uri(self.root, *parts)
        return os.path.join(self.root, *parts)

    def makedirs(self, rel: str) -> None:
        if self.remote:
            return
        os.makedirs(self._join(rel) if rel else self.root, exist_ok=True)

    def write_bytes(self, rel: str, data: bytes) -> None:
        if self.remote:
            self._backend().write_bytes(self._join(rel), data)
            return
        path = self._join(rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def read_bytes(self, rel: str) -> Optional[bytes]:
        try:
            if self.remote:
                return self._backend().read_bytes(self._join(rel))
            with open(self._join(rel), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            return None

    def exists(self, rel: str) -> bool:
        if self.remote:
            return self._backend().exists(self._join(rel))
        return os.path.exists(self._join(rel))

    def listdir(self, rel: str = "") -> List[str]:
        if self.remote:
            return self._backend().listdir(
                self._join(rel) if rel else self.root)
        p = self._join(rel) if rel else self.root
        return sorted(os.listdir(p)) if os.path.isdir(p) else []

    def delete(self, rel: str) -> None:
        if self.remote:
            self._backend().delete(self._join(rel))
            return
        import shutil

        shutil.rmtree(self._join(rel), ignore_errors=True)


# ---------------------------------------------------------- continuations
class Continuation:
    """Returned by a step to hand execution to a dynamically-built
    sub-DAG (reference: workflow.continuation — api.py)."""

    def __init__(self, dag: DAGNode):
        if not isinstance(dag, DAGNode):
            raise TypeError("continuation() takes a bound DAG node")
        self.dag = dag


def continuation(dag: DAGNode) -> Continuation:
    return Continuation(dag)


def _node_keys(root: DAGNode, prefix: str = "") -> Dict[int, str]:
    """Deterministic step keys: postorder index + function name."""
    keys: Dict[int, str] = {}
    counter = [0]

    def visit(node: DAGNode):
        if id(node) in keys:
            return
        for a in list(node._bound_args) + list(node._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                visit(a)
        name = type(node).__name__
        if isinstance(node, FunctionNode):
            name = getattr(node._remote_fn, "__name__", "fn")
        keys[id(node)] = f"{prefix}step_{counter[0]:04d}_{name}"
        counter[0] += 1

    visit(root)
    return keys


class _DurableExecutor:
    def __init__(self, workflow_id: str, root: DAGNode, prefix: str = ""):
        self.workflow_id = workflow_id
        self.store = _Store(_storage_root)
        self.store.makedirs(workflow_id)
        self.keys = _node_keys(root, prefix)
        self.root = root

    def _ckpt_rel(self, node) -> str:
        return f"{self.workflow_id}/{self.keys[id(node)]}.pkl"

    def _set_status(self, status: str) -> None:
        self.store.write_bytes(
            f"{self.workflow_id}/status.json",
            json.dumps({"status": status, "time": time.time()}).encode())

    def run(self, *input_args, **input_kwargs) -> Any:
        self._set_status("RUNNING")
        try:
            result = self.run_inner(input_args, input_kwargs)
            self._set_status("SUCCESSFUL")
            return result
        except Exception:
            self._set_status("FAILED")
            raise

    def run_inner(self, input_args, input_kwargs) -> Any:
        result = self._exec(self.root, input_args, input_kwargs)
        if isinstance(result, ray_tpu_torch.ObjectRef):
            result = ray_tpu_torch.get(result)
        elif isinstance(result, list):
            result = [ray_tpu_torch.get(r) if isinstance(r, ray_tpu_torch.ObjectRef)
                      else r for r in result]
        return result

    def _exec(self, node: DAGNode, input_args, input_kwargs):
        if isinstance(node, InputNode):
            return node._execute_node({}, input_args, input_kwargs)
        if isinstance(node, MultiOutputNode):
            return [self._exec(a, input_args, input_kwargs)
                    for a in node._bound_args]
        from ray_tpu_torch._private import serialization as ser

        rel = self._ckpt_rel(node)
        data = self.store.read_bytes(rel)
        if data is not None:
            value = ser.loads(data)
        else:
            def resolve(a):
                if isinstance(a, DAGNode):
                    return self._exec(a, input_args, input_kwargs)
                return a

            args = [resolve(a) for a in node._bound_args]
            kwargs = {k: resolve(v) for k, v in node._bound_kwargs.items()}
            if isinstance(node, FunctionNode):
                ref = node._remote_fn.remote(*args, **kwargs)
            else:
                method = getattr(node._actor, node._method_name)
                ref = method.remote(*args, **kwargs)
            value = ray_tpu_torch.get(ref)
            # COMMIT the raw step result now — even (especially) when it
            # is a Continuation: the dynamic sub-DAG it names is then
            # durable, and a crash inside the continuation resumes from
            # the sub-steps' own checkpoints instead of re-running this
            # step (reference: workflow_executor.py persists the
            # continuation DAG before descending)
            self.store.write_bytes(rel, ser.dumps(value))
        # dynamic workflow: run the continuation chain, each level's steps
        # checkpointing under this step's key prefix
        depth = 0
        while isinstance(value, Continuation):
            sub = _DurableExecutor(
                self.workflow_id, value.dag,
                prefix=f"{self.keys[id(node)]}.c{depth}.")
            value = sub.run_inner(input_args, input_kwargs)
            depth += 1
        return value


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        args: tuple = (), kwargs: Optional[Dict] = None) -> Any:
    """Execute durably; every completed step is checkpointed."""
    init()
    workflow_id = workflow_id or f"workflow_{int(time.time() * 1000)}"
    return _DurableExecutor(workflow_id, dag).run(
        *args, **(kwargs or {}))


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              args: tuple = (), kwargs: Optional[Dict] = None):
    """Non-blocking run (reference: workflow/api.py:177 run_async) —
    returns a concurrent.futures.Future of the workflow result."""
    from concurrent.futures import ThreadPoolExecutor

    init()
    workflow_id = workflow_id or f"workflow_{int(time.time() * 1000)}"
    pool = ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix=f"wf-{workflow_id}")
    fut = pool.submit(
        lambda: _DurableExecutor(workflow_id, dag).run(
            *args, **(kwargs or {})))
    fut.add_done_callback(lambda _: pool.shutdown(wait=False))
    fut.workflow_id = workflow_id
    return fut


# ------------------------------------------------------------------ events
class EventListener:
    """Event source ABC (reference: workflow/event_system —
    EventListener.poll_for_event). ``poll_for_event`` blocks until the
    event arrives and returns its payload."""

    def poll_for_event(self) -> Any:
        raise NotImplementedError


class TimerListener(EventListener):
    """Fires after ``seconds`` (reference: the timer event example)."""

    def __init__(self, seconds: float):
        self.seconds = seconds

    def poll_for_event(self) -> float:
        time.sleep(self.seconds)
        return time.time()


class FileEventListener(EventListener):
    """Fires when ``path`` exists; payload is its contents (a minimal
    external-event provider usable across processes)."""

    def __init__(self, path: str, poll_interval: float = 0.1):
        self.path = path
        self.poll_interval = poll_interval

    def poll_for_event(self) -> bytes:
        while not os.path.exists(self.path):
            time.sleep(self.poll_interval)
        with open(self.path, "rb") as f:
            return f.read()


class HTTPEventProvider(EventListener):
    """Durable HTTP event delivery (reference:
    python/ray/workflow/http_event_provider.py — an HTTP endpoint
    receives ``POST /event/<key>`` and the payload is COMMITTED to
    workflow storage before the sender gets 200, so a delivered event
    survives a crash before the workflow consumes it).

    ``poll_for_event`` first checks the durable spool (resume path), then
    serves one HTTP request. The bound endpoint is written to
    ``<storage>/_events/<key>.addr`` as ``host:port`` (and the legacy
    ``.port`` file) so external senders can discover it. The default bind
    is loopback (the endpoint is unauthenticated); multi-host deployments
    with shared storage must opt in with ``bind_host="0.0.0.0"``, which
    advertises the node's outbound IP in the ``.addr`` file.
    """

    def __init__(self, event_key: str, port: int = 0,
                 timeout_s: float = 300.0, bind_host: str = "127.0.0.1"):
        self.event_key = event_key
        self.port = port
        self.timeout_s = timeout_s
        self.bind_host = bind_host

    def _spool_rel(self) -> str:
        return f"_events/{self.event_key}.payload"

    def poll_for_event(self) -> bytes:
        init()
        store = _Store(_storage_root)
        spooled = store.read_bytes(self._spool_rel())
        if spooled is not None:  # durably delivered earlier (resume path)
            return spooled

        from http.server import BaseHTTPRequestHandler, HTTPServer

        received: List[bytes] = []
        key = self.event_key

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/").split("/")[-1] != key:
                    self.send_response(404)
                    self.end_headers()
                    return
                n = int(self.headers.get("Content-Length", 0))
                payload = self.rfile.read(n)
                # COMMIT before acking: that is the durability contract
                store.write_bytes(f"_events/{key}.payload", payload)
                received.append(payload)
                self.send_response(200)
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *a):  # quiet
                pass

        server = HTTPServer((self.bind_host, self.port), Handler)
        server.timeout = 1.0
        bound_port = server.server_address[1]
        from ray_tpu_torch._private.worker import node_ip

        host = node_ip() if self.bind_host in ("0.0.0.0", "") \
            else self.bind_host
        store.write_bytes(f"_events/{key}.addr",
                          f"{host}:{bound_port}".encode())
        store.write_bytes(f"_events/{key}.port", str(bound_port).encode())
        deadline = time.monotonic() + self.timeout_s
        try:
            while not received and time.monotonic() < deadline:
                server.handle_request()
        finally:
            server.server_close()
        if not received:
            raise TimeoutError(
                f"no event delivered for key {key!r} "
                f"within {self.timeout_s}s")
        return received[0]


def wait_for_event(listener_cls, *args, **kwargs) -> DAGNode:
    """A DAG step that completes when the listener's event arrives
    (reference: workflow.wait_for_event). Like any step, the received
    payload is checkpointed — a resumed workflow does NOT wait again."""
    import ray_tpu_torch

    # the step executes in a WORKER process whose workflow module starts
    # at the default storage root; carry the driver's configured root so
    # storage-backed listeners (HTTPEventProvider spool/port files) land
    # where the driver and external senders look
    configured_root = _storage_root

    @ray_tpu_torch.remote
    def __wait_for_event__():
        from ray_tpu_torch import workflow as _wf

        _wf.init(configured_root)
        return listener_cls(*args, **kwargs).poll_for_event()

    return __wait_for_event__.bind()


def resume(workflow_id: str, dag: DAGNode, *, args: tuple = (),
           kwargs: Optional[Dict] = None) -> Any:
    """Re-run a workflow; completed steps are served from checkpoints.

    (The reference serializes the DAG into storage so resume needs no code;
    here the caller re-supplies the graph and storage supplies the state.)
    """
    init()
    store = _Store(_storage_root)
    if not (store.exists(f"{workflow_id}/status.json")
            or store.listdir(workflow_id)):
        raise ValueError(f"no workflow {workflow_id!r}")
    return _DurableExecutor(workflow_id, dag).run(*args, **(kwargs or {}))


def get_status(workflow_id: str) -> Optional[str]:
    data = _Store(_storage_root).read_bytes(f"{workflow_id}/status.json")
    if data is None:
        return None
    return json.loads(data)["status"]


def list_all() -> List[Dict]:
    init()
    out = []
    for wid in _Store(_storage_root).listdir():
        if wid.startswith("_"):
            continue
        status = get_status(wid)
        if status:
            out.append({"workflow_id": wid, "status": status})
    return out


def delete(workflow_id: str) -> None:
    _Store(_storage_root).delete(workflow_id)


# ---------------------------------------------------------- virtual actors
class VirtualActorHandle:
    """Durable actor: state lives in workflow storage, every method call
    runs as a checkpointed step (reference: workflow's virtual-actor
    durable state — methods load state, execute in a task, commit the new
    state before returning)."""

    def __init__(self, cls, actor_id: str, init_args, init_kwargs,
                 storage_root: str):
        self._cls = cls
        self._actor_id = actor_id
        self._init = (init_args, init_kwargs)
        self._root = storage_root

    def _state_rel(self) -> str:
        return f"_va/{self._actor_id}/state.pkl"

    def _load_state(self):
        from ray_tpu_torch._private import serialization as ser

        store = _Store(self._root)
        data = store.read_bytes(self._state_rel())
        if data is not None:
            return ser.loads(data)
        inst = self._cls(*self._init[0], **self._init[1])
        return inst.__dict__

    def _commit_state(self, state: dict) -> None:
        from ray_tpu_torch._private import serialization as ser

        _Store(self._root).write_bytes(self._state_rel(), ser.dumps(state))

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        method = getattr(self._cls, name)

        class _Method:
            def run(me, *args, **kwargs):
                import ray_tpu_torch

                cls, init, root = self._cls, self._init, self._root
                rel = self._state_rel()

                @ray_tpu_torch.remote
                def __virtual_actor_step__(state_dict):
                    inst = cls.__new__(cls)
                    inst.__dict__.update(state_dict)
                    result = method(inst, *args, **kwargs)
                    return result, inst.__dict__

                state = self._load_state()
                result, new_state = ray_tpu_torch.get(
                    __virtual_actor_step__.remote(state))
                # commit AFTER execution: a crash mid-step replays the
                # method against the old state (at-least-once, like
                # workflow steps before their checkpoint lands)
                self._commit_state(new_state)
                return result

            def run_async(me, *args, **kwargs):
                from concurrent.futures import ThreadPoolExecutor

                pool = ThreadPoolExecutor(max_workers=1)
                fut = pool.submit(me.run, *args, **kwargs)
                fut.add_done_callback(lambda _: pool.shutdown(wait=False))
                return fut

        return _Method()

    def state(self) -> dict:
        """Current committed state (for inspection/tests)."""
        return dict(self._load_state())


class VirtualActorClass:
    def __init__(self, cls):
        self._cls = cls

    def get_or_create(self, actor_id: str, *args, **kwargs
                      ) -> VirtualActorHandle:
        init()
        return VirtualActorHandle(self._cls, actor_id, args, kwargs,
                                  _storage_root)


def virtual_actor(cls) -> VirtualActorClass:
    """Durable-actor decorator (reference: workflow virtual actors)."""
    return VirtualActorClass(cls)
