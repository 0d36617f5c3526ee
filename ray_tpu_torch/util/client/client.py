# Copied from ray_tpu/util/client/client.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Client-mode driver stub (reference: python/ray/util/client/worker.py —
the Worker that proxies the ray API over the connection, and
client_builder.py for ``ray.init("ray://...")``)."""

from __future__ import annotations

import asyncio
import threading
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.config import CONFIG


# Deadline for client data-plane RPCs (put/get/task/actor submissions):
# one bound to retune, mirrored by _Channel.call's default. Gets/waits
# with a user timeout get +10s slack so the server-side answer wins.
_DATA_RPC_TIMEOUT_S = 300.0


class _Channel:
    """Sync RPC facade over a private event-loop thread."""

    def __init__(self, host: str, port: int):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="ray-client", daemon=True)
        self._thread.start()
        from ray_tpu_torch._private.protocol import AsyncRpcClient

        self.client = AsyncRpcClient()
        fut = asyncio.run_coroutine_threadsafe(
            self.client.connect_tcp(host, port), self._loop)
        fut.result(30)

    def call(self, method: str, payload: Dict,
             timeout: float = _DATA_RPC_TIMEOUT_S):
        fut = asyncio.run_coroutine_threadsafe(
            self.client.call(method, payload), self._loop)
        return fut.result(timeout)

    def close(self) -> None:
        # aclose ON the private loop BEFORE stopping it: stopping first
        # strands the client's cancelled read-loop task, which the dying
        # loop reports as "Task was destroyed but it is pending!" at
        # interpreter teardown (the BENCH tail-leak shape)
        try:
            asyncio.run_coroutine_threadsafe(
                self.client.aclose(), self._loop).result(5)
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)


class ClientObjectRef:
    """Names a ref held by the server on this client's behalf."""

    def __init__(self, ctx: "ClientContext", hex_id: str):
        self._ctx = ctx
        self._hex = hex_id
        weakref.finalize(self, ctx._release_later, hex_id)

    def hex(self) -> str:
        return self._hex

    def __repr__(self) -> str:
        return f"ClientObjectRef({self._hex})"


class ClientActorMethod:
    def __init__(self, ctx: "ClientContext", actor_id: str, name: str,
                 opts: Optional[Dict] = None):
        self._ctx = ctx
        self._actor_id = actor_id
        self._name = name
        self._opts = opts

    def options(self, **opts) -> "ClientActorMethod":
        return ClientActorMethod(self._ctx, self._actor_id, self._name, opts)

    def remote(self, *args, **kwargs):
        return self._ctx._actor_call(self._actor_id, self._name, args,
                                     kwargs, self._opts)


class ClientActorHandle:
    def __init__(self, ctx: "ClientContext", actor_id: str):
        self._ctx = ctx
        self._actor_id = actor_id

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self._ctx, self._actor_id, name)


class ClientRemoteFunction:
    def __init__(self, ctx: "ClientContext", fn, opts: Optional[Dict] = None):
        self._ctx = ctx
        self._fn = fn
        self._opts = opts or {}

    def options(self, **opts) -> "ClientRemoteFunction":
        return ClientRemoteFunction(self._ctx, self._fn,
                                    {**self._opts, **opts})

    def remote(self, *args, **kwargs):
        return self._ctx._task(self._fn, args, kwargs, self._opts)


class ClientActorClass:
    def __init__(self, ctx: "ClientContext", cls, opts: Optional[Dict] = None):
        self._ctx = ctx
        self._cls = cls
        self._opts = opts or {}

    def options(self, **opts) -> "ClientActorClass":
        return ClientActorClass(self._ctx, self._cls, {**self._opts, **opts})

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        return self._ctx._create_actor(self._cls, args, kwargs, self._opts)


class ClientContext:
    """The ray API, proxied (returned by ``connect`` /
    ``ray_tpu_torch.init("ray://...")``)."""

    def __init__(self, host: str, port: int,
                 init_kwargs: Optional[Dict] = None):
        self._chan = _Channel(host, port)
        self._pending_release: List[str] = []
        # RLock: _release_later runs in GC context (weakref.finalize on
        # ClientObjectRef) and may fire mid-critical-section on the very
        # thread holding this lock (raylint R1, the MemoryStore class)
        self._lock = threading.RLock()
        # data-plane budget, not control_rpc_timeout_s: the server-side
        # handler runs a full ray_tpu_torch.init() cluster bring-up (GCS,
        # agents, prestart workers), not an immediate answer
        self._chan.call("ClientInit", {
            "init_kwargs": ser.dumps(init_kwargs or {})},
            timeout=_DATA_RPC_TIMEOUT_S)

    # --------------------------------------------------------------- helpers
    def _wire_args(self, args: tuple, kwargs: dict) -> Tuple[List, Dict]:
        def enc(v):
            if isinstance(v, ClientObjectRef):
                return {"ref": v.hex()}
            return {"v": ser.dumps(v)}

        return [enc(a) for a in args], {k: enc(v) for k, v in kwargs.items()}

    def _refs_from(self, reply) -> Any:
        refs = [ClientObjectRef(self, r["id"]) for r in reply["refs"]]
        return refs[0] if len(refs) == 1 else refs

    def _release_later(self, hex_id: str) -> None:
        with self._lock:
            self._pending_release.append(hex_id)

    def _flush_releases(self) -> None:
        with self._lock:
            batch, self._pending_release = self._pending_release, []
        if batch:
            try:
                self._chan.call("ClientRelease", {"ids": batch},
                                timeout=CONFIG.control_rpc_timeout_s)
            except Exception:
                pass

    # ------------------------------------------------------------------ api
    def remote(self, fn_or_cls=None, **opts):
        import inspect

        def wrap(target):
            if inspect.isclass(target):
                return ClientActorClass(self, target, opts)
            return ClientRemoteFunction(self, target, opts)

        if fn_or_cls is None:
            return wrap
        return wrap(fn_or_cls)

    def put(self, value: Any) -> ClientObjectRef:
        self._flush_releases()
        reply = self._chan.call("ClientPut", {"value": ser.dumps(value)},
                                timeout=_DATA_RPC_TIMEOUT_S)
        return self._refs_from(reply)

    def get(self, refs, timeout: Optional[float] = None):
        self._flush_releases()
        single = isinstance(refs, ClientObjectRef)
        if single:
            refs = [refs]
        reply = self._chan.call(
            "ClientGet", {"ids": [r.hex() for r in refs], "timeout": timeout},
            timeout=(timeout + 10) if timeout else _DATA_RPC_TIMEOUT_S)
        if reply.get("error"):
            raise ser.loads(bytes(reply["error"]))
        values = [ser.loads(bytes(v)) for v in reply["values"]]
        return values[0] if single else values

    def wait(self, refs, num_returns: int = 1,
             timeout: Optional[float] = None):
        reply = self._chan.call("ClientWait", {
            "ids": [r.hex() for r in refs], "num_returns": num_returns,
            "timeout": timeout},
            timeout=(timeout + 10) if timeout else _DATA_RPC_TIMEOUT_S)
        by_hex = {r.hex(): r for r in refs}
        return ([by_hex[h] for h in reply["ready"]],
                [by_hex[h] for h in reply["not_ready"]])

    def _task(self, fn, args, kwargs, opts):
        self._flush_releases()
        wa, wk = self._wire_args(args, kwargs)
        reply = self._chan.call("ClientTask", {
            "fn": ser.dumps(fn), "args": wa, "kwargs": wk,
            "opts": ser.dumps(opts) if opts else None},
            timeout=_DATA_RPC_TIMEOUT_S)
        return self._refs_from(reply)

    def _create_actor(self, cls, args, kwargs, opts) -> ClientActorHandle:
        wa, wk = self._wire_args(args, kwargs)
        reply = self._chan.call("ClientCreateActor", {
            "cls": ser.dumps(cls), "args": wa, "kwargs": wk,
            "opts": ser.dumps(opts) if opts else None},
            timeout=_DATA_RPC_TIMEOUT_S)
        return ClientActorHandle(self, reply["actor_id"])

    def _actor_call(self, actor_id, method, args, kwargs, opts):
        wa, wk = self._wire_args(args, kwargs)
        reply = self._chan.call("ClientActorCall", {
            "actor_id": actor_id, "method": method, "args": wa, "kwargs": wk,
            "opts": ser.dumps(opts) if opts else None},
            timeout=_DATA_RPC_TIMEOUT_S)
        return self._refs_from(reply)

    def get_actor(self, name: str,
                  namespace: Optional[str] = None) -> ClientActorHandle:
        reply = self._chan.call("ClientGetNamedActor",
                                {"name": name, "namespace": namespace},
                                timeout=CONFIG.control_rpc_timeout_s)
        return ClientActorHandle(self, reply["actor_id"])

    def kill(self, actor: ClientActorHandle, no_restart: bool = True) -> None:
        self._chan.call("ClientKill", {"actor_id": actor._actor_id,
                                       "no_restart": no_restart},
                        timeout=CONFIG.control_rpc_timeout_s)

    def cancel(self, ref: ClientObjectRef, force: bool = False) -> None:
        self._chan.call("ClientCancel", {"id": ref.hex(), "force": force},
                        timeout=CONFIG.control_rpc_timeout_s)

    def nodes(self) -> List[Dict]:
        return self._chan.call("ClientClusterInfo", {},
                               timeout=CONFIG.control_rpc_timeout_s)["nodes"]

    def cluster_resources(self) -> Dict[str, float]:
        reply = self._chan.call("ClientClusterInfo", {},
                                timeout=CONFIG.control_rpc_timeout_s)
        return reply["resources"]

    def disconnect(self) -> None:
        self._chan.close()


def connect(address: str, **init_kwargs) -> ClientContext:
    """Connect to a ``ray://host:port`` client server."""
    addr = address[len("ray://"):] if address.startswith("ray://") else address
    host, _, port = addr.partition(":")
    return ClientContext(host, int(port or 10001), init_kwargs or None)
