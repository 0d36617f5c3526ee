# Copied from ray_tpu/util/client/server.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Client-mode server: a real driver wrapped in an RPC facade
(reference: python/ray/util/client/server/server.py RayletServicer —
Terminate/GetObject/PutObject/Schedule RPCs over ray_client.proto)."""

from __future__ import annotations

import asyncio
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import serialization as ser
from ray_tpu_torch._private.async_util import hold_task
from ray_tpu_torch._private.protocol import Connection, RpcServer


class ClientServer:
    """Runs inside (or next to) a real driver process; each client
    connection owns a namespace of refs/actors released on disconnect."""

    def __init__(self, host: str = "0.0.0.0", port: int = 10001):
        self.host = host
        self.port = port
        self.server = RpcServer("client-server")
        # per-connection state: id(conn) -> {"refs": {hex: ObjectRef},
        #                                    "actors": {hex: handle}}
        self._conns: Dict[int, Dict[str, Dict]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._register_routes()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        """Start serving on a daemon event-loop thread; returns the port."""
        ready = threading.Event()
        port_box = {}

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop

            async def boot():
                port_box["port"] = await self.server.start_tcp(
                    self.host, self.port)
                self.server.set_disconnect_handler(self._on_disconnect)
                ready.set()

            hold_task(loop.create_task(boot()), "client-server-boot")
            loop.run_forever()

        self._thread = threading.Thread(
            target=run, name="ray-client-server", daemon=True)
        self._thread.start()
        if not ready.wait(30):
            raise TimeoutError("client server failed to start")
        self.port = port_box["port"]
        return self.port

    def stop(self) -> None:
        if self._loop:
            self._loop.call_soon_threadsafe(self._loop.stop)

    # -------------------------------------------------------------- routes
    def _register_routes(self) -> None:
        r = self.server.add_handler
        r("ClientInit", self._init)
        r("ClientPut", self._put)
        r("ClientGet", self._get)
        r("ClientTask", self._task)
        r("ClientCreateActor", self._create_actor)
        r("ClientActorCall", self._actor_call)
        r("ClientGetNamedActor", self._get_named_actor)
        r("ClientKill", self._kill)
        r("ClientCancel", self._cancel)
        r("ClientRelease", self._release)
        r("ClientWait", self._wait)
        r("ClientClusterInfo", self._cluster_info)

    def _state(self, conn: Connection) -> Dict[str, Dict]:
        return self._conns.setdefault(id(conn), {"refs": {}, "actors": {}})

    async def _on_disconnect(self, conn: Connection) -> None:
        state = self._conns.pop(id(conn), None)
        if state:
            state["refs"].clear()  # drops driver-side refs -> GC

    # ------------------------------------------------------------ handlers
    async def _init(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        if not ray_tpu_torch.is_initialized():
            kwargs = ser.loads(bytes(p["init_kwargs"])) if p.get(
                "init_kwargs") else {}
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: ray_tpu_torch.init(**kwargs))
        return {"ok": True}

    def _track(self, conn: Connection, refs: List) -> List[Dict]:
        state = self._state(conn)
        out = []
        for ref in refs:
            state["refs"][ref.hex()] = ref
            out.append({"id": ref.hex()})
        return out

    async def _put(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        value = ser.loads(bytes(p["value"]))
        ref = await asyncio.get_running_loop().run_in_executor(
            None, ray_tpu_torch.put, value)
        return {"refs": self._track(conn, [ref])}

    def _resolve_ref(self, conn: Connection, hex_id: str):
        ref = self._state(conn)["refs"].get(hex_id)
        if ref is None:
            raise ValueError(f"unknown client ref {hex_id}")
        return ref

    async def _get(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        refs = [self._resolve_ref(conn, h) for h in p["ids"]]
        timeout = p.get("timeout")

        def do_get():
            return ray_tpu_torch.get(refs, timeout=timeout)

        try:
            values = await asyncio.get_running_loop().run_in_executor(
                None, do_get)
        except BaseException as e:  # noqa: BLE001 — shipped to the client
            return {"error": ser.dumps(e)}
        return {"values": [ser.dumps(v) for v in values]}

    def _materialize_args(self, conn: Connection, wire_args, wire_kwargs):
        args = [self._resolve_ref(conn, a["ref"]) if isinstance(a, dict)
                and "ref" in a else ser.loads(bytes(a["v"]))
                for a in wire_args]
        kwargs = {k: self._resolve_ref(conn, v["ref"]) if isinstance(v, dict)
                  and "ref" in v else ser.loads(bytes(v["v"]))
                  for k, v in (wire_kwargs or {}).items()}
        return args, kwargs

    async def _task(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        # runs in an executor: submission round-trips through the driver's
        # agent and must not stall other clients on this event loop
        def do_submit():
            fn = ser.loads(bytes(p["fn"]))
            opts = ser.loads(bytes(p["opts"])) if p.get("opts") else {}
            args, kwargs = self._materialize_args(conn, p["args"],
                                                  p.get("kwargs"))
            remote_fn = ray_tpu_torch.remote(fn)
            if opts:
                remote_fn = remote_fn.options(**opts)
            out = remote_fn.remote(*args, **kwargs)
            return out if opts.get("num_returns", 1) != 1 else [out]

        refs = await asyncio.get_running_loop().run_in_executor(
            None, do_submit)
        return {"refs": self._track(conn, refs)}

    async def _create_actor(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        def do_create():
            cls = ser.loads(bytes(p["cls"]))
            opts = ser.loads(bytes(p["opts"])) if p.get("opts") else {}
            args, kwargs = self._materialize_args(conn, p["args"],
                                                  p.get("kwargs"))
            actor_cls = ray_tpu_torch.remote(cls)
            if opts:
                actor_cls = actor_cls.options(**opts)
            return actor_cls.remote(*args, **kwargs)

        handle = await asyncio.get_running_loop().run_in_executor(
            None, do_create)
        hex_id = handle._actor_id.hex()
        self._state(conn)["actors"][hex_id] = handle
        return {"actor_id": hex_id}

    async def _get_named_actor(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        handle = await asyncio.get_running_loop().run_in_executor(
            None, lambda: ray_tpu_torch.get_actor(
                p["name"], namespace=p.get("namespace") or "default"))
        hex_id = handle._actor_id.hex()
        self._state(conn)["actors"][hex_id] = handle
        return {"actor_id": hex_id}

    async def _actor_call(self, conn: Connection, p: Dict) -> Dict:
        handle = self._state(conn)["actors"].get(p["actor_id"])
        if handle is None:
            raise ValueError(f"unknown client actor {p['actor_id']}")

        def do_call():
            args, kwargs = self._materialize_args(conn, p["args"],
                                                  p.get("kwargs"))
            method = getattr(handle, p["method"])
            opts = ser.loads(bytes(p["opts"])) if p.get("opts") else {}
            if opts:
                method = method.options(**opts)
            out = method.remote(*args, **kwargs)
            return out if isinstance(out, list) else [out]

        refs = await asyncio.get_running_loop().run_in_executor(None, do_call)
        return {"refs": self._track(conn, refs)}

    async def _kill(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        handle = self._state(conn)["actors"].get(p["actor_id"])
        if handle is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, lambda: ray_tpu_torch.kill(
                    handle, no_restart=p.get("no_restart", True)))
        return {"ok": handle is not None}

    async def _cancel(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        ref = self._resolve_ref(conn, p["id"])
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: ray_tpu_torch.cancel(ref, force=p.get("force", False)))
        return {"ok": True}

    async def _release(self, conn: Connection, p: Dict) -> Dict:
        state = self._state(conn)
        for h in p["ids"]:
            state["refs"].pop(h, None)
        return {"ok": True}

    async def _wait(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        refs = [self._resolve_ref(conn, h) for h in p["ids"]]

        def do_wait():
            return ray_tpu_torch.wait(refs, num_returns=p.get("num_returns", 1),
                                timeout=p.get("timeout"))

        ready, not_ready = await asyncio.get_running_loop().run_in_executor(
            None, do_wait)
        return {"ready": [r.hex() for r in ready],
                "not_ready": [r.hex() for r in not_ready]}

    async def _cluster_info(self, conn: Connection, p: Dict) -> Dict:
        import ray_tpu_torch

        return {"nodes": ray_tpu_torch.nodes(),
                "resources": ray_tpu_torch.cluster_resources()}


def serve(host: str = "0.0.0.0", port: int = 10001) -> ClientServer:
    """Start a client server next to an already-initialized driver."""
    s = ClientServer(host, port)
    s.start()
    return s
