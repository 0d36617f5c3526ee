# Copied from ray_tpu/dashboard/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Dashboard-lite (reference: dashboard/ — DashboardHead head.py:81 aiohttp
REST + per-node agents; the React client is out of scope, the REST surface
is here).

One actor serves JSON state endpoints + Prometheus metrics over the same
hand-rolled asyncio HTTP server style as the Serve proxy:

- ``GET /api/nodes|actors|tasks|placement_groups|jobs``
- ``GET /api/cluster_status`` — resource totals/availability
- ``GET /api/jobs/<id>/logs``
- ``GET /metrics`` — Prometheus text (reference: metrics agent)
- ``GET /healthz``

The routes are the reference's but one: its ``/api/jax_trace`` is
``/api/torch_trace`` here, over ``util.state.capture_torch_trace``.
"""

from __future__ import annotations

import asyncio
import json
import urllib.parse
from typing import Optional, Tuple

import ray_tpu_torch

DASHBOARD_NAME = "RAY_TPU_TORCH_DASHBOARD"


class _BadRequest(Exception):
    """Client-input error on an API route -> HTTP 400."""


class DashboardActor:
    def __init__(self, port: int = 8265, host: str = "127.0.0.1"):
        self.port = port
        self.host = host
        self._server = None

    async def ready(self) -> int:
        if self._server is None:
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _handle_conn(self, reader, writer):
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                method, target, _ = line.decode("latin1").strip().split(" ", 2)
            except ValueError:
                return
            content_length = 0
            while True:
                h = await reader.readline()
                if not h or h in (b"\r\n", b"\n"):
                    break
                name, _, value = h.decode("latin1").partition(":")
                if name.strip().lower() == "content-length":
                    try:
                        content_length = int(value.strip())
                    except ValueError:
                        pass
            body = (await reader.readexactly(content_length)
                    if content_length else b"")
            status, payload, ctype = await self._dispatch(
                method, target, body)
            writer.write(
                f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n".encode("latin1"))
            writer.write(payload)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, method: str, target: str,
                        body: bytes = b"") -> Tuple[str, bytes, str]:
        split = urllib.parse.urlsplit(target)
        path = split.path
        query = dict(urllib.parse.parse_qsl(split.query))
        try:
            if path in ("/", "/index.html"):
                from ray_tpu_torch.dashboard.web import INDEX_HTML

                return ("200 OK", INDEX_HTML.encode(),
                        "text/html; charset=utf-8")
            if path == "/healthz":
                return "200 OK", b"success", "text/plain"
            if path == "/grafana/dashboards":
                from ray_tpu_torch.dashboard.grafana import (
                    generate_core_dashboard, generate_gpu_dashboard)

                return ("200 OK", json.dumps({
                    "dashboards": [generate_core_dashboard(),
                                   generate_gpu_dashboard()]}).encode(),
                    "application/json")
            if path == "/metrics":
                from ray_tpu_torch.util.metrics import prometheus_text

                text = await asyncio.to_thread(prometheus_text)
                return "200 OK", text.encode(), "text/plain"
            if path == "/api/serve/applications" and method == "PUT":
                # declarative deploy (reference: dashboard serve REST
                # PUT /api/serve/applications/ consuming ServeDeploySchema)
                config = json.loads(body or b"{}")
                await asyncio.to_thread(self._serve_deploy, config)
                return "200 OK", b"{}", "application/json"
            if path.startswith("/api/"):
                try:
                    data = await asyncio.to_thread(self._api, path, query)
                except _BadRequest as e:
                    return ("400 Bad Request",
                            json.dumps({"error": str(e)}).encode(),
                            "application/json")
                if data is None:
                    return ("404 Not Found", b'{"error": "not found"}',
                            "application/json")
                return ("200 OK", json.dumps(data, default=str).encode(),
                        "application/json")
            return "404 Not Found", b'{"error": "no route"}', \
                "application/json"
        except Exception as e:
            return ("500 Internal Server Error",
                    json.dumps({"error": repr(e)}).encode(),
                    "application/json")

    def _serve_deploy(self, config: dict) -> None:
        from ray_tpu_torch import serve

        serve.run_config(config, _blocking=False)

    def _serve_status(self):
        from ray_tpu_torch import serve

        try:
            ctrl = serve._controller()
            routes = ray_tpu_torch.get(ctrl.get_routes.remote(), timeout=10)
        except Exception:
            return {"applications": {}, "proxies": {}}
        try:
            # per-node ingress map (reference: serve status proxies
            # section fed by ProxyStateManager)
            proxies = ray_tpu_torch.get(ctrl.get_proxy_info.remote(), timeout=10)
        except Exception:
            proxies = {}
        return {"applications": {
            app: {**serve.status(app), "route_prefix": prefix,
                  "ingress": ingress}
            for prefix, (app, ingress) in routes.items()},
            "proxies": proxies}

    def _api(self, path: str, query=None):
        from ray_tpu_torch.util import state as state_api

        query = query or {}
        parts = [p for p in path.split("/") if p][1:]  # drop "api"
        if parts[0] == "serve" and len(parts) > 1 \
                and parts[1] == "applications":
            return self._serve_status()
        if parts[0] == "data_stats":
            # per-dataset per-operator execution stats published by
            # drivers (Dataset._publish_stats; reference: the dashboard's
            # Ray Data tab fed by _internal/stats.py)
            import json as _json

            from ray_tpu_torch.experimental.internal_kv import (
                _internal_kv_get, _internal_kv_list)

            out = []
            for key in sorted(_internal_kv_list(b"__data_stats__:"))[-50:]:
                val = _internal_kv_get(key)
                if val:
                    out.append({"dataset": key.decode().split(":", 1)[1],
                                **_json.loads(val)})
            return out
        if parts[0] == "nodes":
            return state_api.list_nodes()
        if parts[0] == "node_stats":
            return state_api.get_node_stats()
        if parts[0] == "events":
            return state_api.list_cluster_events(
                severity=query.get("severity"), label=query.get("label"))
        if parts[0] == "workers":
            return state_api.list_workers()
        if parts[0] == "objects":
            return state_api.list_objects()
        if parts[0] in ("profile", "torch_trace"):
            try:
                worker_id = query["worker_id"]
                duration = float(query.get("duration_s", 2.0))
            except (KeyError, ValueError) as e:
                raise _BadRequest(
                    "profile endpoints need ?worker_id=<id>"
                    "[&duration_s=<seconds>]") from e
            fn = (state_api.profile_worker if parts[0] == "profile"
                  else state_api.capture_torch_trace)
            return fn(worker_id, duration)
        if parts[0] == "actors":
            return state_api.list_actors()
        if parts[0] == "tasks":
            return state_api.list_tasks()
        if parts[0] == "placement_groups":
            return state_api.list_placement_groups()
        if parts[0] == "cluster_status":
            return {"total": ray_tpu_torch.cluster_resources(),
                    "available": ray_tpu_torch.available_resources()}
        if parts[0] == "jobs":
            from ray_tpu_torch.job_submission import JobSubmissionClient

            client = JobSubmissionClient()
            if len(parts) == 1:
                return client.list_jobs()
            if len(parts) == 3 and parts[2] == "logs":
                return {"logs": client.get_job_logs(parts[1])}
            return client.get_job_info(parts[1])
        return None


def start_dashboard(port: int = 0, host: str = "127.0.0.1") -> int:
    """Start (or get) the dashboard actor; returns its bound port."""
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_NAME, namespace="_dashboard")
    except Exception:
        actor = ray_tpu_torch.remote(DashboardActor).options(
            name=DASHBOARD_NAME, namespace="_dashboard",
            max_concurrency=16, num_cpus=0.1).remote(port=port, host=host)
    return ray_tpu_torch.get(actor.ready.remote(), timeout=60)
