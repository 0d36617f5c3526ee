# Copied from ray_tpu/experimental/dynamic_resources.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Dynamic custom resources (reference: python/ray/experimental/
dynamic_resources.py set_resource — adjust a node's custom resource
capacity at runtime; used for quota-style admission control).

The agent owns the node's resource totals; this asks it to re-declare one,
which then gossips to the head and into scheduling decisions.
"""

from __future__ import annotations

from typing import Optional

import ray_tpu_torch


def set_resource(resource_name: str, capacity: float,
                 node_id: Optional[str] = None) -> None:
    """Set a custom resource's total on a node (default: the local node).
    Capacity 0 deletes the resource."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod.global_worker
    if w is None or not w.connected:
        raise RuntimeError("ray_tpu_torch.init() first")
    if resource_name in ("CPU", "GPU", "TPU", "memory"):
        raise ValueError(
            f"{resource_name} is a built-in resource; only custom "
            "resources can be set dynamically (reference restriction)")
    payload = {"resource": resource_name, "capacity": float(capacity)}
    if node_id is None or node_id == w.node_id:
        w._acall(w.agent.call("SetResource", payload), timeout=30)
        return
    # route to the target node's agent through the head's cluster view
    view = w._acall(w.head.call("GetClusterView", {}), timeout=30)
    info = view.get(node_id)
    if info is None:
        raise ValueError(f"no alive node {node_id!r}")
    from ray_tpu_torch._private.config import CONFIG
    from ray_tpu_torch._private.protocol import AsyncRpcClient

    async def call_remote():
        client = AsyncRpcClient()
        await client.connect_tcp(info["addr"]["host"], info["addr"]["port"])
        try:
            return await client.call("SetResource", payload,
                                      timeout=CONFIG.control_rpc_timeout_s)
        finally:
            # aclose, not close: close() leaves the cancelled read loop
            # un-awaited and the loop warns about it at teardown
            await client.aclose()

    w._acall(call_remote(), timeout=30)
