# Copied from ray_tpu/util/accelerators/tpu.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""TPU pod-slice scheduling helpers (reference: the slice-head fan-out
pattern documented at _private/accelerators/tpu.py:356-369 — schedule one
task on the ``TPU-{pod_type}-head`` resource, then one per host on the
``{slice_name}`` resource)."""

from __future__ import annotations

from typing import List, Optional


def pod_slice_head_resource(pod_type: str) -> str:
    """Custom resource advertised only on worker 0 of a slice."""
    return f"TPU-{pod_type}-head"


def pod_slice_resource(slice_name: str) -> str:
    """Custom resource advertised on every host of a slice."""
    return slice_name


def slice_hosts(pod_type: str) -> Optional[int]:
    """Host count of a slice type, e.g. 'v5e-64' with 4 chips/host -> 16."""
    from ray_tpu_torch._private.accelerators.tpu import TPUAcceleratorManager

    chips_per_host = TPUAcceleratorManager.chips_per_host_for_topology(
        pod_type)
    if not chips_per_host or "-" not in pod_type:
        return None
    try:
        total = int(pod_type.rsplit("-", 1)[1])
    except ValueError:
        return None
    return max(1, total // chips_per_host)


def reserve_tpu_slice(pod_type: str, timeout_s: float = 300.0) -> List:
    """The multi-host SPMD launch pattern: run a probe task on the slice
    head to learn the slice name, then return one remote-options dict per
    host so the caller can fan one worker task out to every host:

        opts = reserve_tpu_slice("v5e-64")
        refs = [train_task.options(**o).remote(...) for o in opts]
    """
    import ray_tpu_torch

    head_res = pod_slice_head_resource(pod_type)

    @ray_tpu_torch.remote(resources={head_res: 1})
    def probe_slice():
        import os

        from ray_tpu_torch._private.accelerators.tpu import ENV_SLICE_NAME

        return os.environ.get(ENV_SLICE_NAME, "")

    ref = probe_slice.remote()
    try:
        slice_name = ray_tpu_torch.get(ref, timeout=timeout_s)
    except Exception:
        try:  # don't leave an infeasible probe queued forever
            ray_tpu_torch.cancel(ref, force=True)
        except Exception:
            pass
        raise
    if not slice_name:
        raise RuntimeError(
            f"slice head for {pod_type} reachable but {pod_type} slice "
            "name is not set (TPU_NAME)")
    hosts = slice_hosts(pod_type) or 1
    return [{"resources": {pod_slice_resource(slice_name): 1}}
            for _ in range(hosts)]
