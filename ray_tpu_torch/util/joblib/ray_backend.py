# Copied from ray_tpu/util/joblib/ray_backend.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""joblib ParallelBackend over cluster tasks (reference:
python/ray/util/joblib/ray_backend.py — batches of joblib callables run as
tasks; results come back through the object store)."""

from __future__ import annotations

from typing import Any, Callable

import ray_tpu_torch

try:
    from joblib._parallel_backends import SequentialBackend
    from joblib.parallel import ParallelBackendBase
except ImportError:  # pragma: no cover - joblib not installed
    ParallelBackendBase = object
    SequentialBackend = None


class _Result:
    def __init__(self, ref):
        self._ref = ref

    def get(self, timeout=None):
        return ray_tpu_torch.get(self._ref, timeout=timeout)


class RayBackend(ParallelBackendBase):
    """Each joblib batch (a callable returning a list) becomes one task."""

    supports_timeout = True
    uses_threads = False
    supports_sharedmem = False

    def configure(self, n_jobs: int = 1, parallel=None, **_kwargs) -> int:
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.parallel = parallel
        return self.effective_n_jobs(n_jobs)

    def effective_n_jobs(self, n_jobs: int) -> int:
        if n_jobs == 0:
            raise ValueError("n_jobs == 0 has no meaning")
        total = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        if n_jobs is None or n_jobs < 0:
            return total
        return min(n_jobs, total)  # n_jobs=1 stays sequential, as in joblib

    def apply_async(self, func: Callable, callback=None) -> Any:
        @ray_tpu_torch.remote
        def run_batch():
            return func()

        ref = run_batch.remote()
        result = _Result(ref)
        if callback is not None:
            import threading

            def wait_and_call():
                try:
                    callback(result.get())
                except BaseException:
                    pass

            threading.Thread(target=wait_and_call, daemon=True).start()
        return result

    def abort_everything(self, ensure_ready: bool = True) -> None:
        if ensure_ready:
            self.configure(n_jobs=self.parallel.n_jobs,
                           parallel=self.parallel)
