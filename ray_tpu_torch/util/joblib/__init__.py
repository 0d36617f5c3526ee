# Copied from ray_tpu/util/joblib/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""joblib backend (reference: python/ray/util/joblib/ — registers a
``ray`` parallel backend so ``joblib.Parallel(backend="ray")`` — and thus
scikit-learn's n_jobs machinery — fans out over the cluster).

Usage:
    from ray_tpu_torch.util.joblib import register_ray
    register_ray()
    with joblib.parallel_backend("ray"):
        Parallel(n_jobs=8)(delayed(f)(i) for i in range(100))
"""

from __future__ import annotations


def register_ray() -> None:
    """Register the 'ray' joblib backend (no-op if joblib is absent)."""
    try:
        from joblib.parallel import register_parallel_backend
    except ImportError as e:
        raise ImportError(
            "joblib is required for the ray joblib backend") from e
    from ray_tpu_torch.util.joblib.ray_backend import RayBackend

    register_parallel_backend("ray", RayBackend)


__all__ = ["register_ray"]
