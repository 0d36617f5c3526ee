# Copied from ray_tpu/util/multiprocessing/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""``multiprocessing.Pool`` shim over cluster tasks (reference:
python/ray/util/multiprocessing/pool.py — Pool on actors so existing
Pool-based code scales past one machine unchanged)."""

from ray_tpu_torch.util.multiprocessing.pool import Pool

__all__ = ["Pool"]
