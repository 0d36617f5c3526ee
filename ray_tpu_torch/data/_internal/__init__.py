# Copied from ray_tpu/data/_internal/__init__.py (ray_tpu -> ray_tpu_torch).
