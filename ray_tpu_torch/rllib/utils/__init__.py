# Copied from ray_tpu/rllib/utils/__init__.py (ray_tpu -> ray_tpu_torch).
