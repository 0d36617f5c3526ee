# Copied from ray_tpu/rllib/env/__init__.py (ray_tpu -> ray_tpu_torch).
