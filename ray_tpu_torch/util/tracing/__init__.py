# Copied from ray_tpu/util/tracing/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
from ray_tpu_torch.util.tracing.tracing_helper import (
    get_tracer,
    span,
    trace_enabled,
)

__all__ = ["get_tracer", "span", "trace_enabled"]
