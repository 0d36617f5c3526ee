# Copied from ray_tpu/util/accelerators/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Accelerator helper constants + TPU pod-slice utilities (reference:
python/ray/util/accelerators/__init__.py + accelerators/tpu.py helpers the
slice-head scheduling docstring points at, _private/accelerators/tpu.py
:366-367)."""

from ray_tpu_torch.util.accelerators.tpu import (
    pod_slice_head_resource,
    pod_slice_resource,
    reserve_tpu_slice,
    slice_hosts,
)

# accelerator type constants (reference: util/accelerators/accelerators.py)
NVIDIA_TESLA_V100 = "V100"
NVIDIA_TESLA_A100 = "A100"
NVIDIA_H100 = "H100"
GOOGLE_TPU_V4 = "TPU-V4"
GOOGLE_TPU_V5E = "TPU-V5E"
GOOGLE_TPU_V5P = "TPU-V5P"
GOOGLE_TPU_V6E = "TPU-V6E"

__all__ = [
    "pod_slice_head_resource", "pod_slice_resource", "reserve_tpu_slice",
    "slice_hosts",
    "NVIDIA_TESLA_V100", "NVIDIA_TESLA_A100", "NVIDIA_H100",
    "GOOGLE_TPU_V4", "GOOGLE_TPU_V5E", "GOOGLE_TPU_V5P", "GOOGLE_TPU_V6E",
]
