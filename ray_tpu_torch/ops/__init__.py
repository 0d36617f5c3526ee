"""ray_tpu_torch.ops — attention and the CUDA kernels behind it (port of
``ray_tpu.ops``). Every kernel has a plain PyTorch twin that CPU tensors use
and that the card checks the kernel against."""

from ray_tpu_torch.ops.attention import attention, reference_attention

__all__ = ["attention", "reference_attention"]
