"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute path.

A package beside ``ray_tpu``: it imports ``torch`` and numpy, never ``jax``
and never a module of ``ray_tpu``; what it needs from there it keeps its own
copy of. Its first slice is Llama generation through ``LlamaGenerator``
(``ray_tpu_torch.serve.llm``), with attention in a hand-written CUDA kernel
(``ray_tpu_torch.ops.cuda.flash_attention``). Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""

from ray_tpu_torch._private.device import resolve_device

__all__ = ["resolve_device"]
