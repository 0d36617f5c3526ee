"""ray_tpu_torch — the PyTorch/CUDA port of ray_tpu's compute path.

A package beside ``ray_tpu``: it imports ``torch`` and numpy, never ``jax``
and never a module of ``ray_tpu``; what it needs from there it keeps its own
copy of. Its slices so far: Llama generation through ``LlamaGenerator``
(``ray_tpu_torch.serve.llm``), and the Llama train step, LoRA or dense
(``ray_tpu_torch.parallel.train_step`` with ``models.llama.llama_loss``),
with attention, forward and backward, in hand-written CUDA kernels
(``ray_tpu_torch.ops.cuda.flash_attention``), trained with ``adamw`` or
``adafactor``; beside them kv-cache decode, ``merge_lora``, blockwise
attention and the MLP family. Entry points run on the CUDA
card unless the caller passes ``device="cpu"``.
"""

from ray_tpu_torch._private.device import resolve_device

__all__ = ["resolve_device"]
