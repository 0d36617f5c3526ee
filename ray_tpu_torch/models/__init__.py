"""ray_tpu_torch.models — PyTorch ports of ``ray_tpu.models``."""

from ray_tpu_torch.models.llama import (
    LlamaConfig, LoraConfig, init_llama, init_lora, llama_forward,
    llama_hidden, lora_from_jax, params_from_jax)

__all__ = ["LlamaConfig", "LoraConfig", "init_llama", "init_lora",
           "llama_forward", "llama_hidden", "lora_from_jax",
           "params_from_jax"]
