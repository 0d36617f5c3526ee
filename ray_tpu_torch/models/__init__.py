"""ray_tpu_torch.models — PyTorch ports of ``ray_tpu.models``."""

from ray_tpu_torch.models.llama import (
    LlamaConfig, LoraConfig, init_llama, init_lora, llama_decode,
    llama_forward, llama_hidden, llama_lora_loss, llama_loss, lora_from_jax,
    merge_lora, params_from_jax)
from ray_tpu_torch.models.mlp import (
    MLPConfig, init_mlp, mlp_forward, mlp_loss, mlp_params_from_jax)

__all__ = ["LlamaConfig", "LoraConfig", "MLPConfig", "init_llama",
           "init_lora", "init_mlp", "llama_decode", "llama_forward",
           "llama_hidden", "llama_lora_loss", "llama_loss", "lora_from_jax",
           "merge_lora", "mlp_forward", "mlp_loss", "mlp_params_from_jax",
           "params_from_jax"]
