"""ray_tpu_torch.models — PyTorch ports of ``ray_tpu.models``."""

from ray_tpu_torch.models.llama import (
    LlamaConfig, LoraConfig, init_llama, init_lora, llama_decode,
    llama_forward, llama_hidden, llama_logical_axes, llama_lora_loss,
    llama_loss, lora_from_jax, lora_logical_axes, merge_lora,
    params_from_jax)
from ray_tpu_torch.models.mlp import (
    MLPConfig, init_mlp, mlp_forward, mlp_logical_axes, mlp_loss,
    mlp_params_from_jax)
from ray_tpu_torch.models.moe import (
    MoEConfig, init_moe, moe_forward, moe_logical_axes, moe_loss,
    moe_params_from_jax)

__all__ = ["LlamaConfig", "LoraConfig", "MLPConfig", "MoEConfig",
           "init_llama", "init_lora", "init_mlp", "init_moe", "llama_decode",
           "llama_forward", "llama_hidden", "llama_logical_axes",
           "llama_lora_loss", "llama_loss", "lora_from_jax",
           "lora_logical_axes", "merge_lora", "mlp_forward",
           "mlp_logical_axes", "mlp_loss",
           "mlp_params_from_jax", "moe_forward", "moe_logical_axes", "moe_loss",
           "moe_params_from_jax", "params_from_jax"]
