from ray_tpu_torch.rllib.models.catalog import (
    ConvModule, LSTMModule, get_module_for_space)

__all__ = ["ConvModule", "LSTMModule", "get_module_for_space"]
