"""Device resolution for the port's entry points.

``None`` means the CUDA card. A CUDA device on a machine without one raises:
an entry point never falls back to the CPU quietly, the caller asks for it
with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``None`` → ``cuda``. Raises if
    that is a CUDA device and CUDA is unavailable. On CUDA it also turns
    TF32 off for float32 matrix products and convolutions, so that float32
    means float32 on the card as it does on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested (the default) but CUDA is not "
                "available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
