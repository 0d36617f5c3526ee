"""The rounding of the control: the operands of every product rounded to
float8 e4m3, one scale per row of the left operand and per column of the
right one, the backward passing the rounding straight through. Without a
quantization, the products are plain float32."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``, in
    x's type; the gradient passes through unchanged."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


class Rounding:
    def __init__(self, quant: Optional[str]):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.on = quant is not None

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., in] @ w [in, out]."""
        if self.on:
            x, w = fp8(x, -1), fp8(w, 0)
        return x @ w

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., m, k] @ b [..., k, n]."""
        if self.on:
            a, b = fp8(a, -1), fp8(b, -2)
        return a @ b


@contextlib.contextmanager
def exact_float32():
    """TF32 off for float32 products inside, as a float32 reference needs
    on this card; the settings are restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
