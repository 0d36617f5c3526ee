"""The pieces the plain references share, in float32: RMSNorm, rotary
embedding on the pairs (d, d + D/2), and causal grouped-query attention,
over any leading dims ([..., S, H, D])."""

from __future__ import annotations

from typing import Optional

import torch

from benchmarks.reference.rounding import Rounding


def rms(x: torch.Tensor, eps: float,
        w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps)``, times ``w`` where given."""
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return y if w is None else y * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, H, D] at positions 0..S-1, frequencies
    ``theta ** (-2i / D)``."""
    S, D = x.shape[-3], x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(r: Rounding, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention scaled by ``D ** -0.5``: q [..., S, H, D],
    k and v [..., S, KVH, D], each kv head shared by H / KVH query heads."""
    S, H, D = q.shape[-3:]
    rep = H // k.shape[-2]
    k = k.repeat_interleave(rep, dim=-2)
    v = v.repeat_interleave(rep, dim=-2)
    qh, kh, vh = (t.transpose(-3, -2) for t in (q, k, v))  # [..., H, S, D]
    s = r.bmm(qh, kh.transpose(-1, -2)) * D ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return r.bmm(p, vh).transpose(-3, -2)
