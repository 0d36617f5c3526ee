"""Blockwise (memory-efficient) attention for training.

Port of ``ray_tpu/ops/blockwise_attention.py``: an online softmax over kv
blocks, the Rabe-Staats / blockwise formulation. The reference's
``lax.scan`` over the blocks is a Python loop here, and its per-block
``jax.checkpoint`` (nothing saveable) is a non-reentrant
``torch.utils.checkpoint`` of each block, so neither pass keeps an [S, S]
score matrix: each block's scores are recomputed in the backward. As in the
reference, the fp32 carry (o, m, l) is kept per block for the backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.attention import _NEG_INF, _repeat_kv

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _block_step(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                o_acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                q_pos0: int, k_pos0: int, scale: float, causal: bool,
                block_k: int) -> Carry:
    """Online-softmax update for one kv block.

    q [B,S,H,D]; k_blk/v_blk [B,Bk,H,D] (kv heads repeated); carry o_acc
    fp32 [B,S,H,D], m and l fp32 [B,H,S] → the new carry."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk).float() * scale
    if causal:
        q_pos = q_pos0 + torch.arange(q.shape[1], device=q.device)
        k_pos = k_pos0 + torch.arange(block_k, device=q.device)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = s.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard rows masked so far (m_new == -inf): p and the correction are 0
    safe = m_new > _NEG_INF / 2
    p = torch.exp(s - torch.where(safe, m_new, 0.0)[..., None])
    if causal:
        p = p.masked_fill(~mask, 0.0)
    correction = torch.where(safe, torch.exp(m - m_new), 0.0)
    l_new = l * correction + p.sum(dim=-1)
    o_blk = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk)
    o_new = (o_acc * correction.transpose(1, 2)[..., None]
             + o_blk.float())
    return o_new, m_new, l_new


def blockwise_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True, block_k: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,S,KVH,D] → [B,S,H,D] in q's type; O(S * block_k)
    memory for the scores. ``block_k`` falls back to the largest power of
    two up to 256 that divides S when it does not."""
    B, S, H, D = q.shape
    n_rep = H // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else D ** -0.5
    block_k = min(block_k, S)
    if S % block_k:
        block_k = next(b for b in (256, 128, 64, 32, 16, 8, 4, 2, 1)
                       if S % b == 0)
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    for k0 in range(0, S, block_k):
        args = (q, k[:, k0:k0 + block_k], v[:, k0:k0 + block_k], o, m, l,
                0, k0, scale, causal, block_k)
        if torch.is_grad_enabled():
            # recompute the block's scores in the backward
            o, m, l = checkpoint(_block_step, *args, use_reentrant=False)
        else:
            o, m, l = _block_step(*args)
    l = torch.clamp_min(l, 1e-20)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)
