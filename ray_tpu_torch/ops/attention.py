"""Attention dispatcher: plain reference path and the CUDA flash kernel.

Port of ``ray_tpu/ops/attention.py``. GQA layout everywhere: q [B, S, H, D],
k/v [B, S_kv, KVH, D] with H % KVH == 0. Returns [B, S, H, D] in q.dtype.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    B, S, KVH, D = k.shape
    return k[:, :, :, None, :].expand(B, S, KVH, n_rep, D).reshape(
        B, S, KVH * n_rep, D)


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, causal: bool = True,
    q_offset: Optional[Union[int, torch.Tensor]] = None,
    valid_kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain einsum attention with fp32 softmax. ``q_offset`` positions the
    query block inside a longer kv sequence (decode with kv cache);
    ``valid_kv_len`` [B] masks each row's kv positions at and past it."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // KVH)
    v = _repeat_kv(v, H // KVH)
    scale = D ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    kv_pos = torch.arange(Skv, device=q.device)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        if q_offset is not None:
            q_pos = q_pos + q_offset
        mask = q_pos[:, None] >= kv_pos[None, :]
        logits = logits.masked_fill(~mask[None, None], _NEG_INF)
    if valid_kv_len is not None:
        vmask = kv_pos[None, :] < valid_kv_len[:, None]  # [B, Skv]
        logits = logits.masked_fill(~vmask[:, None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, impl: str = "auto", causal: bool = True,
    q_offset: Optional[Union[int, torch.Tensor]] = None,
    valid_kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """impl: auto (the flash kernel for CUDA tensors when shapes allow, else
    reference), flash, reference. ``blockwise`` is not ported yet."""
    if impl == "auto":
        use_flash = (
            q.device.type == "cuda" and q_offset is None
            and valid_kv_len is None
            and q.shape[1] == k.shape[1]
            and q.shape[1] % 128 == 0 and q.shape[3] % 128 == 0
        )
        impl = "flash" if use_flash else "reference"
    if impl == "flash":
        from ray_tpu_torch.ops.cuda.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    if impl == "blockwise":
        raise NotImplementedError(
            "blockwise attention is not ported to ray_tpu_torch yet; use "
            "impl='flash' or impl='reference'")
    if impl != "reference":
        raise ValueError(
            f"unknown attention impl {impl!r}; expected "
            "auto|flash|reference")
    return reference_attention(q, k, v, causal=causal, q_offset=q_offset,
                               valid_kv_len=valid_kv_len)
