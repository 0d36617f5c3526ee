"""Flash-attention forward: the hand-written CUDA kernel and its plain twin.

Port of ``ray_tpu/ops/pallas/flash_attention.py`` (forward only). The kernel
(``csrc/flash_attention_fwd.cu``) replaces the Pallas ``_fwd_kernel``:
online-softmax GQA attention with fp32 statistics that writes ``o`` and the
per-row logsumexp. :func:`flash_attention_fwd` launches it for CUDA tensors
and uses :func:`flash_attention_fwd_plain` only for tensors on the CPU;
there is no fallback from the kernel to the plain version.

The backward kernels (dq, and dk/dv with the GQA group sum) come with the
training slice; until then a call on tensors that require grad raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.cuda import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

# Kernel launches since import (or since a caller reset it): the wrapper adds
# one per launch and nowhere else, so a run can show that its path went
# through the kernel.
launches = 0


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Sq,D], k/v [B,KVH,Skv,D] → (o [B,H,Sq,D] in q's type,
    lse [B,H,Sq] fp32), in plain PyTorch with the kernel's numerics: fp32
    scores scaled by D**-0.5, a top-left causal mask (q_pos >= k_pos) filled
    with -1e30, and 1e-30 guards on the row sum."""
    H, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    n_rep = H // k.shape[1]
    Skv = k.shape[2]
    kf = k.float().repeat_interleave(n_rep, dim=1)
    vf = v.float().repeat_interleave(n_rep, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * D ** -0.5
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,H,Sq,D] and k, v [B,KVH,Skv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
                         " (same B and D, H divisible by KVH)")
    if Sq % 128 or k.shape[2] % 128:
        raise ValueError(f"seq lens ({Sq},{k.shape[2]}) must divide by 128")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v types differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention is forward-only in this slice: its backward "
            "kernels (dq, dk/dv) arrive with the training slice")


def _launch(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    B, H, Sq, D = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim 64 or 128, not {D}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty_like(q)  # keeps q's layout: [B,S,H,D] callers get it back
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # the kernel reads 4 elements at a time (8 bytes in bf16, 16 in fp32)
    align = 4 * q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o)):
        if t.data_ptr() % align or any(s % 4 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be {align}-byte aligned with "
                             f"strides divisible by 4, got {t.stride()}")
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.rtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], B, H, k.shape[1], Sq,
            k.shape[2], D, int(causal), D ** -0.5, *strides, stream)
    if err:
        raise RuntimeError("flash_attention_fwd kernel launch failed: "
                           + lib.rtt_error_string(err).decode())
    launches += 1
    return o, lse


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_fwd")
    fn = lib.rtt_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_int64] * 12
                       + [ctypes.c_void_p])
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Sq,D], k/v [B,KVH,Skv,D] (any strides with a contiguous last
    dim) → (o [B,H,Sq,D], lse [B,H,Sq] fp32). CUDA tensors go through the
    kernel (bf16 or fp32, D 64 or 128), CPU tensors through the plain
    version; both need Sq and Skv divisible by 128."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    return _launch(q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Public layout, as ``ops.attention``: q [B,S,H,D], k/v [B,S,KVH,D] →
    [B,S,H,D]. The kernel reads the transposed views through their strides,
    so no layout copy is made."""
    o, _ = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal)
    return o.transpose(1, 2)
