"""Flash attention, forward and backward: the hand-written CUDA kernels and
their plain twins.

Port of ``ray_tpu/ops/pallas/flash_attention.py``. Three kernels replace the
three Pallas kernels:

- K1 (``csrc/flash_attention_fwd.cu``, ``_fwd_kernel``): online-softmax GQA
  attention with fp32 statistics that writes ``o`` and the row logsumexp;
- K2 (``csrc/flash_attention_dq.cu``, ``_dq_kernel``): ``dq``;
- K3 (``csrc/flash_attention_dkv.cu``, ``_dkv_kernel``): ``dk`` and ``dv``,
  each summed over its kv head's query group.

Each kernel's source holds two routes, chosen by the input type: bf16 runs
on the tensor cores (``wgmma``, asynchronous tile loads) for all three; fp32
runs on CUDA cores in fp32 for all three, so that fp32 means fp32 (no TF32).
The bf16 kernels round to bf16 what feeds their last products: P in K1 (as
the JAX package's reference attention rounds P), dS in K2, Pᵀ and dSᵀ in
K3; the plain twins do not.

Each wrapper (:func:`flash_attention_fwd`, :func:`flash_attention_dq`,
:func:`flash_attention_dkv`) launches its kernel for CUDA tensors and uses
its plain PyTorch twin only for tensors on the CPU; there is no fallback from
a kernel to its twin. :func:`flash_attention` is the differentiable entry in
the public ``[B,S,H,D]`` layout, the counterpart of the JAX ``custom_vjp``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.cuda import _build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

# Kernel launches since import (or since a caller reset them), one counter
# per kernel: each wrapper adds one per launch and nowhere else, so a run can
# show that its path went through the kernel. ``launches`` counts K1.
launches = 0
dq_launches = 0
dkv_launches = 0


# ------------------------------------------------------------ plain twins

def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Sq,D], k/v [B,KVH,Skv,D] → (o [B,H,Sq,D] in q's type,
    lse [B,H,Sq] fp32), in plain PyTorch with the kernel's numerics: fp32
    scores scaled by D**-0.5, a top-left causal mask (q_pos >= k_pos) filled
    with -1e30, and 1e-30 guards on the row sum."""
    s, kf, vf = _scores(q, k, v, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.to(q.dtype), lse


def _scores(q, k, v, causal):
    """fp32 scores [B,H,Sq,Skv] (scaled, causal-filled) and k, v in fp32
    repeated to H heads."""
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
    return s, kf, vf


def _delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO·O) in fp32 [B,H,Sq], from o as stored (in its own
    type), as ``_flash_bwd`` computes it outside its kernels."""
    return (do.float() * o.float()).sum(dim=-1).contiguous()


def _p_ds(q, k, v, do, lse, delta, causal):
    """The backward's probabilities P = exp(s - lse) and dS = P(dP - δ)·scale
    ([B,H,Sq,Skv] fp32), with k and v repeated to H heads in fp32."""
    s, kf, vf = _scores(q, k, v, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * q.shape[3] ** -0.5
    return p, ds, kf


def _group_sum(t: torch.Tensor, kvh: int) -> torch.Tensor:
    """[B,H,S,D] → [B,KVH,S,D]: sum over each kv head's n_rep query heads."""
    B, H, S, D = t.shape
    return t.view(B, kvh, H // kvh, S, D).sum(dim=2)


def flash_attention_dq_plain(q, k, v, do, lse, delta, causal: bool
                             ) -> torch.Tensor:
    """K2's twin: dq = Σ_k dS K [B,H,Sq,D] in q's type."""
    _, ds, kf = _p_ds(q, k, v, do, lse, delta, causal)
    return torch.matmul(ds, kf).to(q.dtype)


def flash_attention_dkv_plain(q, k, v, do, lse, delta, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's twin: dk = Σ dSᵀ Q and dv = Σ Pᵀ dO, each summed over the kv
    head's query group, [B,KVH,Skv,D] in k's and v's types."""
    p, ds, _ = _p_ds(q, k, v, do, lse, delta, causal)
    kvh = k.shape[1]
    dk = _group_sum(torch.matmul(ds.transpose(-1, -2), q.float()), kvh)
    dv = _group_sum(torch.matmul(p.transpose(-1, -2), do.float()), kvh)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward in plain PyTorch, step by step as ``_flash_bwd``: δ from
    o as stored, then K2's and K3's twins → (dq, dk, dv)."""
    delta = _delta(o, do)
    return (flash_attention_dq_plain(q, k, v, do, lse, delta, causal),
            *flash_attention_dkv_plain(q, k, v, do, lse, delta, causal))


# ------------------------------------------------------------------ kernels

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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for {q.device}")


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    rows = q.shape[:3]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != rows or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 {tuple(rows)}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _step(t: torch.Tensor) -> int:
    """Elements per 16 bytes: the kernels' unit of alignment. The bf16
    kernels copy 16-byte chunks into shared memory asynchronously; the fp32
    kernels read 4 elements at a time."""
    return 16 // t.element_size()


def _kernel_args(like, **tensors):
    """Check what every kernel takes (``like`` is q) and return the strides
    of ``tensors`` (batch, head, seq of each) in order: pointers 16-byte
    aligned and strides divisible by 16 bytes' worth of elements (8 in bf16,
    4 in fp32)."""
    if like.dtype not in _DTYPES:
        raise ValueError(f"kernel takes float32 or bfloat16, not "
                         f"{like.dtype}")
    if like.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim 64 or 128, not "
                         f"{like.shape[3]}")
    n = _step(like)
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(s % n for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"divisible by {n}, got {t.stride()}")
    return [s for t in tensors.values() for s in t.stride()[:3]]


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _readable_do(do: torch.Tensor) -> torch.Tensor:
    """dO as autograd hands it over, read in place where the kernels can
    (contiguous last dim, 16-byte alignment, strides divisible by 16 bytes'
    worth of elements), else copied: its layout is autograd's choice, not
    the caller's."""
    if (do.stride(-1) == 1 and do.data_ptr() % 16 == 0
            and not any(s % _step(do) for s in do.stride()[:3])):
        return do
    return do.clone(memory_format=torch.contiguous_format)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """lse or δ as the kernels read them: contiguous and 16-byte aligned
    (the bf16 dk/dv kernel copies them in 16-byte chunks), else copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _raise_on(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.rtt_error_string(err).decode())


def _lib(name: str, n_ptrs: int, n_strides: int) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, its entry ``rtt_<name>`` typed as
    (n_ptrs pointers, dtype, B, H, KVH, Sq, Skv, D, causal, scale,
    n_strides int64 strides, stream)."""
    lib = _build.load(name)
    fn = getattr(lib, f"rtt_{name}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 8
                       + [ctypes.c_float] + [ctypes.c_int64] * n_strides
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def _dims(q, k, causal):
    B, H, Sq, D = q.shape
    return (_DTYPES[q.dtype], B, H, k.shape[1], Sq, k.shape[2], D,
            int(causal), D ** -0.5)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    o = torch.empty_like(q)  # keeps q's layout: [B,S,H,D] callers get it back
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    strides = _kernel_args(q, q=q, k=k, v=v, o=o)
    lib = _lib("flash_attention_fwd", 5, 12)
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), *_dims(q, k, causal), *strides, _stream(q))
    _raise_on(lib, err, "flash_attention_fwd")
    launches += 1
    return o, lse


def _launch_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    global dq_launches
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    do = _readable_do(do)
    lse, delta = _rows(lse), _rows(delta)
    dq = torch.empty_like(q)
    strides = _kernel_args(q, q=q, k=k, v=v, do=do, dq=dq)
    lib = _lib("flash_attention_dq", 7, 15)
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            *_dims(q, k, causal), *strides, _stream(q))
    _raise_on(lib, err, "flash_attention_dq")
    dq_launches += 1
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    global dkv_launches
    q, k, v = (_last_contiguous(t) for t in (q, k, v))
    do = _readable_do(do)
    lse, delta = _rows(lse), _rows(delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    strides = _kernel_args(q, q=q, k=k, v=v, do=do, dk=dk, dv=dv)
    lib = _lib("flash_attention_dkv", 8, 18)
    with torch.cuda.device(q.device):
        err = lib.rtt_flash_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *_dims(q, k, causal), *strides, _stream(q))
    _raise_on(lib, err, "flash_attention_dkv")
    dkv_launches += 1
    return dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1. q [B,H,Sq,D], k/v [B,KVH,Skv,D] (any strides with a contiguous
    last dim) → (o [B,H,Sq,D], lse [B,H,Sq] fp32). CUDA tensors go through
    the kernel (bf16 or fp32, D 64 or 128), CPU tensors through the plain
    version; both need Sq and Skv divisible by 128. Not differentiable: use
    :func:`flash_attention` for that."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    return _launch_fwd(q, k, v, causal)


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool
                       ) -> torch.Tensor:
    """K2. q/dO [B,H,Sq,D], k/v [B,KVH,Skv,D], lse/δ fp32 [B,H,Sq] → dq
    [B,H,Sq,D] in q's type (and layout, on the card)."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, do, lse, delta, causal)
    return _launch_dq(q, k, v, do, lse, delta, causal)


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3. The inputs of :func:`flash_attention_dq` → (dk, dv)
    [B,KVH,Skv,D] in k's and v's types, each summed over the kv head's
    query group."""
    _check_bwd(q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return flash_attention_dkv_plain(q, k, v, do, lse, delta, causal)
    return _launch_dkv(q, k, v, do, lse, delta, causal)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`flash_attention_fwd`: δ = rowsum(dO·O) in
    plain torch, then K2 and K3 (their twins on the CPU) → (dq, dk, dv)."""
    delta = _delta(o, do)
    return (flash_attention_dq(q, k, v, do, lse, delta, causal),
            *flash_attention_dkv(q, k, v, do, lse, delta, causal))


class _FlashAttention(torch.autograd.Function):
    """The JAX ``flash_attention`` custom_vjp: the forward runs K1 and saves
    (q, k, v, o, lse); the backward runs K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Public layout, as ``ops.attention``: q [B,S,H,D], k/v [B,S,KVH,D] →
    [B,S,H,D], differentiable. The kernels read the transposed views through
    their strides, so no layout copy is made."""
    o = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal)
    return o.transpose(1, 2)
