"""Llama-2/3-family decoder-only transformer in PyTorch, forward only.

Port of ``ray_tpu/models/llama.py``. It keeps the reference's functional
shape so that the two can be held against each other: parameters are a
dictionary of tensors in the same layer-stacked layout (a leading
``num_layers`` dim), the forward is a function of (params, tokens), and each
weight is cast to the activation type at each product (``.to(cfg.dtype)``,
the reference's ``.astype(cfg.dtype)``), LoRA deltas included. The
reference's ``lax.scan`` over layers is a Python loop here. Attention goes
through ``ray_tpu_torch.ops.attention`` (the CUDA flash kernel on the card);
the projections and the MLP are ``torch.einsum``, as the reference leaves
them to XLA.

Not ported yet: ``llama_decode`` (kv cache), remat, the loss
(``llama_loss``, ``_chunked_ce``), ``merge_lora``, ``llama_logical_axes``
and the ring-attention layer (``attn_impl="ring_seq"``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden: int = 4096
    mlp_hidden: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16      # activation dtype
    param_dtype: torch.dtype = torch.float32
    attn_impl: str = "auto"                  # auto | flash | reference

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(vocab_size=vocab_size, hidden=128, mlp_hidden=352,
                           num_layers=2, num_heads=4, num_kv_heads=2,
                           head_dim=32, max_seq_len=256)

    @staticmethod
    def debug_1l() -> "LlamaConfig":
        return LlamaConfig(vocab_size=128, hidden=64, mlp_hidden=176,
                           num_layers=1, num_heads=2, num_kv_heads=1,
                           head_dim=32, max_seq_len=128)

    def flops_per_token(self, seq_len: Optional[int] = None) -> float:
        """Approximate fwd+bwd FLOPs/token: 6*N, plus the attention
        quadratic term 12*L*H*D*S when ``seq_len`` is given."""
        flops = 6.0 * self.num_params()
        if seq_len is not None:
            flops += (12.0 * self.num_layers * self.num_heads
                      * self.head_dim * seq_len)
        return flops

    def flops_per_token_frozen(self, trainable_params: int,
                               seq_len: Optional[int] = None) -> float:
        """Frozen-base (LoRA) fwd+bwd FLOPs/token: the backward still
        propagates activation grads through every frozen layer (2N) but
        forms weight grads only for the adapters — 4N_base + 6N_adapters.
        Attention's quadratic term keeps its full factor (dQ/dK/dV are
        activation grads)."""
        flops = 4.0 * self.num_params() + 6.0 * trainable_params
        if seq_len is not None:
            flops += (12.0 * self.num_layers * self.num_heads
                      * self.head_dim * seq_len)
        return flops

    def num_params(self) -> int:
        h, m, v = self.hidden, self.mlp_hidden, self.vocab_size
        qkv = h * (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        o = self.num_heads * self.head_dim * h
        mlp = 3 * h * m
        per_layer = qkv + o + mlp + 2 * h
        return self.num_layers * per_layer + 2 * v * h + h


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    """Low-rank adaptation of the projection weights (frozen base). The
    deltas are applied activation-side, two thin products per projection,
    never materializing the full-rank update."""
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo",
                                "w_gate", "w_up", "w_down")
    param_dtype: torch.dtype = torch.float32

    @property
    def scale(self) -> float:
        return self.alpha / self.rank

    def num_params(self, cfg: LlamaConfig) -> int:
        h, m, r = cfg.hidden, cfg.mlp_hidden, self.rank
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        per = {"wq": h * r + r * nh * hd, "wk": h * r + r * nkv * hd,
               "wv": h * r + r * nkv * hd, "wo": nh * hd * r + r * h,
               "w_gate": h * r + r * m, "w_up": h * r + r * m,
               "w_down": m * r + r * h}
        return cfg.num_layers * sum(per[t] for t in self.targets)


# (in dims of A, out dims of B) per adaptable projection; the A/B shapes are
# in_dims+(rank,) and (rank,)+out_dims with a leading num_layers dim.
_LORA_SHAPES = {
    "wq": (("embed",), ("heads", "head_dim")),
    "wk": (("embed",), ("kv_heads", "head_dim")),
    "wv": (("embed",), ("kv_heads", "head_dim")),
    "wo": (("heads", "head_dim"), ("embed",)),
    "w_gate": (("embed",), ("mlp",)),
    "w_up": (("embed",), ("mlp",)),
    "w_down": (("mlp",), ("embed",)),
}


def _lora_dims(cfg: LlamaConfig):
    return {"embed": (cfg.hidden,), "mlp": (cfg.mlp_hidden,),
            "heads": (cfg.num_heads,), "kv_heads": (cfg.num_kv_heads,),
            "head_dim": (cfg.head_dim,)}


def _trunc_normal(shape, fan_in: float, generator: torch.Generator,
                  device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by fan_in**-0.5, drawn in fp32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * fan_in ** -0.5).to(dtype)


def init_lora(cfg: LlamaConfig, lcfg: LoraConfig,
              generator: torch.Generator,
              device: torch.device) -> Dict:
    """A ~ truncated-normal fan-in, B = 0 (the adapted model starts exactly
    at the base), stacked over layers."""
    dims = _lora_dims(cfg)
    L, r = cfg.num_layers, lcfg.rank
    out = {}
    for name in lcfg.targets:
        in_ax, out_ax = _LORA_SHAPES[name]
        in_shape = sum((dims[a] for a in in_ax), ())
        out_shape = sum((dims[a] for a in out_ax), ())
        a = _trunc_normal((L,) + in_shape + (r,), float(np.prod(in_shape)),
                          generator, device, lcfg.param_dtype)
        b = torch.zeros((L, r) + out_shape, dtype=lcfg.param_dtype,
                        device=device)
        out[name] = {"a": a, "b": b}
    return {"layers": out}


def init_llama(cfg: LlamaConfig, generator: torch.Generator,
               device: torch.device) -> Dict[str, Any]:
    """Initialize params with the reference's truncated-normal fan-in
    scales. Matrix weights and the embedding are stored in
    ``cfg.param_dtype``, norm weights in fp32. Each weight of each layer is
    drawn in fp32 on its own and stored at once, so a 7B init in bf16 never
    holds a whole fp32 copy."""
    h, m = cfg.hidden, cfg.mlp_hidden
    nh, nkv, hd, L = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.num_layers)
    dt = cfg.param_dtype

    def draw(shape, fan_in):
        return _trunc_normal(shape, fan_in, generator, device, dt)

    shapes = {  # name: (per-layer shape, fan_in)
        "wq": ((h, nh, hd), h), "wk": ((h, nkv, hd), h),
        "wv": ((h, nkv, hd), h), "wo": ((nh, hd, h), nh * hd),
        "w_gate": ((h, m), h), "w_up": ((h, m), h), "w_down": ((m, h), m),
    }
    layers = {name: torch.empty((L,) + shape, dtype=dt, device=device)
              for name, (shape, _) in shapes.items()}
    for i in range(L):
        for name, (shape, fan_in) in shapes.items():
            layers[name][i] = draw(shape, fan_in)
    layers["attn_norm"] = torch.ones((L, h), device=device)
    layers["mlp_norm"] = torch.ones((L, h), device=device)
    return {
        "embed": draw((cfg.vocab_size, h), 1.0),
        "layers": layers,
        "final_norm": torch.ones((h,), device=device),
        "lm_head": draw((h, cfg.vocab_size), h),
    }


def _from_numpy(tree):
    if isinstance(tree, dict):
        return {k: _from_numpy(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no numpy-native bf16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's llama params, as numpy arrays
    (``jax.tree.map(np.asarray, params)``, done by the caller), as this
    port's CPU tensors. The layouts are the same, so this only converts."""
    missing = {"embed", "layers", "final_norm", "lm_head"} - set(tree)
    if missing:
        raise ValueError(f"not a llama param tree: missing {sorted(missing)}")
    return _from_numpy(tree)


def lora_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's LoRA adapters ({"layers": {name: {"a", "b"}}}, as
    numpy arrays) as this port's CPU tensors."""
    if set(tree) != {"layers"}:
        raise ValueError(f"not a LoRA tree: keys {sorted(tree)}")
    return _from_numpy(tree)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; rotate pairs (d, d + D/2) — llama convention."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _layer(cfg: LlamaConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
           positions: torch.Tensor,
           lora: Optional[Dict[str, Any]] = None,
           lora_scale: float = 0.0) -> torch.Tensor:
    """One transformer block, no kv cache. x: [B, S, H_model]."""
    dt = cfg.dtype

    def _ld(name, t_in, eq_a, eq_b):
        """Activation-side LoRA delta: (t_in @ A) @ B * scale, or 0."""
        if lora is None or name not in lora:
            return 0
        ab = lora[name]
        t = torch.einsum(eq_a, t_in, ab["a"].to(dt))
        return torch.einsum(eq_b, t, ab["b"].to(dt)) * lora_scale

    # --- attention ---
    h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = (torch.einsum("bsh,hnd->bsnd", h, lp["wq"].to(dt))
         + _ld("wq", h, "bsh,hr->bsr", "bsr,rnd->bsnd"))
    k = (torch.einsum("bsh,hnd->bsnd", h, lp["wk"].to(dt))
         + _ld("wk", h, "bsh,hr->bsr", "bsr,rnd->bsnd"))
    v = (torch.einsum("bsh,hnd->bsnd", h, lp["wv"].to(dt))
         + _ld("wv", h, "bsh,hr->bsr", "bsr,rnd->bsnd"))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    if cfg.attn_impl == "ring_seq":
        raise NotImplementedError(
            "attn_impl='ring_seq' (sequence-parallel ring attention) is not "
            "ported to ray_tpu_torch yet")
    attn_out = attention(q, k, v, impl=cfg.attn_impl, causal=True)
    x = (x + torch.einsum("bsnd,ndh->bsh", attn_out, lp["wo"].to(dt))
         + _ld("wo", attn_out, "bsnd,ndr->bsr", "bsr,rh->bsh"))
    # --- mlp (SwiGLU) ---
    h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    gate = (torch.einsum("bsh,hm->bsm", h, lp["w_gate"].to(dt))
            + _ld("w_gate", h, "bsh,hr->bsr", "bsr,rm->bsm"))
    up = (torch.einsum("bsh,hm->bsm", h, lp["w_up"].to(dt))
          + _ld("w_up", h, "bsh,hr->bsr", "bsr,rm->bsm"))
    act = torch.nn.functional.silu(gate) * up
    return (x + torch.einsum("bsm,mh->bsh", act, lp["w_down"].to(dt))
            + _ld("w_down", act, "bsm,mr->bsr", "bsr,rh->bsh"))


def llama_hidden(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    lora: Optional[Dict[str, Any]] = None,
    lora_cfg: Optional[LoraConfig] = None,
) -> torch.Tensor:
    """tokens [B, S] int → final hidden states [B, S, H] (activation
    dtype, post final-norm). A Python loop over the stacked layers; LoRA
    adapters (if given) are sliced alongside the base."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params["embed"][tokens].to(cfg.dtype)
    scale = lora_cfg.scale if lora_cfg is not None else 0.0
    layers = params["layers"]
    lo_layers = lora["layers"] if lora is not None else {}
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        lo = {name: {"a": ab["a"][i], "b": ab["b"][i]}
              for name, ab in lo_layers.items()}
        x = _layer(cfg, x, lp, positions, lora=lo, lora_scale=scale)
    return _rms_norm(x, params["final_norm"], cfg.rms_eps)


def llama_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: LlamaConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    lora: Optional[Dict[str, Any]] = None,
    lora_cfg: Optional[LoraConfig] = None,
) -> torch.Tensor:
    """tokens [B, S] int → logits [B, S, V] (fp32)."""
    x = llama_hidden(params, tokens, cfg, positions=positions,
                     lora=lora, lora_cfg=lora_cfg)
    logits = torch.einsum("bsh,hv->bsv", x, params["lm_head"].to(cfg.dtype))
    return logits.float()
