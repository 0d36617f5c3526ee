"""Mixtral-style sparse Mixture-of-Experts decoder on one device.

Port of ``ray_tpu/models/moe.py``. Params are a dictionary of tensors in the
reference's layer-stacked layout, the forward a function of (params, tokens).
Routing keeps the reference's static shapes: fp32 router softmax, top-k
gates, slot positions from a cumsum over the flattened (token, k) axis, and
one-hot dispatch and combine masks [B, S, E, C], so that every expert runs a
dense [C, H] × [H, M] product. Products are ``torch.einsum`` in ``cfg.dtype``
on the weights cast at each product, as the reference leaves them to XLA;
attention is the plain reference path, as in the reference.

The reference's ``constrain`` calls are left out: they are no-ops without a
mesh. Not ported yet: ``moe_logical_axes`` and the dispatch and combine as
an all_to_all over the ``expert`` axis, which wait for expert parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ray_tpu_torch._private.tree import tree_from_numpy
from ray_tpu_torch.models.llama import (
    _nll_from_logits, _rms_norm, _rope, _trunc_normal)
from ray_tpu_torch.ops.attention import attention

_LAYER_KEYS = frozenset({"wq", "wk", "wv", "wo", "router", "we_gate", "we_up",
                         "we_down", "attn_norm", "mlp_norm"})


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    hidden: int = 512
    mlp_hidden: int = 1024
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 8
    num_experts: int = 8
    experts_per_token: int = 2  # top-k
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    aux_loss_coeff: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden // self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 256) -> "MoEConfig":
        return MoEConfig(vocab_size=vocab_size, hidden=64, mlp_hidden=128,
                         num_layers=2, num_heads=4, num_kv_heads=4,
                         num_experts=4)

    @staticmethod
    def mixtral_8x7b_proxy() -> "MoEConfig":
        """Mixtral-8x7B's widths (32 layers, 46.7 B params), with the
        reference's ``rope_theta`` of 1e4."""
        return MoEConfig(vocab_size=32000, hidden=4096, mlp_hidden=14336,
                         num_layers=32, num_heads=32, num_kv_heads=8,
                         num_experts=8, experts_per_token=2)


def init_moe(cfg: MoEConfig, generator: torch.Generator,
             device: torch.device) -> Dict[str, Any]:
    """The reference's truncated-normal fan-in scales, every leaf in
    ``cfg.param_dtype``, norms ones. Each weight of each layer is drawn in
    fp32 on its own and stored at once, so a full-width init never holds a
    second fp32 copy of a layer's experts."""
    h, m, E = cfg.hidden, cfg.mlp_hidden, cfg.num_experts
    nh, nkv, hd, L = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.num_layers)
    dt = cfg.param_dtype

    def draw(shape, fan_in):
        return _trunc_normal(shape, fan_in, generator, device, dt)

    shapes = {  # name: (per-layer shape, fan_in)
        "wq": ((h, nh, hd), h), "wk": ((h, nkv, hd), h),
        "wv": ((h, nkv, hd), h), "wo": ((nh, hd, h), nh * hd),
        "router": ((h, E), h), "we_gate": ((E, h, m), h),
        "we_up": ((E, h, m), h), "we_down": ((E, m, h), m),
    }
    layers = {name: torch.empty((L,) + shape, dtype=dt, device=device)
              for name, (shape, _) in shapes.items()}
    for i in range(L):
        for name, (shape, fan_in) in shapes.items():
            layers[name][i] = draw(shape, fan_in)
    layers["attn_norm"] = torch.ones((L, h), dtype=dt, device=device)
    layers["mlp_norm"] = torch.ones((L, h), dtype=dt, device=device)
    return {
        "embed": draw((cfg.vocab_size, h), h),
        "layers": layers,
        "final_norm": torch.ones((h,), dtype=dt, device=device),
        "lm_head": draw((h, cfg.vocab_size), h),
    }


def moe_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's MoE params, as numpy arrays
    (``jax.tree.map(np.asarray, params)``, done by the caller), as this
    port's CPU tensors. The layouts are the same, so this only converts."""
    if (set(tree) != {"embed", "layers", "final_norm", "lm_head"}
            or set(tree["layers"]) != _LAYER_KEYS):
        raise ValueError(f"not an MoE param tree: keys {sorted(tree)}"
                         f", layers {sorted(tree.get('layers', {}))}")
    return tree_from_numpy(tree)


def capacity(cfg: MoEConfig, seq_len: int) -> int:
    """Slots per expert and batch row: the reference's Python float
    arithmetic, ``max(1, int(capacity_factor * S * K / E))``."""
    return max(1, int(cfg.capacity_factor * seq_len * cfg.experts_per_token
                      / cfg.num_experts))


class Routing(NamedTuple):
    """The routing of x [B, S, H] over E experts of C slots, top-K."""
    probs: torch.Tensor       # [B, S, E] fp32 router softmax
    gate_vals: torch.Tensor   # [B, S, K] fp32, renormalised over the K
    expert_idx: torch.Tensor  # [B, S, K], descending probability
    onehot: torch.Tensor      # [B, S, K, E] int, before the capacity drop
    keep: torch.Tensor        # [B, S, K, E] bool, after it
    slot_oh: torch.Tensor     # [B, S, K, E, C] in x's type


def route(cfg: MoEConfig, x: torch.Tensor,
          router: torch.Tensor) -> Routing:
    """Top-k routing with capacity, static shapes only (the reference's
    ``_moe_ffn`` up to its masks). The router runs in fp32. A (token, k)
    pair's slot in its expert's buffer counts the pairs before it in the
    flattened (token, k) order, so (s, 0) takes a slot before (s, 1); pairs
    at slot C or beyond are dropped. A slot position >= C gives an all-zero
    one-hot row, as ``jax.nn.one_hot`` does."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    logits = torch.einsum("bsh,he->bse", x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = (expert_idx[..., None]
              == torch.arange(E, device=x.device)).to(torch.int32)
    flat = onehot.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)
    keep = (pos < C) & (onehot > 0)
    slot_oh = (pos[..., None]
               == torch.arange(C, device=x.device)).to(x.dtype)
    return Routing(probs, gate_vals, expert_idx, onehot, keep, slot_oh)


def _moe_ffn(cfg: MoEConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse expert FFN. x: [B, S, H] -> ([B, S, H], aux loss fp32)."""
    dt = cfg.dtype
    E = cfg.num_experts
    r = route(cfg, x, lp["router"])
    keep_f = r.keep.to(x.dtype)  # the onehot is folded into keep already
    dispatch = torch.einsum("bske,bskec->bsec", keep_f, r.slot_oh)
    combine = torch.einsum("bsk,bske,bskec->bsec", r.gate_vals.to(x.dtype),
                           keep_f, r.slot_oh)

    expert_in = torch.einsum("bsec,bsh->ebch", dispatch, x)  # [E, B, C, H]
    gate = torch.einsum("ebch,ehm->ebcm", expert_in, lp["we_gate"].to(dt))
    up = torch.einsum("ebch,ehm->ebcm", expert_in, lp["we_up"].to(dt))
    act = torch.nn.functional.silu(gate) * up
    out = torch.einsum("ebcm,emh->ebch", act, lp["we_down"].to(dt))
    y = torch.einsum("ebch,bsec->bsh", out, combine)

    # Switch-style load-balancing loss: router mass times the share of
    # tokens routed to each expert before the capacity drop (no grad there)
    me = r.probs.mean(dim=(0, 1))
    ce = (r.onehot.sum(2) > 0).float().mean(dim=(0, 1))
    return y, E * torch.sum(me * ce)


def _moe_layer(cfg: MoEConfig, x: torch.Tensor, lp: Dict[str, torch.Tensor],
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = cfg.dtype
    h = _rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    q = torch.einsum("bsh,hnd->bsnd", h, lp["wq"].to(dt))
    k = torch.einsum("bsh,hnd->bsnd", h, lp["wk"].to(dt))
    v = torch.einsum("bsh,hnd->bsnd", h, lp["wv"].to(dt))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = attention(q, k, v, impl="reference", causal=True)
    x = x + torch.einsum("bsnd,ndh->bsh", attn, lp["wo"].to(dt))
    h = _rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    y, aux = _moe_ffn(cfg, h, lp)
    return x + y, aux


def moe_forward(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, V] fp32, the layers' aux losses
    summed, fp32). No remat, as in the reference."""
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    # per-layer views through one ``unbind`` per leaf, whose backward stacks
    # the layers' grads once, as the reference's scan writes them
    layers = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.num_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x, layer_aux = _moe_layer(cfg, x, lp, positions)
        aux = aux + layer_aux
    x = _rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = torch.einsum("bsh,hv->bsv", x, params["lm_head"].to(dt))
    return logits.float(), aux


def moe_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             cfg: MoEConfig) -> torch.Tensor:
    """Next-token cross-entropy of ``batch["inputs"]`` against
    ``batch["targets"]`` plus ``aux_loss_coeff`` times the mean aux loss
    per layer."""
    logits, aux = moe_forward(params, batch["inputs"], cfg)
    nll = _nll_from_logits(logits, batch["targets"])
    return nll.mean() + cfg.aux_loss_coeff * aux / cfg.num_layers
