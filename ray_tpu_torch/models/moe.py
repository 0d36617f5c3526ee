"""Mixtral-style sparse Mixture-of-Experts decoder on one device.

Port of ``ray_tpu/models/moe.py``. Params are a dictionary of tensors in the
reference's layer-stacked layout, the forward a function of (params, tokens).
Routing keeps the reference's static shapes: fp32 router softmax, top-k
gates, slot positions from a cumsum over the flattened (token, k) axis, and
one-hot dispatch and combine masks [B, S, E, C], so that every expert runs a
dense [C, H] × [H, M] product. Products are ``torch.einsum`` in ``cfg.dtype``
on the weights cast at each product, as the reference leaves them to XLA;
attention is the plain reference path, as in the reference.

Expert parallelism: :func:`moe_logical_axes` places the expert FFN stacks
on the mesh's ``expert`` axis (their leading expert dim), and the
``constrain`` calls sit where the reference's sit. On a mesh the params and
the batch are DTensors (``parallel.train_step``), and DTensor's sharding
propagation plays GSPMD's part: the routing needs each token's whole expert
row, so the expert-sharded router logits are gathered before the softmax
and ``topk`` (which then run alike on every expert rank); the dispatch
einsum gives ``expert_in`` [E, B, C, H], which ``constrain`` cuts along E
(each expert rank keeps its own experts' slots, no communication: under the
default rules the batch rides ``data`` and ``fsdp``, not ``expert``); each
rank runs its experts' products; and the combine contracts over E, a sum
over the ``expert`` axis, which DTensor leaves partial until the residual
add reduces it. An all_to_all would appear only where the tokens are
sharded over the axis the experts are on, which no rule table here does.
Without a mesh the ``constrain`` calls are no-ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.tree import tree_from_numpy
from ray_tpu_torch.models.llama import (
    _nll_from_logits, _rms_norm, _rope, _trunc_normal)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel.sharding import (
    as_replicated, constrain, place_like)

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


def moe_logical_axes(cfg: MoEConfig) -> Dict[str, Any]:
    """The params' logical axes, as the reference's: the expert FFN stacks'
    leading (after the layer dim) ``expert`` dim shards over the mesh's
    ``expert`` axis, the router's expert dim too."""
    del cfg
    layer = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "router": ("embed", "expert"),
        "we_gate": ("expert", "embed", "mlp"),
        "we_up": ("expert", "embed", "mlp"),
        "we_down": ("expert", "mlp", "embed"),
        "attn_norm": ("norm",),
        "mlp_norm": ("norm",),
    }
    return {
        "embed": ("vocab", "embed"),
        "layers": {k: (None,) + v for k, v in layer.items()},
        "final_norm": ("norm",),
        "lm_head": ("embed", "vocab"),
    }


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
    expert_idx = torch.topk(probs.detach(), K, dim=-1, sorted=True).indices
    onehot = (expert_idx[..., None] == as_replicated(
        torch.arange(E, device=x.device), x)).to(torch.int32)
    # the top-k values picked by the one-hot mask (exactly the values, one
    # nonzero term per sum; the same gradient): topk's backward scatters
    # into a plain zero tensor, which DTensor refuses in some torch versions
    gate_vals = (probs[..., None, :] * onehot).sum(-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat = onehot.reshape(B, S * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, K, E)
    keep = (pos < C) & (onehot > 0)
    slot_oh = (pos[..., None] == as_replicated(
        torch.arange(C, device=x.device), x)).to(x.dtype)
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
    expert_in = constrain(expert_in, ("expert", "batch", None, "embed"))
    gate = torch.einsum("ebch,ehm->ebcm", expert_in, lp["we_gate"].to(dt))
    up = torch.einsum("ebch,ehm->ebcm", expert_in, lp["we_up"].to(dt))
    act = F.silu(gate) * up
    out = torch.einsum("ebcm,emh->ebch", act, lp["we_down"].to(dt))
    out = constrain(out, ("expert", "batch", None, "embed"))
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
    # F.embedding, not indexing, as llama_hidden looks tokens up on a mesh
    x = F.embedding(tokens, constrain(params["embed"], ("vocab", None))
                    ).to(dt)
    x = constrain(x, ("batch", "seq", "embed"))
    B, S = tokens.shape
    positions = place_like(torch.arange(S, device=tokens.device).expand(B, S),
                           tokens)
    aux = as_replicated(torch.zeros((), dtype=torch.float32,
                                    device=tokens.device), tokens)
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
