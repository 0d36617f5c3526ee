"""Operation and byte counts of the model work, from shapes alone.

Model FLOPs count what the algorithm needs, not what a run executes: no
recomputation (remat), no padded rows or positions, no recomputed prefix,
and attention's score and value products only over the causal part that a
position keeps (a query at position i meets i + 1 keys)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Sequence


def dense_matmul_params(c: Dict[str, Any]) -> int:
    """Weights a token meets in products in a llama-shaped model: every
    layer's projections and MLP, and the head (the embedding is a gather)."""
    h, m = c["hidden"], c["mlp_hidden"]
    nh, nkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    per_layer = h * (nh + 2 * nkv) * hd + nh * hd * h + 3 * h * m
    return c["num_layers"] * per_layer + h * c["vocab_size"]


def moe_active_params(c: Dict[str, Any]) -> int:
    """Weights a token meets in products in a Mixtral-shaped model: the
    attention projections, the router, its top-k experts' FFN, the head."""
    h, m = c["hidden"], c["mlp_hidden"]
    nh, nkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    E, K = c["num_experts"], c["experts_per_token"]
    per_layer = h * (nh + 2 * nkv) * hd + nh * hd * h + h * E + K * 3 * h * m
    return c["num_layers"] * per_layer + h * c["vocab_size"]


def lora_params(c: Dict[str, Any], rank: int, targets: Iterable[str]) -> int:
    h, m, r = c["hidden"], c["mlp_hidden"], rank
    nh, nkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    per = {"wq": h * r + r * nh * hd, "wk": h * r + r * nkv * hd,
           "wv": h * r + r * nkv * hd, "wo": nh * hd * r + r * h,
           "w_gate": h * r + r * m, "w_up": h * r + r * m,
           "w_down": m * r + r * h}
    return c["num_layers"] * sum(per[t] for t in targets)


def attn_fwd_flops_at(c: Dict[str, Any], context: int) -> float:
    """Forward score and value products of one query meeting ``context``
    keys, over all layers and heads."""
    return 4.0 * c["num_layers"] * c["num_heads"] * c["head_dim"] * context


def attn_fwd_flops_causal(c: Dict[str, Any], seq: int) -> float:
    """Forward score and value products of a causal sequence of ``seq``
    positions (query i meets i + 1 keys), over all layers and heads."""
    return attn_fwd_flops_at(c, 1) * seq * (seq + 1) / 2.0


def serve_flops(c: Dict[str, Any], lora_rank: int, targets: Sequence[str],
                served: Iterable[Sequence[Any]]) -> float:
    """Model FLOPs of the tokens served in a window. ``served`` holds, per
    request, (prompt length, indices of the output tokens that arrived in
    the window). Output token k comes from position prompt - 1 + k, which
    meets prompt + k keys; a request whose first token is in the window
    also has its prompt counted once, each prompt position at its own
    context."""
    n = dense_matmul_params(c) + lora_params(c, lora_rank, targets)
    total = 0.0
    for prompt_len, ks in served:
        for k in ks:
            total += 2.0 * n + attn_fwd_flops_at(c, prompt_len + k)
        if 0 in ks and prompt_len > 1:
            total += (prompt_len - 1) * 2.0 * n \
                + attn_fwd_flops_causal(c, prompt_len - 1)
    return total
