"""Plain PyTorch reference of a Mixtral-shaped decoder's training loss, in
float32 with TF32 off.

A layer: RMSNorm, grouped-query causal attention with rotary embedding
(pairs (d, d + D/2)), residual; RMSNorm, then a sparse expert FFN: the router
``softmax(h W_r)`` in float32, the top-k experts of each token by
probability, their gates renormalised over the k, and a capacity of
``int(capacity_factor * S * k / E)`` slots per expert and sequence, taken in
the order (token, then k) so that a token's first choice claims its slot
before its second; a pair that finds its expert full is dropped. Each kept
pair adds ``gate * w_down(silu(w_gate h) * w_up h)`` of its expert. The
load-balancing loss of a layer is ``E * sum_e mean(p_e) * mean(routed_e)``,
with the routed share counted before the drop; the loss is the mean
next-token cross-entropy plus ``aux_loss_coeff`` times the layers' mean aux
loss. The dispatch gathers each expert's kept tokens instead of the
program's one-hot masks: the same sums in another order.

Given the program's routing, the reference takes its choices of experts
and drops and keeps its own gates: a choice between two experts whose
probabilities tie to rounding flips on any rounding, and one flipped token
moves the loss and the router's gradient by as much as a lower precision
does, so the arithmetic is compared on the program's routing, and the
routing apart (the share of choices that differ from the reference's own).

``quant="fp8"`` rounds the operands of every product to float8 e4m3 (one
scale per row, the backward passing the rounding straight through): the
control, one precision step below the configuration's bfloat16."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmarks.reference.layers import attention, rms, rope
from benchmarks.reference.rounding import Rounding


def capacity(c: Dict, seq: int) -> int:
    return max(1, int(c["capacity_factor"] * seq * c["experts_per_token"]
                      / c["num_experts"]))


def expert_ffn(r: Rounding, c: Dict, h: torch.Tensor, lw: Dict,
               forced=None, seen=None):
    """h [B, S, H] -> (y [B, S, H], aux loss). ``forced`` (top-k experts
    [B, S, K] and kept [B, S, K]) replaces the routing's choices; ``seen``
    collects this reference's own top-k experts."""
    B, S, H = h.shape
    E, K = c["num_experts"], c["experts_per_token"]
    C = capacity(c, S)
    probs = torch.softmax(r.mm(h, lw["router"]), dim=-1)  # [B, S, E]
    idx = torch.topk(probs.detach(), K, dim=-1, sorted=True).indices
    if seen is not None:
        seen.append(idx.to("cpu").numpy().astype("int8"))
    if forced is not None:
        idx = torch.as_tensor(forced[0], device=h.device).long()
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(idx, E)                               # [B, S, K, E]
    flat = onehot.reshape(B, S * K, E)
    pos = (flat.cumsum(1) - flat).reshape(B, S, K, E)
    slot = (pos * onehot).sum(-1)                            # [B, S, K]
    keep = slot < C
    if forced is not None:
        keep = torch.as_tensor(forced[1], device=h.device)
    y = torch.zeros_like(h)
    for e in range(E):
        b, s, k = torch.nonzero((idx == e) & keep, as_tuple=True)
        if b.numel() == 0:
            continue
        x = h[b, s]
        act = F.silu(r.mm(x, lw["we_gate"][e])) * r.mm(x, lw["we_up"][e])
        out = r.mm(act, lw["we_down"][e]) * gates[b, s, k][:, None]
        y = y.index_put((b, s), out, accumulate=True)
    me = probs.mean(dim=(0, 1))
    ce = (onehot.sum(2) > 0).float().mean(dim=(0, 1))
    return y, E * torch.sum(me * ce)


def loss(params: Dict, batch: Dict[str, torch.Tensor], c: Dict,
         quant: Optional[str] = None, seen=None) -> torch.Tensor:
    """The training loss of ``batch`` (inputs, targets [B, S]) under float32
    params laid out as ``draws.moe_weights`` gives them. With
    ``batch["routing"]`` (per layer: top-k experts and kept, as the program
    routed), the experts and drops are the program's, and ``seen`` gets
    this reference's own choices per layer."""
    r = Rounding(quant)
    nh, nkv, hd, eps = c["num_heads"], c["num_kv_heads"], c["head_dim"], \
        c["rms_eps"]
    tokens = batch["inputs"]
    B, S = tokens.shape
    x = params["embed"][tokens]
    aux = 0.0
    layers = params["layers"]
    for i in range(c["num_layers"]):
        lw = {n: w[i] for n, w in layers.items()}
        t = rms(x, eps, lw["attn_norm"])
        q = rope(r.mm(t, lw["wq"].reshape(t.shape[-1], -1)
                      ).reshape(B, S, nh, hd), c["rope_theta"])
        k = rope(r.mm(t, lw["wk"].reshape(t.shape[-1], -1)
                      ).reshape(B, S, nkv, hd), c["rope_theta"])
        v = r.mm(t, lw["wv"].reshape(t.shape[-1], -1)).reshape(B, S, nkv, hd)
        o = attention(r, q, k, v).reshape(B, S, nh * hd)
        x = x + r.mm(o, lw["wo"].reshape(nh * hd, -1))
        t = rms(x, eps, lw["mlp_norm"])
        forced = batch["routing"][i] if "routing" in batch else None
        y, a = expert_ffn(r, c, t, lw, forced, seen)
        x = x + y
        aux = aux + a
    x = rms(x, eps, params["final_norm"])
    logits = r.mm(x, params["lm_head"])
    nll = F.cross_entropy(logits.reshape(B * S, -1),
                          batch["targets"].reshape(-1))
    return nll + c["aux_loss_coeff"] * aux / c["num_layers"]
