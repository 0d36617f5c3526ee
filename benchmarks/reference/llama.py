"""Plain PyTorch reference of a llama-shaped decoder (Llama, Mistral) in
float32 with TF32 off, one sequence at a time, with LoRA deltas on the
projections that carry them. No kernel, cache or batching of the program.

The equations: RMSNorm ``x * rsqrt(mean(x^2) + eps)`` (its weights are ones
as drawn), rotary embedding on the pairs (d, d + D/2) with
``theta ** (-2i / D)``, grouped-query attention with causal softmax scaled
by ``D ** -0.5``, SwiGLU ``w_down(silu(w_gate h) * w_up h)``, residual adds,
a final RMSNorm and an untied head. A LoRA delta on a projection adds
``(h A) B * alpha / rank``.

``quant="fp8"`` is the control (``rounding.py``): the operands of every
product rounded to float8 e4m3, one precision step below the bfloat16 the
configuration runs in."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from benchmarks.reference.layers import attention, rms, rope
from benchmarks.reference.rounding import Rounding, exact_float32


def layer(r: Rounding, c: Dict, x: torch.Tensor, lw: Dict, lora: Dict,
          lora_scale: float) -> torch.Tensor:
    """One block over x [S, H] in float32; ``lw`` the layer's weights (any
    float type), ``lora`` the layer's {name: {"a", "b"}}."""
    h, nh, nkv, hd = c["hidden"], c["num_heads"], c["num_kv_heads"], \
        c["head_dim"]
    S = x.shape[0]

    def proj(name, t, out_shape):
        y = r.mm(t, lw[name].float().reshape(t.shape[-1], -1))
        if name in lora:
            a = lora[name]["a"].reshape(t.shape[-1], -1)
            b = lora[name]["b"].reshape(a.shape[-1], -1)
            y = y + r.mm(r.mm(t, a), b) * lora_scale
        return y.reshape((S,) + out_shape)

    t = rms(x, c["rms_eps"])
    q = rope(proj("wq", t, (nh, hd)), c["rope_theta"])
    k = rope(proj("wk", t, (nkv, hd)), c["rope_theta"])
    o = attention(r, q, k, proj("wv", t, (nkv, hd))).reshape(S, nh * hd)
    x = x + proj("wo", o, (h,))
    t = rms(x, c["rms_eps"])
    g = proj("w_gate", t, (c["mlp_hidden"],))
    u = proj("w_up", t, (c["mlp_hidden"],))
    return x + proj("w_down", F.silu(g) * u, (h,))


def _layer_weights(weights: Dict, lora: Optional[Dict], i: int):
    lw = {n: w[i] for n, w in weights["layers"].items()}
    lo = {n: {"a": ab["a"][i], "b": ab["b"][i]}
          for n, ab in (lora or {}).items()}
    return lw, lo


def forward(weights: Dict, lora: Optional[Dict], c: Dict, tokens,
            lora_scale: float = 0.0, quant: Optional[str] = None
            ) -> torch.Tensor:
    """tokens [S] -> logits [S, V] in float32, without grad. ``weights`` as
    ``draws.llama_weights`` gives them, ``lora`` as ``draws.served_adapter``
    (its ``layers`` level left out)."""
    r = Rounding(quant)
    with torch.no_grad(), exact_float32():
        x = weights["embed"][tokens].float()
        for i in range(c["num_layers"]):
            lw, lo = _layer_weights(weights, lora, i)
            x = layer(r, c, x, lw, lo, lora_scale)
        return r.mm(rms(x, c["rms_eps"]), weights["lm_head"].float())
