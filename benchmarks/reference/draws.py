"""A frozen copy of how the program draws its seeded weights, so that the
plain references rebuild them from the seed without taking anything the
program made.

The order and the arithmetic of every draw are those of
``ray_tpu_torch.models.llama.init_llama``, of ``models.moe.init_moe`` and of
the LoRA nudge in ``ray_tpu_torch.serve.llm.LlamaGenerator._adapter`` as they
stand
when this benchmark was written; a change there shows as a failed
comparison, which is what it is."""

from __future__ import annotations

import zlib
from typing import Dict, Sequence

import torch


def trunc_normal(shape, fan_in: float, gen: torch.Generator,
                 device, dtype) -> torch.Tensor:
    """Truncated normal on [-2, 2], scaled by fan_in**-0.5, drawn in fp32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * fan_in ** -0.5).to(dtype)


def llama_shapes(c: Dict[str, int]) -> Dict[str, tuple]:
    h, m = c["hidden"], c["mlp_hidden"]
    nh, nkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return {  # name: (per-layer shape, fan_in), in the order drawn
        "wq": ((h, nh, hd), h), "wk": ((h, nkv, hd), h),
        "wv": ((h, nkv, hd), h), "wo": ((nh, hd, h), nh * hd),
        "w_gate": ((h, m), h), "w_up": ((h, m), h), "w_down": ((m, h), m),
    }


def llama_weights(c: Dict[str, int], seed: int, device,
                  dtype: torch.dtype) -> Dict:
    """The llama params that ``init_llama`` draws from
    ``torch.Generator(device).manual_seed(seed)``, stored in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L, h = c["num_layers"], c["hidden"]
    shapes = llama_shapes(c)
    layers = {n: torch.empty((L,) + s, dtype=dtype, device=device)
              for n, (s, _) in shapes.items()}
    for i in range(L):
        for n, (s, fan_in) in shapes.items():
            layers[n][i] = trunc_normal(s, fan_in, gen, device, dtype)
    embed = trunc_normal((c["vocab_size"], h), 1.0, gen, device, dtype)
    lm_head = trunc_normal((h, c["vocab_size"]), h, gen, device, dtype)
    return {"embed": embed, "layers": layers, "lm_head": lm_head}


def lora_dims(c: Dict[str, int], name: str):
    h, m = c["hidden"], c["mlp_hidden"]
    nh, nkv, hd = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    return {  # (in shape, out shape)
        "wq": ((h,), (nh, hd)), "wk": ((h,), (nkv, hd)),
        "wv": ((h,), (nkv, hd)), "wo": ((nh, hd), (h,)),
        "w_gate": ((h,), (m,)), "w_up": ((h,), (m,)),
        "w_down": ((m,), (h,)),
    }[name]


def served_adapter(c: Dict[str, int], rank: int, targets: Sequence[str],
                   model_id: str, device) -> Dict[str, Dict]:
    """The fp32 LoRA pair of each target that the generator draws for
    ``model_id``: A truncated-normal fan-in, then B nudged to 0.02 x a
    normal draw (``LlamaGenerator._adapter``)."""
    gen = torch.Generator(device=device).manual_seed(
        zlib.crc32(model_id.encode()) & 0x7FFFFFFF)
    L = c["num_layers"]
    out = {}
    for name in targets:
        in_shape, out_shape = lora_dims(c, name)
        fan_in = 1
        for d in in_shape:
            fan_in *= d
        a = trunc_normal((L,) + in_shape + (rank,), float(fan_in), gen,
                         device, torch.float32)
        out[name] = {"a": a, "b": (L, rank) + out_shape}
    for ab in out.values():
        ab["b"] = torch.randn(ab["b"], generator=gen, dtype=torch.float32,
                              device=device) * 0.02
    return out


def moe_weights(c: Dict[str, int], seed: int, device,
                dtype: torch.dtype = torch.float32) -> Dict:
    """The Mixtral-shaped params that ``init_moe`` draws from
    ``torch.Generator(device).manual_seed(seed)`` (as ``create_train_state``
    seeds it), norms included (ones), in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, m, E = c["hidden"], c["mlp_hidden"], c["num_experts"]
    nh, nkv, hd, L = c["num_heads"], c["num_kv_heads"], c["head_dim"], \
        c["num_layers"]
    shapes = {  # name: (per-layer shape, fan_in), in the order drawn
        "wq": ((h, nh, hd), h), "wk": ((h, nkv, hd), h),
        "wv": ((h, nkv, hd), h), "wo": ((nh, hd, h), nh * hd),
        "router": ((h, E), h), "we_gate": ((E, h, m), h),
        "we_up": ((E, h, m), h), "we_down": ((E, m, h), m),
    }
    layers = {n: torch.empty((L,) + s, dtype=dtype, device=device)
              for n, (s, _) in shapes.items()}
    for i in range(L):
        for n, (s, fan_in) in shapes.items():
            layers[n][i] = trunc_normal(s, fan_in, gen, device, dtype)
    layers["attn_norm"] = torch.ones((L, h), dtype=dtype, device=device)
    layers["mlp_norm"] = torch.ones((L, h), dtype=dtype, device=device)
    embed = trunc_normal((c["vocab_size"], h), h, gen, device, dtype)
    lm_head = trunc_normal((h, c["vocab_size"]), h, gen, device, dtype)
    return {"embed": embed, "layers": layers,
            "final_norm": torch.ones((h,), dtype=dtype, device=device),
            "lm_head": lm_head}
