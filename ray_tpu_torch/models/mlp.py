"""Tiny MLP family: the test and bench workhorse of the models.

Port of ``ray_tpu/models/mlp.py``: params are a dictionary of tensors in the
reference's layout (the hidden layers stacked, ``w_hidden`` [n, hidden,
hidden]), the forward a function of (params, x). The reference's
``lax.scan`` over the hidden layers is a Python loop here.

Not ported: ``mlp_logical_axes``, which waits for the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ray_tpu_torch._private.tree import tree_from_numpy

_KEYS = frozenset({"w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out"})


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 512
    out_dim: int = 10
    num_layers: int = 2
    dtype: torch.dtype = torch.float32


def init_mlp(cfg: MLPConfig, generator: torch.Generator,
             device: torch.device) -> Dict[str, Any]:
    """Normal weights scaled by fan_in**-0.5, zero biases, in
    ``cfg.dtype``; ``num_layers - 2`` hidden layers (at least 0)."""
    n_hid = max(cfg.num_layers - 2, 0)

    def normal(shape, fan_in):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=cfg.dtype) * fan_in ** -0.5

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=cfg.dtype)

    return {
        "w_in": normal((cfg.in_dim, cfg.hidden), cfg.in_dim),
        "b_in": zeros((cfg.hidden,)),
        "w_hidden": normal((n_hid, cfg.hidden, cfg.hidden), cfg.hidden),
        "b_hidden": zeros((n_hid, cfg.hidden)),
        "w_out": normal((cfg.hidden, cfg.out_dim), cfg.hidden),
        "b_out": zeros((cfg.out_dim,)),
    }


def mlp_params_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's MLP params, as numpy arrays, as this port's CPU
    tensors. The layouts are the same, so this only converts."""
    if set(tree) != _KEYS:
        raise ValueError(f"not an MLP param tree: keys {sorted(tree)}")
    return tree_from_numpy(tree)


def mlp_forward(params: Dict[str, Any], x: torch.Tensor,
                cfg: MLPConfig) -> torch.Tensor:
    """x [B, in_dim] → logits [B, out_dim]: ReLU after every layer but the
    last."""
    del cfg  # the shapes are the params'
    h = torch.relu(x @ params["w_in"] + params["b_in"])
    for w, b in zip(params["w_hidden"], params["b_hidden"]):
        h = torch.relu(h @ w + b)
    return h @ params["w_out"] + params["b_out"]


def mlp_loss(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             cfg: MLPConfig) -> torch.Tensor:
    """Mean cross-entropy of ``batch["x"]``'s logits against the integer
    labels ``batch["y"]``."""
    logp = torch.log_softmax(mlp_forward(params, batch["x"], cfg), dim=-1)
    return -logp.gather(-1, batch["y"][:, None].long()).mean()
