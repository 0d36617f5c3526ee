"""Model catalog: CNN and RNN modules beyond the default MLP.

Port of ``ray_tpu/rllib/models/catalog.py``. The modules keep the functional
RLModule contract (params are a tree, ``forward(params, obs)`` a function of
them). Images are NHWC and conv kernels HWIO, as in the JAX package; the
convolutions run as ``F.conv2d`` on NCHW views of them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.rllib.core.rl_module import (
    Categorical, DiagGaussian, mlp_forward, mlp_params)

# (out_channels, kernel, stride): the default vision net for 84x84-ish
# inputs; smaller images get shallower stacks
DEFAULT_CONV_FILTERS = ((16, 4, 2), (32, 4, 2), (64, 3, 2))


def default_filters_for(obs_shape) -> tuple:
    side = min(obs_shape[0], obs_shape[1])
    if side >= 36:
        return DEFAULT_CONV_FILTERS
    if side >= 10:
        return ((16, 4, 2), (32, 3, 2))
    return ((16, 3, 1),)


def _randn(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


class ConvModule:
    """Vision policy/value net: a shared conv torso, separate heads."""

    def __init__(self, spec):
        self.spec = spec
        self.dist = Categorical if spec.discrete else DiagGaussian
        self._act = torch.relu
        self._obs_shape = tuple(spec.obs_shape)  # (H, W, C)
        self._filters = tuple(getattr(spec, "conv_filters", None)
                              or default_filters_for(self._obs_shape))
        self._out_dim = (spec.action_dim if spec.discrete
                         else 2 * spec.action_dim)
        if self._torso_out_dim() <= 0:
            raise ValueError(
                f"conv_filters {self._filters} collapse obs_shape "
                f"{self._obs_shape} to zero spatial extent; pass smaller "
                "kernels/strides via RLModuleSpec.conv_filters")

    def init(self, generator: torch.Generator) -> Dict:
        params: Dict = {"conv": []}
        in_c = self._obs_shape[-1]
        dev = generator.device
        for out_c, k, _s in self._filters:
            fan_in = k * k * in_c
            params["conv"].append({
                "w": _randn(generator, (k, k, in_c, out_c))
                * math.sqrt(2.0 / fan_in),
                "b": torch.zeros((out_c,), device=dev)})
            in_c = out_c
        flat = self._torso_out_dim()
        params["pi"] = mlp_params(generator, (flat, 256, self._out_dim))
        params["vf"] = mlp_params(generator, (flat, 256, 1), final_scale=1.0)
        return params

    def _torso_out_dim(self) -> int:
        h, w, _ = self._obs_shape
        for _c, k, s in self._filters:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
        return h * w * self._filters[-1][0]

    def _torso(self, params, obs):
        x = obs
        if x.dim() == len(self._obs_shape):  # add the batch dim
            x = x[None]
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        for layer, (_c, _k, stride) in zip(params["conv"], self._filters):
            w = layer["w"].permute(3, 2, 0, 1)  # HWIO -> OIHW
            x = self._act(F.conv2d(x, w, layer["b"], stride=stride))
        # flatten in NHWC order, as the JAX package's reshape does
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        squeeze = obs.dim() == len(self._obs_shape)
        feats = self._torso(params, obs)
        logits = mlp_forward(params["pi"], feats, self._act)
        vf = mlp_forward(params["vf"], feats, self._act)[..., 0]
        if squeeze:
            logits, vf = logits[0], vf[0]
        return {"logits": logits, "vf": vf}

    def explore_action(self, params, obs, generator: torch.Generator):
        out = self.forward(params, obs)
        action = self.dist.sample(generator, out["logits"])
        logp = self.dist.logp(out["logits"], action)
        return action, logp, out["vf"]


class LSTMModule:
    """Recurrent policy/value net: MLP encoder -> LSTM cell -> heads.

    ``forward_recurrent(params, obs_seq, state)`` runs a [T, B, obs]
    sequence carrying (h, c); ``initial_state(batch)`` builds zeros.
    ``forward(params, obs)`` is the stateless facade env runners use (zero
    state per call)."""

    def __init__(self, spec):
        self.spec = spec
        self.dist = Categorical if spec.discrete else DiagGaussian
        self._act = torch.tanh
        self.cell_size = int(getattr(spec, "lstm_cell_size", 64) or 64)
        self._out_dim = (spec.action_dim if spec.discrete
                         else 2 * spec.action_dim)

    def init(self, generator: torch.Generator) -> Dict:
        enc_sizes = (self.spec.obs_dim, *self.spec.hiddens)
        H, E = self.cell_size, enc_sizes[-1]
        scale = math.sqrt(1.0 / (E + H))
        return {
            "enc": mlp_params(generator, enc_sizes, final_scale=1.0),
            "lstm": {
                "wx": _randn(generator, (E, 4 * H)) * scale,
                "wh": _randn(generator, (H, 4 * H)) * scale,
                "b": torch.zeros((4 * H,), device=generator.device),
            },
            "pi": mlp_params(generator, (H, self._out_dim)),
            "vf": mlp_params(generator, (H, 1), final_scale=1.0),
        }

    def initial_state(self, batch_size: int, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero (h, c) on ``device`` (None: the CPU)."""
        return (torch.zeros((batch_size, self.cell_size), device=device),
                torch.zeros((batch_size, self.cell_size), device=device))

    def _encode(self, params, obs):
        x = obs
        for layer in params["enc"]:
            x = self._act(x @ layer["w"] + layer["b"])
        return x

    def _cell(self, params, x, state):
        h, c = state
        gates = (x @ params["lstm"]["wx"] + h @ params["lstm"]["wh"]
                 + params["lstm"]["b"])
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    def _heads(self, params, h):
        logits = mlp_forward(params["pi"], h, self._act)
        vf = mlp_forward(params["vf"], h, self._act)[..., 0]
        return {"logits": logits, "vf": vf}

    def forward_recurrent(self, params, obs_seq, state):
        """obs_seq [T, B, obs_dim] -> ({logits, vf}: [T, B, ...], the final
        state)."""
        enc = self._encode(params, obs_seq)
        hs = []
        for x in enc.unbind(0):
            h, state = self._cell(params, x, state)
            hs.append(h)
        return self._heads(params, torch.stack(hs)), state

    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        squeeze = obs.dim() == 1
        x = obs[None] if squeeze else obs
        enc = self._encode(params, x)
        h, _ = self._cell(params, enc,
                          self.initial_state(x.shape[0], x.device))
        out = self._heads(params, h)
        if squeeze:
            out = {k: v[0] for k, v in out.items()}
        return out

    def explore_action(self, params, obs, generator: torch.Generator):
        out = self.forward(params, obs)
        action = self.dist.sample(generator, out["logits"])
        logp = self.dist.logp(out["logits"], action)
        return action, logp, out["vf"]


def get_module_for_space(spec):
    """Catalog dispatch: image obs -> ConvModule, use_lstm -> LSTMModule,
    else the default MLP."""
    from ray_tpu_torch.rllib.core.rl_module import MLPModule

    is_image = bool(getattr(spec, "conv_filters", None)) or \
        len(getattr(spec, "obs_shape", ()) or ()) == 3
    use_lstm = bool(getattr(spec, "use_lstm", False))
    if is_image and use_lstm:
        raise ValueError(
            "conv+lstm composition is not supported yet; pick "
            "conv_filters/obs_shape OR use_lstm")
    if is_image:
        if getattr(spec, "obs_shape", None) is None or \
                len(spec.obs_shape) != 3:
            raise ValueError(
                "conv_filters requires obs_shape=(H, W, C) on the spec")
        return ConvModule(spec)
    if use_lstm:
        return LSTMModule(spec)
    return MLPModule(spec)


__all__ = ["ConvModule", "DEFAULT_CONV_FILTERS", "LSTMModule",
           "default_filters_for", "get_module_for_space"]
