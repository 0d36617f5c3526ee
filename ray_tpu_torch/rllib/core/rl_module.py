"""RLModule: the model abstraction of the RL learners.

Port of ``ray_tpu/rllib/core/rl_module.py``. It keeps the JAX package's
functional contract: a module's params are a tree of tensors (dicts and
lists), ``init(generator)`` draws them, and ``forward(params, obs)`` is a
function of (params, obs), so the same module runs in a learner, on a mesh
(its params DTensors) and in an env runner. Sampling takes an explicit
``torch.Generator`` where the JAX package takes a key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


# ------------------------------------------------------------ distributions
class Categorical:
    """Action distribution over discrete logits."""

    @staticmethod
    def sample(generator: torch.Generator, logits: torch.Tensor
               ) -> torch.Tensor:
        probs = torch.softmax(logits.float(), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator).reshape(
            probs.shape[:-1])

    @staticmethod
    def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        logps = torch.log_softmax(logits, dim=-1)
        return logps.gather(-1, actions[..., None].long())[..., 0]

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        logps = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logps) * logps, dim=-1)


class DiagGaussian:
    """Squash-free diagonal Gaussian for continuous actions; logits =
    concat(mean, log_std)."""

    @staticmethod
    def split(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, log_std = torch.chunk(logits, 2, dim=-1)
        return mean, torch.clamp(log_std, -20.0, 2.0)

    @staticmethod
    def sample(generator: torch.Generator, logits: torch.Tensor
               ) -> torch.Tensor:
        mean, log_std = DiagGaussian.split(logits)
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=mean.dtype, device=mean.device)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        mean, log_std = DiagGaussian.split(logits)
        var = torch.exp(2 * log_std)
        return torch.sum(
            -0.5 * ((actions - mean) ** 2 / var)
            - log_std - 0.5 * math.log(2 * math.pi), dim=-1)

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        _, log_std = DiagGaussian.split(logits)
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)


# ----------------------------------------------------------------- RLModule
@dataclasses.dataclass
class RLModuleSpec:
    """The module's spaces and the catalog's choices (the JAX package's
    ``RLModuleSpec``, field for field)."""

    obs_dim: int
    action_dim: int
    discrete: bool = True
    hiddens: Tuple[int, ...] = (64, 64)
    activation: str = "tanh"
    obs_shape: Optional[Tuple[int, ...]] = None  # (H, W, C) -> ConvModule
    conv_filters: Optional[Tuple] = None         # ((out, kernel, stride),)
    use_lstm: bool = False                       # -> LSTMModule
    lstm_cell_size: int = 64

    def build(self):
        from ray_tpu_torch.rllib.models.catalog import get_module_for_space

        return get_module_for_space(self)


def _randn(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def mlp_params(generator: torch.Generator, sizes, final_scale: float = 0.01):
    """Dense layers ``sizes[i] -> sizes[i+1]``: He-normal weights
    (sqrt(2 / fan_in)), the last scaled by ``final_scale`` (a near-uniform
    initial policy), zero biases."""
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = math.sqrt(2.0 / a)
        if i == len(sizes) - 2:
            scale = scale * final_scale
        layers.append({"w": _randn(generator, (a, b)) * scale,
                       "b": torch.zeros((b,), device=generator.device)})
    return layers


def mlp_forward(layers, x, act):
    for layer in layers[:-1]:
        x = act(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return x @ last["w"] + last["b"]


ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


class MLPModule:
    """Separate policy and value MLP towers (the default model)."""

    def __init__(self, spec: RLModuleSpec):
        self.spec = spec
        self.dist = Categorical if spec.discrete else DiagGaussian
        self._act = ACTIVATIONS[spec.activation]
        self._out_dim = (spec.action_dim if spec.discrete
                         else 2 * spec.action_dim)

    def init(self, generator: torch.Generator) -> Dict:
        sizes = (self.spec.obs_dim, *self.spec.hiddens)
        return {"pi": mlp_params(generator, sizes + (self._out_dim,)),
                "vf": mlp_params(generator, sizes + (1,))}

    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        """Action logits and the value estimate."""
        logits = mlp_forward(params["pi"], obs, self._act)
        vf = mlp_forward(params["vf"], obs, self._act)[..., 0]
        return {"logits": logits, "vf": vf}

    def explore_action(self, params, obs, generator: torch.Generator):
        """Sample an action, its logp and the value: the env runner's
        inference path."""
        out = self.forward(params, obs)
        action = self.dist.sample(generator, out["logits"])
        logp = self.dist.logp(out["logits"], action)
        return action, logp, out["vf"]


def rl_params_from_jax(tree: Any) -> Any:
    """An RL module's params from the JAX package (nested dicts and lists
    of numpy arrays, ``jax.tree.map(np.asarray, params)`` done by the
    caller) as CPU tensors in the same layout."""
    if isinstance(tree, dict):
        return {k: rl_params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rl_params_from_jax(v) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True))


__all__ = ["ACTIVATIONS", "Categorical", "DiagGaussian", "MLPModule",
           "RLModuleSpec", "mlp_forward", "mlp_params", "rl_params_from_jax"]
