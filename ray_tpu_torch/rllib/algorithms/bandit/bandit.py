# Ported from ray_tpu/rllib/algorithms/bandit/bandit.py (ray_tpu -> ray_tpu_torch).
"""Contextual bandits — LinUCB and Linear Thompson Sampling (reference:
rllib/algorithms/bandit/bandit.py BanditLinUCB/BanditLinTS +
bandit_torch_model.py; Li et al. 2010, Agrawal & Goyal 2013).

Per-arm Bayesian linear regression over the context: A_a = I·λ + Σ x xᵀ,
b_a = Σ r x. LinUCB picks argmax xᵀθ_a + α·sqrt(xᵀ A_a⁻¹ x); LinTS
samples θ̃_a ~ N(θ_a, v² A_a⁻¹) and picks argmax xᵀθ̃_a. Exact conjugate
updates — no gradients, no replay; the per-step work is a handful of
small matrix ops batched over arms (``torch.linalg``'s batched solve,
inverse and Cholesky) on the learners' device (``learners(device=)``;
None: the CUDA card). ``A`` and ``b`` are fp32, as the JAX package's are.
LinTS's standard-normal draws come from the algorithm's
``torch.Generator`` on that device, made before ``_choose`` uses them.

Env protocol: an env whose episodes are one step long — obs is the
context, action the arm, reward the payoff (the reference wraps the same
contract in ParametricItemRecoEnv et al.).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig


class _LinearBanditState:
    """Stacked per-arm A (precision), b — updated exactly per pull."""

    def __init__(self, n_arms: int, dim: int, lam: float = 1.0,
                 device: Optional[torch.device] = None):
        self.n_arms = n_arms
        self.dim = dim
        self.A = torch.eye(dim, device=device)[None].repeat(
            n_arms, 1, 1) * lam
        self.b = torch.zeros((n_arms, dim), device=device)

    def update(self, arm: int, x: torch.Tensor, reward: float) -> None:
        self.A[arm] += torch.outer(x, x)
        self.b[arm] += reward * x

    def thetas(self) -> torch.Tensor:
        return torch.linalg.solve(self.A, self.b)  # [arms, dim]

    def inv(self) -> torch.Tensor:
        return torch.linalg.inv(self.A)


class _BanditConfigBase(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class)
        self.lambda_reg = 1.0
        self.num_env_steps_per_iter = 64

    def _training_keys(self):
        return {"lambda_reg", "num_env_steps_per_iter", "alpha", "v"}


class BanditLinUCBConfig(_BanditConfigBase):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BanditLinUCB)
        self.alpha = 1.0  # exploration bonus scale


class BanditLinTSConfig(_BanditConfigBase):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BanditLinTS)
        self.v = 0.5      # posterior scale


class _BanditAlgorithm(Algorithm):
    """Shared driver: one-step episodes against the env."""

    def __init__(self, config):
        # bypass Algorithm.__init__'s env-runner/learner-group setup:
        # bandits are closed-form, no learner group (the QMIX pattern)
        self.config = config
        self.setup(config)

    def setup(self, _config) -> None:
        cfg = self.config
        self.device = resolve_device(cfg.learner_device)
        self._env = cfg.make_env()()
        self.n_arms = int(self._env.action_space.n)
        self.dim = int(np.prod(self._env.observation_space.shape))
        self.state = _LinearBanditState(self.n_arms, self.dim,
                                        lam=cfg.lambda_reg,
                                        device=self.device)
        self._rng = np.random.default_rng(cfg.seed)
        self._gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self._total_env_steps = 0
        self._rewards: List[float] = []
        self._iteration = 0

    def _draws(self) -> Optional[torch.Tensor]:
        """The random draws one ``_choose`` takes (none for LinUCB)."""
        return None

    def _choose(self, x: torch.Tensor, draws=None) -> int:
        raise NotImplementedError

    def training_step(self) -> Dict:
        cfg = self.config
        for _ in range(cfg.num_env_steps_per_iter):
            obs, _ = self._env.reset(seed=int(self._rng.integers(1e9)))
            x = torch.as_tensor(np.asarray(obs, np.float32).reshape(-1),
                                device=self.device)
            arm = self._choose(x, self._draws())
            _, reward, *_ = self._env.step(arm)
            self.state.update(arm, x, float(reward))
            self._rewards.append(float(reward))
            self._total_env_steps += 1
        window = self._rewards[-500:]
        return {"env_steps_this_iter": cfg.num_env_steps_per_iter,
                "episode_return_mean": float(np.mean(window)),
                "num_env_steps_sampled_lifetime": self._total_env_steps}

    def train(self) -> Dict:
        self._iteration += 1
        out = self.training_step()
        out["training_iteration"] = self._iteration
        return out

    def stop(self) -> None:
        try:
            self._env.close()
        except Exception:
            pass


class BanditLinUCB(_BanditAlgorithm):
    @classmethod
    def get_default_config(cls):
        return BanditLinUCBConfig(algo_class=cls)

    def _choose(self, x: torch.Tensor, draws=None) -> int:
        alpha = self.config.alpha
        thetas = self.state.thetas()
        Ainv = self.state.inv()
        mean = thetas @ x
        widths = torch.sqrt(torch.einsum("i,aij,j->a", x, Ainv, x))
        return int(torch.argmax(mean + alpha * widths))


class BanditLinTS(_BanditAlgorithm):
    @classmethod
    def get_default_config(cls):
        return BanditLinTSConfig(algo_class=cls)

    def _draws(self) -> torch.Tensor:
        """One standard normal per arm and context dim."""
        return torch.randn((self.n_arms, self.dim), generator=self._gen,
                           device=self.device)

    def _choose(self, x: torch.Tensor, draws=None) -> int:
        v = self.config.v
        thetas = self.state.thetas()
        Ainv = self.state.inv()
        noise = torch.as_tensor(draws, device=self.device)
        # sample from N(theta, v^2 A^-1) via cholesky of each arm's cov
        chol = torch.linalg.cholesky(Ainv)
        samples = thetas + v * torch.einsum("aij,aj->ai", chol, noise)
        return int(torch.argmax(samples @ x))
