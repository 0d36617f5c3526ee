# Ported from ray_tpu/rllib/algorithms/marwil/marwil.py (ray_tpu -> ray_tpu_torch).
"""MARWIL — monotonic advantage re-weighted imitation learning (reference:
rllib/algorithms/marwil/marwil.py + marwil_torch_learner: exponentially
advantage-weighted behavior cloning plus a value branch; beta=0 degrades to
plain BC).

Offline data must carry per-transition ``rewards`` and ``dones`` so
monte-carlo returns can be computed per logged episode; the value tower
regresses those returns and the BC term is weighted by
``exp(beta * (R - V) / c)`` with c a running scale of the advantage
magnitude (reference keeps a moving average; one dataset-wide scale here —
the dataset is static).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.bc.bc import BC, BCConfig
from ray_tpu_torch.rllib.core.learner import Learner


def monte_carlo_returns(rewards: np.ndarray, dones: np.ndarray,
                        gamma: float) -> np.ndarray:
    """Discounted reward-to-go within episode boundaries (row-ordered
    logged transitions; a done cuts the accumulation)."""
    returns = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = rewards[t] + gamma * acc
        returns[t] = acc
    return returns


class MARWILLearner(Learner):
    def loss(self, params, batch):
        cfg = self.config
        beta = cfg.get("beta", 1.0)
        out = self.module.forward(params, batch["obs"])
        logp = self.module.dist.logp(out["logits"], batch["actions"])
        returns = batch["returns"]
        vf_loss = torch.mean((out["vf"] - returns) ** 2)
        with torch.no_grad():
            adv = returns - out["vf"]
            # scale-normalized exponential weights, clipped for stability
            c = torch.sqrt(torch.mean(adv ** 2) + 1e-8)
            weights = torch.exp(torch.clamp(beta * adv / c, -5.0, 5.0))
        bc_loss = -torch.mean(weights * logp)
        entropy = torch.mean(self.module.dist.entropy(out["logits"]))
        total = bc_loss + cfg.get("vf_coeff", 1.0) * vf_loss
        return total, {"bc_loss": bc_loss, "vf_loss": vf_loss,
                       "entropy": entropy,
                       "mean_weight": torch.mean(weights)}


class MARWILConfig(BCConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MARWIL)
        self.beta = 1.0
        self.vf_coeff = 1.0

    def _training_keys(self):
        return super()._training_keys() | {"beta", "vf_coeff"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d.update({"beta": self.beta, "vf_coeff": self.vf_coeff})
        return d


class MARWIL(BC):
    learner_cls = MARWILLearner

    @classmethod
    def get_default_config(cls):
        return MARWILConfig(algo_class=cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        full = self.reader.concat_all()
        if "rewards" not in full or "dones" not in full:
            raise ValueError(
                "MARWIL offline data needs 'rewards' and 'dones' columns "
                "to compute monte-carlo returns (got: "
                f"{sorted(full.keys())})")
        self._returns = monte_carlo_returns(
            np.asarray(full["rewards"], np.float32),
            np.asarray(full["dones"]), self.config.gamma)
        self._full = full

    def training_step(self) -> Dict:
        cfg = self.config
        n = len(self._full["obs"])
        steps = max(1, int(cfg.dataset_epochs_per_iter * n
                           / cfg.train_batch_size))
        rng = np.random.default_rng(cfg.seed + self.iteration)
        metrics: Dict = {}
        for _ in range(steps):
            idx = rng.integers(0, n, cfg.train_batch_size)
            metrics = self.learner_group.update({
                "obs": self._full["obs"][idx].astype(np.float32),
                "actions": self._full["actions"][idx],
                "returns": self._returns[idx],
            })
        metrics["env_steps_this_iter"] = 0
        metrics["dataset_rows"] = n
        return metrics
