# Ported from ray_tpu/rllib/algorithms/a2c/a2c.py (ray_tpu -> ray_tpu_torch).
"""A2C — synchronous advantage actor-critic (reference:
rllib/algorithms/a2c/a2c.py, externalized to rllib_contrib in the snapshot:
one on-policy gradient step per sampled batch, no surrogate clipping, no
minibatch epochs — the degenerate PPO with num_epochs=1 and no ratio).
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.learner import Learner


class A2CLearner(Learner):
    """Vanilla policy-gradient on GAE advantages (reference:
    a2c loss = pg + vf_coeff * vf - entropy_coeff * entropy)."""

    def loss(self, params, batch):
        cfg = self.config
        out = self.module.forward(params, batch["obs"])
        dist = self.module.dist
        logp = dist.logp(out["logits"], batch["actions"])
        adv = batch["advantages"]
        # the population std, as jnp.std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pi_loss = -torch.mean(logp * adv)
        vf_loss = torch.mean((out["vf"] - batch["value_targets"]) ** 2)
        entropy = torch.mean(dist.entropy(out["logits"]))
        total = (pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.01) * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}


class A2CConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or A2C)
        self.entropy_coeff = 0.01
        self.num_epochs = 1          # single pass: stay on-policy
        self.minibatch_size = None   # whole batch per update
        self.train_batch_size = 512


class A2C(PPO):
    """Sampling + GAE postprocessing are PPO's; only the loss differs."""

    learner_cls = A2CLearner

    @classmethod
    def get_default_config(cls):
        return A2CConfig(algo_class=cls)
