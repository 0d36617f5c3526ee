# Ported from ray_tpu/rllib/algorithms/crr/crr.py (ray_tpu -> ray_tpu_torch).
"""CRR — critic-regularized regression for offline RL (reference:
rllib/algorithms/crr/ (torch), Wang 2020: behavior cloning weighted by a
critic's advantage estimate, so the policy only imitates dataset actions
the learned Q-function endorses).

Rides CQL's offline scaffolding (JSONL reader, no env runners) with a
different learner on the same SAC module: the critic is a plain
entropy-free twin-Q TD step, and the actor loss is
``-E[w(A) * log pi(a_data | s)]`` with ``A = min_q Q(s, a_data) -
mean_{a'~pi} min_q Q(s, a')`` and ``w`` either ``1[A >= 0]`` ("binary")
or ``clip(exp(A / beta), w_max)`` ("exp"). The m policy samples are draws
the learner's ``torch.Generator`` makes before the loss.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithms.cql.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.sac.sac import SACLearner


class CRRLearner(SACLearner):
    def _draws(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The target action's standard-normal draw at next_obs and the
        ``crr_n_actions`` policy samples' at obs."""
        m = self.config.get("crr_n_actions", 4)
        a = self.module.spec.action_dim
        return {"next": self._randn(batch_size, a),
                "pi_m": self._randn(m, batch_size, a)}

    def _losses(self, params, target_params, batch, draws):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        obs = batch["obs"]
        # ---- critic: entropy-free TD onto twin-min at a' ~ pi(s')
        with torch.no_grad():
            next_a, _, _ = self.module.pi(params, batch["next_obs"],
                                          draws["next"])
            tq1, tq2 = self.module.q(
                {**params, "q1": target_params["q1"],
                 "q2": target_params["q2"]},
                batch["next_obs"], next_a)
            target = batch["rewards"] + gamma * (1 - batch["dones"]) * \
                torch.minimum(tq1, tq2)
        q1, q2 = self.module.q(params, obs, batch["actions"])
        critic_loss = torch.mean((q1 - target) ** 2) + \
            torch.mean((q2 - target) ** 2)
        # ---- advantage of the DATA action vs the policy's own value
        with torch.no_grad():
            m = draws["pi_m"].shape[0]
            obs_m = obs.expand(m, *obs.shape)
            sampled = self.module.pi(params, obs_m, draws["pi_m"])[0]
            q_pi = torch.minimum(*self.module.q(params, obs_m, sampled))
            adv = torch.minimum(q1, q2) - q_pi.mean(0)
            if cfg.get("crr_weight_type", "exp") == "binary":
                w = (adv >= 0.0).float()
            else:
                beta = cfg.get("crr_beta", 1.0)
                w = torch.clamp(torch.exp(adv / beta), 0.0,
                                cfg.get("crr_w_max", 20.0))
        logp_data = self.module.logp(params, obs, batch["actions"])
        actor_loss = -torch.mean(w * logp_data)
        total = critic_loss + actor_loss
        return total, {
            "critic_loss": critic_loss, "actor_loss": actor_loss,
            "advantage_mean": torch.mean(adv), "weight_mean": torch.mean(w),
            "qf_mean": torch.mean(q1), "logp_data": torch.mean(logp_data),
        }


class CRRConfig(CQLConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or CRR)
        self.crr_weight_type = "exp"   # "exp" | "binary"
        self.crr_beta = 1.0
        self.crr_n_actions = 4
        self.crr_w_max = 20.0

    def _training_keys(self):
        return super()._training_keys() | {
            "crr_weight_type", "crr_beta", "crr_n_actions", "crr_w_max"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d.update({"crr_weight_type": self.crr_weight_type,
                  "crr_beta": self.crr_beta,
                  "crr_n_actions": self.crr_n_actions,
                  "crr_w_max": self.crr_w_max})
        return d


class CRR(CQL):
    learner_cls = CRRLearner

    @classmethod
    def get_default_config(cls):
        return CRRConfig(algo_class=cls)
