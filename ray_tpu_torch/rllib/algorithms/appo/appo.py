# Ported from ray_tpu/rllib/algorithms/appo/appo.py (ray_tpu -> ray_tpu_torch).
"""APPO — asynchronous PPO (reference: rllib/algorithms/appo/appo.py:
IMPALA's async actor-learner architecture + PPO's clipped surrogate, with
V-trace correcting the off-policyness of in-flight fragments).

Inherits IMPALA's always-one-sample-in-flight loop; the learner swaps the
plain policy-gradient for the clipped-ratio surrogate on V-trace
advantages (reference: appo/torch/appo_torch_learner.py).
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithms.impala.impala import (
    IMPALA, IMPALAConfig, ImpalaLearner)
from ray_tpu_torch.rllib.utils.vtrace import vtrace


class APPOLearner(ImpalaLearner):
    def loss(self, params, batch):
        cfg = self.config
        tT = lambda a: a.transpose(0, 1)
        obs, actions = tT(batch["obs"]), tT(batch["actions"])
        behavior_logp = tT(batch["logp"])
        out = self.module.forward(params, obs)
        dist = self.module.dist
        target_logp = dist.logp(out["logits"], actions)
        vs, pg_adv = vtrace(
            behavior_logp, target_logp, tT(batch["rewards"]), out["vf"],
            tT(batch["dones"]), batch["bootstrap"],
            gamma=cfg.get("gamma", 0.99),
            clip_rho=cfg.get("vtrace_clip_rho_threshold", 1.0),
            clip_c=cfg.get("vtrace_clip_c_threshold", 1.0))
        mask = tT(batch["valid"])
        denom = torch.clamp(mask.sum(), min=1.0)
        clip = cfg.get("clip_param", 0.2)
        ratio = torch.exp(target_logp - behavior_logp)
        surrogate = torch.minimum(
            ratio * pg_adv, torch.clamp(ratio, 1 - clip, 1 + clip) * pg_adv)
        pi_loss = -torch.sum(surrogate * mask) / denom
        vf_loss = 0.5 * torch.sum((out["vf"] - vs) ** 2 * mask) / denom
        entropy = torch.sum(dist.entropy(out["logits"]) * mask) / denom
        kl = torch.sum((behavior_logp - target_logp) * mask) / denom
        total = (pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.01) * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "mean_kl": kl}


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or APPO)
        self.clip_param = 0.2

    def _training_keys(self):
        return super()._training_keys() | {"clip_param"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d["clip_param"] = self.clip_param
        return d


class APPO(IMPALA):
    learner_cls = APPOLearner

    @classmethod
    def get_default_config(cls):
        return APPOConfig(algo_class=cls)
