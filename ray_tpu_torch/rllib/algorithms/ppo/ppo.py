# Ported from ray_tpu/rllib/algorithms/ppo/ppo.py (ray_tpu -> ray_tpu_torch).
"""PPO (reference: rllib/algorithms/ppo/ppo.py — PPOConfig + PPO; the
training_step mirrors the new-stack flow: sample fragments from env
runners → GAE → LearnerGroup minibatch-SGD → sync weights).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import PPOLearner
from ray_tpu_torch.rllib.utils.gae import compute_gae


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or PPO)
        # PPO-specific knobs (reference: ppo.py PPOConfig.training)
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.use_gae = True

    def _training_keys(self):
        return {"lambda_", "clip_param", "vf_clip_param", "vf_loss_coeff",
                "entropy_coeff", "use_gae"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d.update({
            "clip_param": self.clip_param,
            "vf_clip_param": self.vf_clip_param,
            "vf_loss_coeff": self.vf_loss_coeff,
            "entropy_coeff": self.entropy_coeff,
        })
        return d


class PPO(Algorithm):
    learner_cls = PPOLearner

    @classmethod
    def get_default_config(cls):
        return PPOConfig(algo_class=cls)

    def training_step(self) -> Dict:
        cfg = self.config
        weights = self.learner_group.get_weights()
        weights_ref = ray_tpu_torch.put(weights)

        samples = []
        env_steps = 0
        while env_steps < cfg.train_batch_size:
            batch_parts = self._sample_from_runners(weights_ref)
            samples.extend(batch_parts)
            env_steps += sum(s["env_steps"] for s in batch_parts)
            if not batch_parts:
                break

        train_batch = self._postprocess(samples)
        metrics = self.learner_group.update(train_batch)
        metrics["env_steps_this_iter"] = env_steps
        return metrics

    def _postprocess(self, samples) -> Dict[str, np.ndarray]:
        """GAE per fragment, then flatten (T, E) → rows."""
        cfg = self.config
        parts = {k: [] for k in
                 ("obs", "actions", "logp", "advantages", "value_targets")}
        for s in samples:
            adv, vt = compute_gae(
                s["rewards"], s["vf"], s["dones"], s["last_vf"],
                gamma=cfg.gamma, lam=cfg.lambda_)
            flat = lambda a: a.reshape((-1,) + a.shape[2:])
            # drop autoreset transitions (gymnasium next-step autoreset:
            # the action there was ignored by the env)
            mask = flat(s["valid"])
            parts["obs"].append(flat(s["obs"])[mask])
            parts["actions"].append(flat(s["actions"])[mask])
            parts["logp"].append(flat(s["logp"])[mask])
            parts["advantages"].append(flat(adv)[mask])
            parts["value_targets"].append(flat(vt)[mask])
        return {k: np.concatenate(v) for k, v in parts.items()}
