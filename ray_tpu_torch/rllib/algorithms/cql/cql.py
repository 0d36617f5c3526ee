# Ported from ray_tpu/rllib/algorithms/cql/cql.py (ray_tpu -> ray_tpu_torch).
"""CQL — conservative Q-learning for offline RL (reference:
rllib/algorithms/cql/cql.py + cql_torch_learner: SAC machinery plus a
conservative penalty pushing Q down on out-of-distribution actions and up
on dataset actions; Kumar 2020, the CQL(H) variant).

Data source is logged JSONL transitions (offline/json_io.py) with
``obs, actions, rewards, next_obs, dones``; there are no env runners. The
penalty's uniform and policy proposals are draws the learner's
``torch.Generator`` makes before the loss, beside SAC's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.sac.sac import (
    SACConfig, SACLearner, SACModuleSpec)
from ray_tpu_torch.rllib.core.rl_module import mlp_forward
from ray_tpu_torch.rllib.offline import JsonReader


class CQLLearner(SACLearner):
    def _draws(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """SAC's draws, the uniform proposals in [-1, 1) and the policy's
        standard-normal draws at obs and at next_obs, ``cql_n_actions`` of
        each."""
        n = self.config.get("cql_n_actions", 4)
        a = self.module.spec.action_dim
        draws = super()._draws(batch_size)
        draws["rand"] = torch.rand((n, batch_size, a), generator=self._gen,
                                   device=self.device) * 2.0 - 1.0
        draws["pi_n"] = self._randn(n, batch_size, a)
        draws["next_n"] = self._randn(n, batch_size, a)
        return draws

    def _losses(self, params, target_params, batch, draws):
        total, metrics = super()._losses(params, target_params, batch,
                                         draws)
        cfg = self.config
        cql_alpha = cfg.get("cql_alpha", 1.0)
        obs, next_obs = batch["obs"], batch["next_obs"]
        n = draws["rand"].shape[0]
        act_dim = self.module.spec.action_dim
        log_unif = -act_dim * math.log(2.0)  # density of U[-1,1]^d
        # current-policy proposals at s and s' (importance-corrected), one
        # set of draws a proposal: the obs broadcast over the n proposals
        obs_n = obs.expand(n, *obs.shape)
        next_obs_n = next_obs.expand(n, *next_obs.shape)
        pi_a, pi_logp, _ = self.module.pi(params, obs_n, draws["pi_n"])
        nxt_a, nxt_logp, _ = self.module.pi(params, next_obs_n,
                                            draws["next_n"])

        def cat_q(q_key):
            def q_of(a, o):
                x = torch.cat([o, a], dim=-1)
                return mlp_forward(params[q_key], x,
                                   self.module._act)[..., 0]

            q_rand = q_of(draws["rand"], obs_n) - log_unif
            q_pi = q_of(pi_a, obs_n) - pi_logp.detach()
            q_nxt = q_of(nxt_a, next_obs_n) - nxt_logp.detach()
            cat = torch.cat([q_rand, q_pi, q_nxt], dim=0)
            return torch.logsumexp(cat, dim=0)

        q1_data, q2_data = self.module.q(params, obs, batch["actions"])
        gap1 = torch.mean(cat_q("q1") - q1_data)
        gap2 = torch.mean(cat_q("q2") - q2_data)
        cql_loss = cql_alpha * (gap1 + gap2)
        metrics["cql_loss"] = cql_loss
        metrics["cql_gap"] = 0.5 * (gap1 + gap2)
        return total + cql_loss, metrics


class CQLConfig(SACConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or CQL)
        self.offline_data: Optional[str] = None
        self.cql_alpha = 1.0
        self.cql_n_actions = 4
        self.dataset_epochs_per_iter = 1
        self.num_env_runners = 0
        self.obs_dim: Optional[int] = None
        self.action_dim: Optional[int] = None

    def _training_keys(self):
        return super()._training_keys() | {
            "offline_data", "cql_alpha", "cql_n_actions",
            "dataset_epochs_per_iter", "obs_dim", "action_dim"}

    def offline(self, *, offline_data: str) -> "CQLConfig":
        self.offline_data = offline_data
        return self

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d.update({"cql_alpha": self.cql_alpha,
                  "cql_n_actions": self.cql_n_actions})
        return d

    def module_spec(self) -> SACModuleSpec:
        if self.obs_dim is not None and self.action_dim is not None:
            return SACModuleSpec(
                obs_dim=self.obs_dim, action_dim=self.action_dim,
                hiddens=tuple(self.model.get("hiddens", (256, 256))),
                activation=self.model.get("activation", "relu"))
        return super().module_spec()


class CQL(Algorithm):
    learner_cls = CQLLearner

    @classmethod
    def get_default_config(cls):
        return CQLConfig(algo_class=cls)

    def setup(self, _config) -> None:
        cfg = self._algo_config
        if not cfg.offline_data:
            raise ValueError("CQL requires config.offline(offline_data=...)")
        super().setup(_config)
        self.reader = JsonReader(cfg.offline_data, seed=cfg.seed)
        full = self.reader.concat_all()
        need = {"obs", "actions", "rewards", "next_obs", "dones"}
        if not need <= set(full):
            raise ValueError(f"CQL offline data needs {sorted(need)}, "
                             f"got {sorted(full.keys())}")

    def training_step(self) -> Dict:
        cfg = self.config
        learner = self.learner_group.local_learner()
        full = self.reader.concat_all()
        n = len(full["obs"])
        steps = max(1, int(cfg.dataset_epochs_per_iter * n
                           / cfg.train_batch_size))
        metrics: Dict = {}
        for _ in range(steps):
            b = self.reader.sample(cfg.train_batch_size)
            metrics = learner.update({
                "obs": b["obs"].astype(np.float32),
                "actions": b["actions"].astype(np.float32),
                "rewards": b["rewards"].astype(np.float32),
                "next_obs": b["next_obs"].astype(np.float32),
                "dones": b["dones"].astype(np.float32),
            })
        metrics["env_steps_this_iter"] = 0
        metrics["dataset_rows"] = n
        return metrics
