# Ported from ray_tpu/rllib/algorithms/bc/bc.py (ray_tpu -> ray_tpu_torch).
"""BC — behavior cloning from offline data (reference:
rllib/algorithms/bc/bc.py + bc_torch_learner: supervised
-logp(action|obs) on logged transitions; the entry point of the offline
family MARWIL/CQL/CRR share).

No env runners: the dataset (offline/json_io.py JsonReader) is the sole
experience source; an env is only probed for spaces when obs/action dims
are not given explicitly.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.offline import JsonReader


class BCLearner(Learner):
    def loss(self, params, batch):
        out = self.module.forward(params, batch["obs"])
        logp = self.module.dist.logp(out["logits"], batch["actions"])
        bc_loss = -torch.mean(logp)
        entropy = torch.mean(self.module.dist.entropy(out["logits"]))
        return bc_loss, {"bc_loss": bc_loss, "entropy": entropy}


class BCConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or BC)
        self.offline_data: Optional[str] = None  # dir or glob of .jsonl
        self.dataset_epochs_per_iter = 1
        self.train_batch_size = 256
        self.num_env_runners = 0  # offline: no rollouts
        self.obs_dim: Optional[int] = None
        self.action_dim: Optional[int] = None
        self.discrete: bool = True

    def _training_keys(self):
        return {"offline_data", "dataset_epochs_per_iter", "obs_dim",
                "action_dim", "discrete"}

    def offline(self, *, offline_data: str) -> "BCConfig":
        self.offline_data = offline_data
        return self

    def module_spec(self) -> RLModuleSpec:
        if self.obs_dim is not None and self.action_dim is not None:
            return RLModuleSpec(
                obs_dim=self.obs_dim, action_dim=self.action_dim,
                discrete=self.discrete,
                hiddens=tuple(self.model.get("hiddens", (64, 64))),
                activation=self.model.get("activation", "tanh"))
        return super().module_spec()  # probe the env for spaces


class BC(Algorithm):
    learner_cls = BCLearner

    @classmethod
    def get_default_config(cls):
        return BCConfig(algo_class=cls)

    def setup(self, _config) -> None:
        cfg = self._algo_config
        if not cfg.offline_data:
            raise ValueError("BC requires config.offline(offline_data=...)")
        # base setup builds module spec + learner group; the env-runner loop
        # is a no-op since BCConfig pins num_env_runners=0
        super().setup(_config)
        self.reader = JsonReader(cfg.offline_data, seed=cfg.seed)

    def training_step(self) -> Dict:
        cfg = self.config
        full = self.reader.concat_all()
        n = len(full["obs"])
        steps = max(1, int(cfg.dataset_epochs_per_iter * n
                           / cfg.train_batch_size))
        metrics: Dict = {}
        for _ in range(steps):
            batch = self.reader.sample(cfg.train_batch_size)
            metrics = self.learner_group.update({
                "obs": batch["obs"].astype(np.float32),
                "actions": batch["actions"],
            })
        metrics["env_steps_this_iter"] = 0
        metrics["dataset_rows"] = n
        return metrics
