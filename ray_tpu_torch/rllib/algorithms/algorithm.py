# Ported from ray_tpu/rllib/algorithms/algorithm.py (ray_tpu -> ray_tpu_torch).
"""Algorithm — the trainer base (reference: rllib/algorithms/algorithm.py:193
— a Tune Trainable; ``step`` :810 delegates to ``training_step`` :1607).

Extends ``ray_tpu_torch.tune.Trainable`` so ``Tuner(PPO,
param_space=...)`` works exactly like ``algo.train()`` standalone
(reference: Algorithm inherits Trainable the same way). Env-runner fault tolerance mirrors the reference's
probe-and-recreate (evaluation/worker_set.py probe_unhealthy_workers).
The learners sit on ``config.learner_device`` (None: the CUDA card); the env
runners are CPU actors that get the weights as CPU tensors.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner
from ray_tpu_torch.tune.trainable import Trainable


class Algorithm(Trainable):
    learner_cls = None  # subclasses set

    def __init__(self, config=None, trial_id: str = "", trial_dir: str = "",
                 **kwargs):
        from ray_tpu_torch.rllib.algorithms.algorithm_config import (
            AlgorithmConfig)

        if isinstance(config, dict):
            base = self.get_default_config()
            for k, v in config.items():
                setattr(base, k, v)
            config = base
        # Trainable.__init__ resets self.config to the (dict) trial config
        # then calls setup(); stash the AlgorithmConfig first.
        self._algo_config = config or self.get_default_config()
        super().__init__(config={}, trial_id=trial_id,
                         trial_dir=trial_dir or os.getcwd())
        self.config = self._algo_config

    @classmethod
    def get_default_config(cls):
        from ray_tpu_torch.rllib.algorithms.algorithm_config import (
            AlgorithmConfig)

        return AlgorithmConfig(algo_class=cls)

    # ------------------------------------------------------------- lifecycle
    def setup(self, _config: Dict) -> None:
        cfg = self.config = self._algo_config
        self._module_spec = cfg.module_spec()
        self.learner_group = LearnerGroup(
            self.learner_cls, self._module_spec, cfg.learner_config_dict(),
            num_learners=cfg.num_learners,
            resources_per_learner=cfg.resources_for_learners(),
            device=cfg.learner_device)
        self.env_runners: List = []
        for i in range(cfg.num_env_runners):
            self.env_runners.append(self._make_runner(i))
        self._total_env_steps = 0
        self._episode_returns: List[float] = []

    def _make_runner(self, idx: int):
        cfg = self.config
        return ray_tpu_torch.remote(SingleAgentEnvRunner).options(
            resources={"CPU": 1}).remote(
                cfg.make_env(), cfg.num_envs_per_env_runner,
                cfg.rollout_fragment_length, self._module_spec,
                seed=cfg.seed + idx * 1000 + 1, explore=cfg.explore,
                gamma=cfg.gamma, connector=cfg.connector)

    # ---------------------------------------------------------------- train
    def step(self) -> Dict:
        t0 = time.perf_counter()
        result = self.training_step()
        took = time.perf_counter() - t0
        recent = self._episode_returns[-100:]
        result.update({
            "num_env_steps_sampled_lifetime": self._total_env_steps,
            "env_steps_this_iter": result.get("env_steps_this_iter", 0),
            "env_steps_per_sec":
                result.get("env_steps_this_iter", 0) / max(took, 1e-9),
            "episode_return_mean":
                float(np.mean(recent)) if recent else float("nan"),
            "num_episodes": len(self._episode_returns),
        })
        return result

    def training_step(self) -> Dict:
        raise NotImplementedError

    # ------------------------------------------------- env-runner utilities
    def _sample_from_runners(self, weights_ref) -> List[Dict]:
        """Fan out sample() to all runners; replace dead ones
        (reference: worker_set probe_unhealthy + recreate)."""
        refs = {r.sample.remote(weights_ref): i
                for i, r in enumerate(self.env_runners)}
        out: List[Dict] = []
        for ref, idx in refs.items():
            try:
                out.append(ray_tpu_torch.get(ref, timeout=300))
            except Exception:
                if not self.config.restart_failed_env_runners:
                    raise
                self.env_runners[idx] = self._make_runner(idx)
        for s in out:
            self._total_env_steps += s["env_steps"]
            for ep in s["episodes"]:
                self._episode_returns.append(ep["episode_return"])
        return out

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, checkpoint_dir: str) -> None:
        state = {
            "learner": self.learner_group.get_state(),
            "total_env_steps": self._total_env_steps,
            "episode_returns": self._episode_returns[-1000:],
        }
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner_group.set_state(state["learner"])
        self._total_env_steps = state["total_env_steps"]
        self._episode_returns = list(state["episode_returns"])

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str,
                        config=None) -> "Algorithm":
        algo = cls(config=config)
        algo.load_checkpoint(checkpoint_dir)
        return algo

    # -------------------------------------------------------------- cleanup
    def cleanup(self) -> None:
        for r in self.env_runners:
            try:
                ray_tpu_torch.get(r.stop.remote(), timeout=10)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.learner_group.shutdown()

    # --------------------------------------------------------------- extras
    def get_weights(self):
        return self.learner_group.get_weights()

    @torch.no_grad()
    def compute_single_action(self, obs, explore: bool = False):
        """Inference helper (reference: Algorithm.compute_single_action), on
        the CPU with the learners' weights; ``explore`` draws from a CPU
        generator seeded with 0 (the JAX package's ``jax.random.key(0)``)."""
        module = self._module_spec.build()
        params = self.get_weights()
        out = module.forward(params, torch.as_tensor(
            np.asarray(obs, np.float32))[None])
        if explore:
            gen = torch.Generator().manual_seed(0)
            act = module.dist.sample(gen, out["logits"])[0]
        elif self._module_spec.discrete:
            act = torch.argmax(out["logits"], dim=-1)[0]
        else:
            act = module.dist.split(out["logits"])[0][0]
        return np.asarray(act)
