# Ported from ray_tpu/rllib/algorithms/ars/ars.py (ray_tpu -> ray_tpu_torch).
"""ARS — augmented random search (reference: rllib/algorithms/ars/ars.py,
externalized to rllib_contrib in the snapshot; Mania 2018, the V2-t
variant: observation normalization, top-b direction selection, and
reward-std-scaled steps on top of ES's antithetic perturbation loop).

Shares ES's driver-side architecture (no learner group — runners only
evaluate candidates, nothing runs on the card); the three ARS
augmentations live here:

- a running observation filter (mean/var over every state the candidates
  visit) applied inside the policy module, so whitening travels with the
  weights to the env runners instead of needing stateful runners;
- only the ``top_directions`` best perturbation pairs (by max of the pair)
  contribute to the update;
- the step is divided by the stdev of the rewards actually used, making
  the step size scale-free across tasks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.es.es import ES, ESConfig, ravel_params


@dataclasses.dataclass
class ARSModuleSpec:
    """Wraps the catalog module with observation whitening. The filter
    stats ride the weights tree (never part of the perturbed parameter
    vector)."""

    inner: object  # RLModuleSpec

    @property
    def discrete(self) -> bool:
        return self.inner.discrete

    @property
    def action_dim(self) -> int:
        return self.inner.action_dim

    def build(self) -> "ARSModule":
        return ARSModule(self)


class ARSModule:
    CLIP = 5.0  # whitened-obs clip (Mania 2018 uses the same guard)

    def __init__(self, spec: ARSModuleSpec):
        self.spec = spec
        self.inner = spec.inner.build()

    @property
    def dist(self):
        return self.inner.dist

    def init(self, generator: torch.Generator):
        return self.inner.init(generator)

    def _whiten(self, weights, obs):
        f = weights["filter"]
        z = (obs - f["mu"]) / torch.sqrt(f["var"] + 1e-8)
        return torch.clamp(z, -self.CLIP, self.CLIP)

    def forward(self, weights, obs):
        return self.inner.forward(weights["inner"],
                                  self._whiten(weights, obs))

    def explore_action(self, weights, obs, generator: torch.Generator):
        return self.inner.explore_action(weights["inner"],
                                         self._whiten(weights, obs),
                                         generator)

    # no greedy_action: the runner's argmax-on-forward fallback handles
    # deterministic evaluation, and forward() already whitens


class ARSConfig(ESConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ARS)
        self.top_directions = 8     # b <= pop_size directions kept
        self.step_size = 0.02
        self.noise_stdev = 0.03
        self.observation_filter = "MeanStdFilter"  # or "NoFilter"

    def _training_keys(self):
        return super()._training_keys() | {"top_directions",
                                           "observation_filter"}


class ARS(ES):
    @classmethod
    def get_default_config(cls):
        return ARSConfig(algo_class=cls)

    def setup(self, _config) -> None:
        cfg = self.config = self._algo_config
        inner_spec = cfg.module_spec()
        self._filter = {
            "mu": np.zeros(inner_spec.obs_dim, np.float32),
            "var": np.ones(inner_spec.obs_dim, np.float32),
        }
        self._filter_count = 0
        # theta covers the INNER policy only; the filter travels beside it
        # in the weights dict, outside the perturbed vector
        self._module_spec = ARSModuleSpec(inner=inner_spec)
        params = inner_spec.build().init(
            torch.Generator().manual_seed(cfg.seed))
        self._theta, self._unravel = ravel_params(params)
        self._np_rng = np.random.default_rng(cfg.seed)
        self.env_runners = [self._make_runner(i)
                            for i in range(cfg.num_env_runners)]
        self._total_env_steps = 0
        self._episode_returns = []

    def _filter_weights(self):
        return {k: torch.from_numpy(v.copy())
                for k, v in self._filter.items()}

    def get_weights(self):
        return {"filter": self._filter_weights(),
                "inner": self._unravel(self._theta)}

    def _candidate_weights(self, cand: np.ndarray):
        return {"filter": self._filter_weights(),
                "inner": self._unravel(cand)}

    def _update_filter(self, obs_batches) -> None:
        if self._algo_config.observation_filter == "NoFilter":
            return
        flat = np.concatenate(
            [o.reshape(-1, o.shape[-1]) for o in obs_batches], axis=0)
        n_new = len(flat)
        if n_new == 0:
            return
        n_old = self._filter_count
        mu_new = flat.mean(0)
        var_new = flat.var(0)
        n = n_old + n_new
        delta = mu_new - self._filter["mu"]
        # Chan's parallel-variance merge of (old stats, batch stats);
        # n_old=0 contributes nothing (the init var is a placeholder,
        # not a sample)
        m_old = self._filter["var"] * n_old
        m_new = var_new * n_new
        self._filter["mu"] = (self._filter["mu"]
                              + delta * n_new / n).astype(np.float32)
        self._filter["var"] = ((m_old + m_new + delta ** 2
                                * n_old * n_new / n)
                               / max(n, 1)).astype(np.float32)
        self._filter_count = n

    def training_step(self) -> Dict:
        cfg = self.config
        dim = len(self._theta)
        noise = self._np_rng.standard_normal(
            (cfg.pop_size, dim)).astype(np.float32)
        candidates = np.concatenate([
            self._theta + cfg.noise_stdev * noise,
            self._theta - cfg.noise_stdev * noise])
        refs = {}
        for i, cand in enumerate(candidates):
            runner = self.env_runners[i % len(self.env_runners)]
            w_ref = ray_tpu_torch.put(self._candidate_weights(cand))
            refs[runner.sample.remote(w_ref)] = i

        fitness = np.zeros(len(candidates), np.float32)
        obs_batches = []
        steps_this_iter = 0
        for ref, i in refs.items():
            sample = ray_tpu_torch.get(ref, timeout=600)
            fitness[i] = self._fitness(sample)
            obs_batches.append(sample["obs"])
            steps_this_iter += sample["env_steps"]
            self._total_env_steps += sample["env_steps"]
            for ep in sample["episodes"]:
                self._episode_returns.append(ep["episode_return"])

        pos, neg = fitness[:cfg.pop_size], fitness[cfg.pop_size:]
        # top-b directions by the better arm of each antithetic pair
        b = min(cfg.top_directions, cfg.pop_size)
        order = np.argsort(-np.maximum(pos, neg))[:b]
        used = np.concatenate([pos[order], neg[order]])
        sigma_r = used.std() + 1e-8
        grad = (pos[order] - neg[order]) @ noise[order] / (b * sigma_r)
        self._theta = self._theta + cfg.step_size * grad

        self._update_filter(obs_batches)
        return {
            "env_steps_this_iter": steps_this_iter,
            "fitness_mean": float(fitness.mean()),
            "fitness_max": float(fitness.max()),
            "reward_std_used": float(sigma_r),
            "filter_count": self._filter_count,
            "theta_norm": float(np.linalg.norm(self._theta)),
        }

    # ES's compute_single_action runs this module's forward, which whitens

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        super().save_checkpoint(checkpoint_dir)
        with open(os.path.join(checkpoint_dir, "ars_filter.pkl"),
                  "wb") as f:
            pickle.dump({"filter": self._filter,
                         "count": self._filter_count}, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        super().load_checkpoint(checkpoint_dir)
        with open(os.path.join(checkpoint_dir, "ars_filter.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self._filter = state["filter"]
        self._filter_count = state["count"]
