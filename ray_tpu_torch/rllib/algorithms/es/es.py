# Ported from ray_tpu/rllib/algorithms/es/es.py (ray_tpu -> ray_tpu_torch).
"""ES — evolution strategies (reference: rllib/algorithms/es/es.py,
Salimans 2017: antithetic Gaussian perturbations evaluated by rollout
workers, centered-rank-weighted noise combination; no backprop at all).

The gradient-free outer loop fits the runtime naturally: each candidate
evaluation is one env-runner actor task; the combination step is one
product of the (pop, dim) noise matrix, numpy on the host. Nothing of ES
runs on the card: the params live in the driver as a flat fp32 vector
(``ravel_params``, the order of ``jax.flatten_util.ravel_pytree``), and
the runners evaluate candidates with their CPU module.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.tree import tree_flatten, tree_unflatten
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig


def ravel_params(tree) -> Tuple[np.ndarray, Callable]:
    """``jax.flatten_util.ravel_pytree`` for a tree of tensors: the leaves
    in ``tree_leaves`` order (dict keys sorted, lists in order), each
    flattened row-major, concatenated as one fp32 vector; and the function
    that rebuilds the tree, as CPU tensors, from such a vector."""
    leaves, structure = tree_flatten(tree)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    flat = np.concatenate([
        np.asarray(torch.as_tensor(leaf).detach().cpu(),
                   np.float32).reshape(-1) for leaf in leaves])

    def unravel(vec: np.ndarray):
        vec = np.asarray(vec, np.float32)
        out, off = [], 0
        for shape in shapes:
            n = int(np.prod(shape))
            out.append(torch.from_numpy(vec[off:off + n].reshape(shape)
                                        .copy()))
            off += n
        return tree_unflatten(structure, out)

    return flat, unravel


def centered_ranks(x: np.ndarray) -> np.ndarray:
    """Map fitnesses to centered uniform ranks in [-0.5, 0.5] (Salimans
    2017 fitness shaping — robust to return-scale outliers)."""
    ranks = np.empty(len(x), dtype=np.float32)
    ranks[x.argsort()] = np.arange(len(x), dtype=np.float32)
    return ranks / (len(x) - 1) - 0.5 if len(x) > 1 else np.zeros(1,
                                                                  np.float32)


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ES)
        self.pop_size = 16          # perturbation PAIRS per iteration
        self.noise_stdev = 0.05
        self.step_size = 0.02       # SGD step on the combined gradient
        self.l2_coeff = 0.005
        self.episodes_per_candidate = 1
        self.rollout_fragment_length = 512  # >= one full episode
        self.num_env_runners = 4
        self.explore = False        # candidates run their mean policy

    def _training_keys(self):
        return {"pop_size", "noise_stdev", "step_size", "l2_coeff",
                "episodes_per_candidate"}


class ES(Algorithm):
    """No learner group: params live in the driver; env runners only
    evaluate (their sample() episode returns are the fitness signal)."""

    learner_cls = None

    @classmethod
    def get_default_config(cls):
        return ESConfig(algo_class=cls)

    def setup(self, _config) -> None:
        cfg = self.config = self._algo_config
        self._module_spec = cfg.module_spec()
        module = self._module_spec.build()
        params = module.init(torch.Generator().manual_seed(cfg.seed))
        self._theta, self._unravel = ravel_params(params)
        self._np_rng = np.random.default_rng(cfg.seed)
        self.env_runners: List = []
        for i in range(cfg.num_env_runners):
            self.env_runners.append(self._make_runner(i))
        self._total_env_steps = 0
        self._episode_returns: List[float] = []

    def get_weights(self):
        return self._unravel(self._theta)

    def _fitness(self, sample: Dict) -> float:
        eps = sample["episodes"]
        if eps:
            return float(np.mean([e["episode_return"] for e in eps]))
        # no episode finished inside the fragment: fall back to the
        # fragment's summed reward so fitness stays informative
        return float(sample["rewards"].sum())

    def training_step(self) -> Dict:
        cfg = self.config
        dim = len(self._theta)
        noise = self._np_rng.standard_normal(
            (cfg.pop_size, dim)).astype(np.float32)

        candidates = np.concatenate([
            self._theta + cfg.noise_stdev * noise,
            self._theta - cfg.noise_stdev * noise])  # antithetic pairs
        refs = {}
        for i, cand in enumerate(candidates):
            runner = self.env_runners[i % len(self.env_runners)]
            w_ref = ray_tpu_torch.put(self._unravel(cand))
            refs[runner.sample.remote(w_ref)] = i

        fitness = np.zeros(len(candidates), np.float32)
        steps_this_iter = 0
        for ref, i in refs.items():
            sample = ray_tpu_torch.get(ref, timeout=600)
            fitness[i] = self._fitness(sample)
            steps_this_iter += sample["env_steps"]
            self._total_env_steps += sample["env_steps"]
            for ep in sample["episodes"]:
                self._episode_returns.append(ep["episode_return"])

        shaped = centered_ranks(fitness)
        pos, neg = shaped[:cfg.pop_size], shaped[cfg.pop_size:]
        grad = (pos - neg) @ noise / (2 * cfg.pop_size * cfg.noise_stdev)
        self._theta = ((1 - cfg.l2_coeff * cfg.step_size) * self._theta
                       + cfg.step_size * grad)

        return {
            "env_steps_this_iter": steps_this_iter,
            "fitness_mean": float(fitness.mean()),
            "fitness_max": float(fitness.max()),
            "theta_norm": float(np.linalg.norm(self._theta)),
        }

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

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "es_state.pkl"), "wb") as f:
            pickle.dump({"theta": self._theta,
                         "episode_returns": self._episode_returns,
                         "total_env_steps": self._total_env_steps}, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "es_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self._theta = state["theta"]
        self._episode_returns = state["episode_returns"]
        self._total_env_steps = state["total_env_steps"]

    @torch.no_grad()
    def compute_single_action(self, obs, explore: bool = False):
        module = self._module_spec.build()
        out = module.forward(self.get_weights(), torch.as_tensor(
            np.asarray(obs, np.float32))[None])
        logits = out["logits"][0].numpy()
        if module.spec.discrete:
            return int(np.argmax(logits))
        return np.tanh(logits[:module.spec.action_dim])
