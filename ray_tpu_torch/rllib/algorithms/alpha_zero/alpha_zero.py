# Ported from ray_tpu/rllib/algorithms/alpha_zero/alpha_zero.py (ray_tpu -> ray_tpu_torch).
"""AlphaZero — MCTS-guided policy iteration (reference:
rllib/algorithms/alpha_zero/ (torch, externalized to rllib_contrib in the
snapshot; Silver 2017): PUCT tree search over a *state-settable* env
produces visit-count policy targets; the network is trained to match the
search policy and predict the episode outcome).

Single-player, perfect-information, deterministic envs (the reference's
AlphaZero makes the same assumption): the env must expose ``get_state()``
/ ``set_state(state)`` so the search can branch from arbitrary nodes, and
may expose an ``action_mask()`` for legality. Self-play workers are plain
CPU actors running the search (numpy) with the catalog module's forward on
CPU tensors, on one torch thread (its ``logits`` head is the prior, its
``vf`` head the leaf value); the learner trains it with a cross-entropy +
value-MSE Adam step on the learners' device (``learners(device=)``; None:
the CUDA card).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import load_tree
from ray_tpu_torch.rllib.algorithms.sac.sac import adam_step
from ray_tpu_torch.rllib.core.learner import cpu_snapshot
from ray_tpu_torch.rllib.env.env_runner import cpu_weights, one_thread


class _Node:
    __slots__ = ("prior", "visits", "value_sum", "children", "state",
                 "obs", "reward", "done", "mask")

    def __init__(self, prior: float):
        self.prior = prior
        self.visits = 0
        self.value_sum = 0.0
        self.children: Dict[int, "_Node"] = {}
        self.state = None
        self.obs = None
        self.reward = 0.0
        self.done = False
        self.mask: Optional[np.ndarray] = None

    @property
    def value(self) -> float:
        return self.value_sum / self.visits if self.visits else 0.0


class MCTS:
    """PUCT search (Silver 2017 Eq. 2) with Dirichlet root noise. The env
    is used as its own model through get_state/set_state."""

    def __init__(self, env, predict, *, num_simulations: int = 50,
                 c_puct: float = 1.5, gamma: float = 0.997,
                 dirichlet_alpha: float = 0.3,
                 dirichlet_eps: float = 0.25,
                 rng: Optional[np.random.Generator] = None):
        self.env = env
        self.predict = predict  # obs[1, D] -> (priors[A], value)
        self.num_simulations = num_simulations
        self.c_puct = c_puct
        self.gamma = gamma
        self.dirichlet_alpha = dirichlet_alpha
        self.dirichlet_eps = dirichlet_eps
        self.rng = rng or np.random.default_rng()

    def _mask_of(self) -> Optional[np.ndarray]:
        fn = getattr(self.env, "action_mask", None)
        return None if fn is None else np.asarray(fn(), bool)

    def _expand(self, node: _Node, obs) -> float:
        priors, value = self.predict(np.asarray(obs, np.float32)[None])
        priors = np.asarray(priors, np.float64)
        node.mask = self._mask_of()
        if node.mask is not None:
            priors = np.where(node.mask, priors, 0.0)
            total = priors.sum()
            priors = (priors / total if total > 0
                      else node.mask / node.mask.sum())
        for a, p in enumerate(priors):
            if node.mask is None or node.mask[a]:
                node.children[a] = _Node(float(p))
        return float(value)

    def _select_child(self, node: _Node) -> Tuple[int, _Node]:
        sqrt_n = math.sqrt(node.visits)
        best, best_score = None, -np.inf
        for a, child in node.children.items():
            u = self.c_puct * child.prior * sqrt_n / (1 + child.visits)
            score = child.reward + self.gamma * child.value + u \
                if child.visits else u
            if score > best_score:
                best, best_score = (a, child), score
        return best

    def search(self, root_obs) -> np.ndarray:
        """Visit-count distribution over actions after the simulations."""
        root = _Node(0.0)
        root.state = self.env.get_state()
        self._expand(root, root_obs)
        root.visits = 1
        if self.dirichlet_eps > 0 and root.children:
            noise = self.rng.dirichlet(
                [self.dirichlet_alpha] * len(root.children))
            for (a, child), n in zip(root.children.items(), noise):
                child.prior = ((1 - self.dirichlet_eps) * child.prior
                               + self.dirichlet_eps * n)
        for _ in range(self.num_simulations):
            node, path = root, [root]
            # ---- select down to an unexpanded edge
            while node.children:
                action, child = self._select_child(node)
                if child.visits == 0 and child.state is None:
                    # materialize the transition once
                    self.env.set_state(node.state)
                    obs, rew, term, trunc, _ = self.env.step(action)
                    child.state = self.env.get_state()
                    child.obs = np.asarray(obs, np.float32)
                    child.reward = float(rew)
                    child.done = bool(term or trunc)
                node, path = child, path + [child]
                if node.done or node.visits == 0:
                    break
            # ---- expand + evaluate
            if node.done:
                leaf_value = 0.0
            else:
                self.env.set_state(node.state)
                leaf_value = self._expand(node, node.obs)
            # ---- backup (discounted through edge rewards)
            value = leaf_value
            for n in reversed(path):
                n.visits += 1
                n.value_sum += value
                value = n.reward + self.gamma * value
        counts = np.zeros(self.env.action_space.n, np.float64)
        for a, child in root.children.items():
            counts[a] = child.visits
        total = counts.sum()
        return (counts / total if total > 0 else
                np.ones_like(counts) / len(counts)).astype(np.float32)


class SelfPlayWorker:
    """One env + one search per actor; plays whole episodes and returns
    (obs, search-policy, outcome) training tuples."""

    def __init__(self, env_maker, module_spec, config: Dict, seed: int):
        self.env = env_maker()
        self.module = module_spec.build()
        self.config = config
        self.rng = np.random.default_rng(seed)

    @torch.no_grad()
    def play(self, weights, num_episodes: int) -> Dict:
        with one_thread():
            return self._play(cpu_weights(weights), num_episodes)

    def _play(self, weights, num_episodes: int) -> Dict:
        cfg = self.config

        def predict(obs):
            out = self.module.forward(weights, torch.from_numpy(obs))
            priors = torch.softmax(out["logits"][0], dim=-1)
            return priors.numpy(), float(out["vf"][0])

        obs_rows: List[np.ndarray] = []
        pi_rows: List[np.ndarray] = []
        z_rows: List[float] = []
        returns = []
        env_steps = 0
        for _ in range(num_episodes):
            obs, _ = self.env.reset()
            mcts = MCTS(self.env, predict,
                        num_simulations=cfg["num_simulations"],
                        c_puct=cfg["c_puct"], gamma=cfg["gamma"],
                        dirichlet_alpha=cfg["dirichlet_alpha"],
                        dirichlet_eps=cfg["dirichlet_eps"], rng=self.rng)
            ep_obs, ep_pi, ep_rew = [], [], []
            done = False
            t = 0
            while not done:
                root_state = self.env.get_state()
                pi = mcts.search(np.asarray(obs, np.float32))
                self.env.set_state(root_state)
                if t < cfg["temperature_moves"]:
                    action = int(self.rng.choice(len(pi), p=pi))
                else:
                    action = int(pi.argmax())
                ep_obs.append(np.asarray(obs, np.float32))
                ep_pi.append(pi)
                obs, rew, term, trunc, _ = self.env.step(action)
                ep_rew.append(float(rew))
                done = term or trunc
                t += 1
                env_steps += 1
            # outcome targets: discounted return-to-go from each move
            z = 0.0
            zs = np.empty(len(ep_rew), np.float32)
            for i in reversed(range(len(ep_rew))):
                z = ep_rew[i] + cfg["gamma"] * z
                zs[i] = z
            obs_rows += ep_obs
            pi_rows += ep_pi
            z_rows += zs.tolist()
            returns.append(float(np.sum(ep_rew)))
        return {
            "obs": np.stack(obs_rows),
            "pi": np.stack(pi_rows),
            "z": np.asarray(z_rows, np.float32),
            "episode_returns": returns,
            "env_steps": env_steps,
        }

    def stop(self):
        return True


class AlphaZeroLearner:
    """CE(search policy, net policy) + MSE(outcome, net value), one Adam
    step (optax.adam: eps outside the square root, bias-corrected) over
    every leaf on ``device`` (None: the CUDA card)."""

    def __init__(self, module_spec, config: Dict, use_mesh: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.module = module_spec.build()
        self.config = config
        params = self.module.init(torch.Generator(
            device=self.device).manual_seed(config.get("seed", 0)))
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.opt = torch.optim.Adam(tree_leaves(self.params),
                                    lr=config.get("lr", 1e-3), eps=1e-8)

    def _losses(self, params, batch):
        out = self.module.forward(params, batch["obs"])
        logp = torch.log_softmax(out["logits"], dim=-1)
        policy_loss = -torch.mean(torch.sum(batch["pi"] * logp, dim=-1))
        value_loss = torch.mean((out["vf"] - batch["z"]) ** 2)
        total = policy_loss + self.config.get("vf_coeff", 1.0) * value_loss
        return total, policy_loss, value_loss

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        tb = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(
            self.device) for k, v in batch.items()}
        self.opt.zero_grad(set_to_none=True)
        loss, pl, vl = self._losses(self.params, tb)
        loss.backward()
        adam_step(self.opt, self.params)
        loss, pl, vl = torch.stack([loss.detach(), pl.detach(),
                                    vl.detach()]).tolist()
        return {"total_loss": loss, "policy_loss": pl, "value_loss": vl}

    def get_weights(self):
        return cpu_snapshot(self.params)

    def set_weights(self, weights) -> None:
        load_tree(self.params, weights)

    def get_state(self) -> Dict:
        return {"params": cpu_snapshot(self.params),
                "opt_state": cpu_snapshot(self.opt.state_dict())}

    def set_state(self, state: Dict) -> None:
        load_tree(self.params, state["params"])
        self.opt.load_state_dict(state["opt_state"])


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or AlphaZero)
        self.num_simulations = 50
        self.c_puct = 1.5
        self.dirichlet_alpha = 0.3
        self.dirichlet_eps = 0.25
        self.temperature_moves = 8  # sample ~ visit counts this long
        self.episodes_per_worker = 2
        self.sgd_steps_per_iter = 8
        self.replay_capacity = 20_000
        self.vf_coeff = 1.0
        self.num_env_runners = 2

    def _training_keys(self):
        return {"num_simulations", "c_puct", "dirichlet_alpha",
                "dirichlet_eps", "temperature_moves",
                "episodes_per_worker", "sgd_steps_per_iter",
                "replay_capacity", "vf_coeff"}

    def mcts_config_dict(self) -> Dict:
        return {"num_simulations": self.num_simulations,
                "c_puct": self.c_puct, "gamma": self.gamma,
                "dirichlet_alpha": self.dirichlet_alpha,
                "dirichlet_eps": self.dirichlet_eps,
                "temperature_moves": self.temperature_moves}


class AlphaZero(Algorithm):
    learner_cls = AlphaZeroLearner

    @classmethod
    def get_default_config(cls):
        return AlphaZeroConfig(algo_class=cls)

    def setup(self, _config) -> None:
        cfg = self.config = self._algo_config
        self._module_spec = cfg.module_spec()
        if not self._module_spec.discrete:
            raise ValueError("AlphaZero needs a discrete action space")
        probe = cfg.make_env()()
        for attr in ("get_state", "set_state"):
            if not callable(getattr(probe, attr, None)):
                raise ValueError(
                    f"AlphaZero env must implement {attr}() — the search "
                    "uses the env as its own model")
        self.learner = AlphaZeroLearner(
            self._module_spec,
            {"lr": cfg.lr, "seed": cfg.seed, "vf_coeff": cfg.vf_coeff},
            device=cfg.learner_device)
        worker_cls = ray_tpu_torch.remote(SelfPlayWorker).options(
            resources={"CPU": 1})
        self.workers = [
            worker_cls.remote(cfg.make_env(), self._module_spec,
                              cfg.mcts_config_dict(), cfg.seed + i)
            for i in range(max(1, cfg.num_env_runners))]
        self._replay: Dict[str, np.ndarray] = {}
        self._np_rng = np.random.default_rng(cfg.seed)
        self._episode_returns: List[float] = []
        self._total_env_steps = 0

    def _append_replay(self, batch: Dict) -> None:
        cap = self.config.replay_capacity
        for key in ("obs", "pi", "z"):
            prev = self._replay.get(key)
            rows = batch[key] if prev is None else \
                np.concatenate([prev, batch[key]])
            self._replay[key] = rows[-cap:]

    def training_step(self) -> Dict:
        cfg = self.config
        w_ref = ray_tpu_torch.put(self.learner.get_weights())
        samples = ray_tpu_torch.get(
            [w.play.remote(w_ref, cfg.episodes_per_worker)
             for w in self.workers], timeout=1200)
        steps_this_iter = 0
        for s in samples:
            self._append_replay(s)
            self._episode_returns += s["episode_returns"]
            steps_this_iter += s["env_steps"]
            self._total_env_steps += s["env_steps"]
        n = len(self._replay["obs"])
        metrics: Dict = {}
        for _ in range(cfg.sgd_steps_per_iter):
            idx = self._np_rng.integers(
                0, n, min(cfg.train_batch_size, n))
            metrics = self.learner.update({
                "obs": self._replay["obs"][idx],
                "pi": self._replay["pi"][idx],
                "z": self._replay["z"][idx]})
        metrics.update({
            "env_steps_this_iter": steps_this_iter,
            "replay_rows": n,
        })
        return metrics

    def get_weights(self):
        return self.learner.get_weights()

    @torch.no_grad()
    def compute_single_action(self, obs, explore: bool = False):
        out = self._module_spec.build().forward(
            self.learner.get_weights(),
            torch.as_tensor(np.asarray(obs, np.float32))[None])
        return int(out["logits"][0].argmax())

    def cleanup(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.get(w.stop.remote(), timeout=10)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "az_state.pkl"), "wb") as f:
            pickle.dump({"learner": self.learner.get_state(),
                         "episode_returns": self._episode_returns,
                         "total_env_steps": self._total_env_steps}, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "az_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.learner.set_state(state["learner"])
        self._episode_returns = state["episode_returns"]
        self._total_env_steps = state["total_env_steps"]
