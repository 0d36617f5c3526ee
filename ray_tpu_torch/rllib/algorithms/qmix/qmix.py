# Ported from ray_tpu/rllib/algorithms/qmix/qmix.py (ray_tpu -> ray_tpu_torch).
"""QMIX — cooperative multi-agent Q-learning with monotonic value
factorization (reference: the QMIX family in rllib/algorithms (legacy
rllib_contrib/qmix); Rashid et al., ICML 2018).

Per-agent Q networks (shared weights, agent-id one-hot appended to obs)
produce Q_a(o_a, u_a); a mixing network whose non-negative weights are
generated by hypernetworks conditioned on the GLOBAL state combines them
into Q_tot, so argmax_a Q_a is consistent with argmax Q_tot (monotonicity)
— centralized training, decentralized execution. Training is 1-step TD
with a target mixer, epsilon-greedy collection on a MultiAgentEnv copy in
the driver (its draws from the numpy rng). The params, the target net and
Adam's state are on the learners' device (``learners(device=)``; None: the
CUDA card).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import copy_tree, load_tree
from ray_tpu_torch.rllib.algorithms.sac.sac import adam_step
from ray_tpu_torch.rllib.core.learner import cpu_snapshot
from ray_tpu_torch.rllib.core.rl_module import mlp_forward, mlp_params
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer


def _mlp_init(generator, sizes, scale_last=1.0):
    return mlp_params(generator, sizes, final_scale=scale_last)


def _mlp(layers, x):
    return mlp_forward(layers, x, torch.relu)


class QMixModel:
    """Agent Q net + monotonic mixer (hypernetwork-generated weights)."""

    def __init__(self, obs_dim: int, state_dim: int, n_agents: int,
                 n_actions: int, hidden: int = 64, mix_embed: int = 32):
        self.obs_dim = obs_dim
        self.state_dim = state_dim
        self.n_agents = n_agents
        self.n_actions = n_actions
        self.hidden = hidden
        self.mix_embed = mix_embed

    def init(self, generator: torch.Generator) -> Dict:
        in_dim = self.obs_dim + self.n_agents  # obs + agent-id one-hot
        E = self.mix_embed
        return {
            "q": _mlp_init(generator, (in_dim, self.hidden, self.hidden,
                                       self.n_actions), scale_last=0.01),
            # hypernets: state -> mixing weights/biases
            "hyper_w1": _mlp_init(generator,
                                  (self.state_dim, E * self.n_agents)),
            "hyper_b1": _mlp_init(generator, (self.state_dim, E)),
            "hyper_w2": _mlp_init(generator, (self.state_dim, E)),
            "hyper_b2": _mlp_init(generator, (self.state_dim, E, 1)),
        }

    def agent_qs(self, params, obs_all):
        """obs_all: [B, n_agents, obs_dim] -> Q: [B, n_agents, n_actions]."""
        B = obs_all.shape[0]
        ids = torch.eye(self.n_agents, device=obs_all.device)[None].expand(
            B, -1, -1)
        x = torch.cat([obs_all, ids], dim=-1)
        return _mlp(params["q"], x)

    def mix(self, params, agent_q, state):
        """agent_q: [B, n_agents]; state: [B, state_dim] -> Q_tot [B]."""
        B = agent_q.shape[0]
        w1 = torch.abs(_mlp(params["hyper_w1"], state)).reshape(
            B, self.n_agents, self.mix_embed)
        b1 = _mlp(params["hyper_b1"], state)
        hidden = F.elu(torch.einsum("ba,bae->be", agent_q, w1) + b1)
        w2 = torch.abs(_mlp(params["hyper_w2"], state))
        b2 = _mlp(params["hyper_b2"], state)[..., 0]
        return torch.sum(hidden * w2, dim=-1) + b2


class QMIXConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or QMIX)
        self.lr = 5e-4
        self.gamma = 0.99
        self.train_batch_size = 64
        self.replay_buffer_capacity = 20_000
        self.epsilon = [(0, 1.0), (6000, 0.05)]
        self.target_network_update_freq = 400
        self.num_steps_sampled_before_learning_starts = 200
        self.mixing_embed_dim = 32
        self.hidden_dim = 64
        self.num_env_steps_per_iter = 128

    def _training_keys(self):
        return {"lr", "gamma", "train_batch_size", "replay_buffer_capacity",
                "target_network_update_freq", "mixing_embed_dim",
                "hidden_dim", "num_env_steps_per_iter"}


class QMIX(Algorithm):
    """Self-contained trainer: drives a MultiAgentEnv copy in-process
    (the cooperative envs QMIX targets are cheap; distributed rollout uses
    the same MultiAgentEnvRunner machinery as multi-agent PPO)."""

    @classmethod
    def get_default_config(cls):
        return QMIXConfig(algo_class=cls)

    def setup(self, _config) -> None:
        cfg = self.config
        self.device = resolve_device(cfg.learner_device)
        self._env = cfg.make_env()()
        agents = list(self._env.possible_agents)
        self.agents = agents
        obs_space = self._env.observation_spaces[agents[0]]
        act_space = self._env.action_spaces[agents[0]]
        self.obs_dim = int(np.prod(obs_space.shape))
        self.n_actions = int(act_space.n)
        self.state_dim = self.obs_dim * len(agents)  # concat global state
        self.model = QMixModel(self.obs_dim, self.state_dim, len(agents),
                               self.n_actions, hidden=cfg.hidden_dim,
                               mix_embed=cfg.mixing_embed_dim)
        self._rng = np.random.default_rng(cfg.seed)
        params = self.model.init(
            torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.target_params = copy_tree(self.params)
        # optax.adam: eps outside the square root, bias-corrected
        self.opt = torch.optim.Adam(tree_leaves(self.params), lr=cfg.lr,
                                    eps=1e-8)
        self.replay = ReplayBuffer(cfg.replay_buffer_capacity, seed=cfg.seed)
        self._obs = None
        self._total_env_steps = 0
        self._steps_since_sync = 0
        self._episode_returns: List[float] = []
        self._ep_return = 0.0
        self._iteration = 0

    # ------------------------------------------------------------- training
    def _loss(self, params, target_params, batch):
        gamma = self.config.gamma
        model = self.model
        q_all = model.agent_qs(params, batch["obs"])
        q_taken = torch.gather(q_all, -1, batch["actions"][..., None])[
            ..., 0]
        q_tot = model.mix(params, q_taken, batch["state"])
        # double-Q: online argmax, target evaluation (no gradient)
        with torch.no_grad():
            next_online = model.agent_qs(params, batch["next_obs"])
            a_star = torch.argmax(next_online, dim=-1)
            next_target_all = model.agent_qs(target_params,
                                             batch["next_obs"])
            next_q = torch.gather(next_target_all, -1, a_star[..., None])[
                ..., 0]
            next_tot = model.mix(target_params, next_q, batch["next_state"])
            target = batch["rewards"] + gamma * \
                (1.0 - batch["dones"]) * next_tot
        td = q_tot - target
        return torch.mean(td ** 2), torch.mean(torch.abs(td))

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One Adam step of the TD loss on a replay batch: (loss, mean
        |td|) as floats."""
        tb = {k: torch.as_tensor(np.asarray(v)).to(self.device)
              for k, v in batch.items()}
        tb = {k: (v.long() if k == "actions" else v.float())
              for k, v in tb.items()}
        self.opt.zero_grad(set_to_none=True)
        loss, td_abs = self._loss(self.params, self.target_params, tb)
        loss.backward()
        adam_step(self.opt, self.params)
        loss, td_abs = torch.stack([loss.detach(), td_abs.detach()]).tolist()
        return {"qmix_loss": loss, "td_error_mean": td_abs}

    def _epsilon_at(self, step: int) -> float:
        from ray_tpu_torch.rllib.utils.schedules import piecewise_linear

        return piecewise_linear(self.config.epsilon, step)

    def _obs_matrix(self, obs_dict) -> np.ndarray:
        return np.stack([np.asarray(obs_dict[a], np.float32).reshape(-1)
                         for a in self.agents])

    @torch.no_grad()
    def _greedy(self, obs: np.ndarray) -> np.ndarray:
        q = self.model.agent_qs(self.params, torch.from_numpy(obs[None]).to(
            self.device))
        return q[0].argmax(dim=-1).cpu().numpy()

    def _collect(self, n_steps: int) -> int:
        eps = self._epsilon_at(self._total_env_steps)
        if self._obs is None:
            obs_dict, _ = self._env.reset(seed=int(self._rng.integers(1e9)))
            self._obs = self._obs_matrix(obs_dict)
            self._ep_return = 0.0
        for _ in range(n_steps):
            obs = self._obs
            if self._rng.random() < eps:
                actions = self._rng.integers(0, self.n_actions,
                                             len(self.agents))
            else:
                actions = self._greedy(obs)
            action_dict = {a: int(actions[i])
                           for i, a in enumerate(self.agents)}
            nxt, rewards, terms, truncs, _ = self._env.step(action_dict)
            done = bool(terms.get("__all__")) or bool(truncs.get("__all__"))
            team_reward = float(sum(rewards.values()))
            self._ep_return += team_reward
            # always the REAL next obs: a truncated episode (dones=0)
            # bootstraps from it; zeros would bias the TD target
            nxt_m = self._obs_matrix(nxt)
            self.replay.add_batch({
                "obs": obs[None], "actions": actions[None],
                "rewards": np.asarray([team_reward], np.float32),
                "next_obs": nxt_m[None],
                "state": obs.reshape(1, -1),
                "next_state": nxt_m.reshape(1, -1),
                "dones": np.asarray(
                    [float(bool(terms.get("__all__")))], np.float32),
            })
            self._total_env_steps += 1
            self._steps_since_sync += 1
            if done:
                self._episode_returns.append(self._ep_return)
                obs_dict, _ = self._env.reset(
                    seed=int(self._rng.integers(1e9)))
                self._obs = self._obs_matrix(obs_dict)
                self._ep_return = 0.0
            else:
                self._obs = nxt_m

        return n_steps

    def training_step(self) -> Dict:
        cfg = self.config
        new = self._collect(cfg.num_env_steps_per_iter)
        metrics: Dict[str, Any] = {"env_steps_this_iter": new,
                                   "epsilon": self._epsilon_at(
                                       self._total_env_steps)}
        if len(self.replay) >= cfg.num_steps_sampled_before_learning_starts:
            n_updates = max(1, new // 32)
            for _ in range(n_updates):
                out = self.update(self.replay.sample(cfg.train_batch_size))
            metrics.update(out)
            if self._steps_since_sync >= cfg.target_network_update_freq:
                self.target_params = copy_tree(self.params)
                self._steps_since_sync = 0
        if self._episode_returns:
            window = self._episode_returns[-100:]
            metrics["episode_return_mean"] = float(np.mean(window))
        return metrics

    # Algorithm plumbing expected by the base class
    def train(self) -> Dict:
        self._iteration += 1
        out = self.training_step()
        out["training_iteration"] = self._iteration
        return out

    def stop(self) -> None:
        try:
            self._env.close()
        except Exception:
            pass

    # checkpointing: QMIX owns its own state (no learner_group), so the
    # Algorithm base implementations would AttributeError
    def save_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        state = {
            "params": cpu_snapshot(self.params),
            "target_params": cpu_snapshot(self.target_params),
            "opt_state": cpu_snapshot(self.opt.state_dict()),
            "total_env_steps": self._total_env_steps,
            "episode_returns": self._episode_returns[-1000:],
            "iteration": self._iteration,
        }
        with open(os.path.join(checkpoint_dir, "qmix_state.pkl"),
                  "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "qmix_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        load_tree(self.params, state["params"])
        load_tree(self.target_params, state["target_params"])
        self.opt.load_state_dict(state["opt_state"])
        self._total_env_steps = state["total_env_steps"]
        self._episode_returns = list(state["episode_returns"])
        self._iteration = state["iteration"]

    def __init__(self, config):
        # bypass Algorithm.__init__'s env-runner/learner-group setup: QMIX
        # owns its own in-process loop
        self.config = config
        self.setup(config)
