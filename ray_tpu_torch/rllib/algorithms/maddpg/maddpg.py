# Ported from ray_tpu/rllib/algorithms/maddpg/maddpg.py (ray_tpu -> ray_tpu_torch).
"""MADDPG — multi-agent DDPG with centralized critics (reference:
rllib/algorithms/maddpg (legacy rllib_contrib/maddpg); Lowe et al. 2017
"Multi-Agent Actor-Critic for Mixed Cooperative-Competitive Environments").

Centralized training, decentralized execution: each agent has a
deterministic actor μ_i(o_i) over its OWN observation, but its critic
Q_i(s, a_1..a_n) sees the global state and EVERY agent's action — the
fix for non-stationarity that independent DDPG learners suffer. Targets
use target actors+critics (polyak).

All agents' actors and critics are stacked into one tree with a leading
agent dim, and every layer of every agent runs as one batched product over
that dim (``torch.matmul`` of [n, B, in] by [n, in, out]), not a Python
loop of tiny products. The params, their targets and the two Adams' state
are on the learners' device (``learners(device=)``; None: the CUDA card).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import copy_tree, polyak
from ray_tpu_torch.rllib.algorithms.sac.sac import adam_step
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer


def _stacked_mlp_params(generator: torch.Generator, n: int, sizes,
                        final_scale=1.0):
    """``n`` agents' dense layers stacked on a leading dim: He-normal
    weights [n, in, out] (the last layer scaled by ``final_scale``), zero
    biases [n, out]."""
    dev = generator.device
    layers = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        scale = math.sqrt(2.0 / a)
        if i == len(sizes) - 2:
            scale = scale * final_scale
        layers.append({
            "w": torch.randn((n, a, b), generator=generator,
                             device=dev) * scale,
            "b": torch.zeros((n, b), device=dev)})
    return layers


def _stacked_forward(layers, x):
    """Every agent's MLP at once: ``x`` [n, B, in] (or [B, in], shared by
    all agents) -> [n, B, out], relu between the layers."""
    for layer in layers[:-1]:
        x = torch.relu(torch.matmul(x, layer["w"]) + layer["b"][:, None])
    last = layers[-1]
    return torch.matmul(x, last["w"]) + last["b"][:, None]


class MADDPGModel:
    """Per-agent actor + centralized critic, agent-stacked (leading dim)."""

    def __init__(self, obs_dim: int, act_dim: int, n_agents: int,
                 hidden: int = 64, act_low: float = -1.0,
                 act_high: float = 1.0):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.n_agents = n_agents
        self.hidden = hidden
        self.act_low = act_low
        self.act_high = act_high
        self.state_dim = obs_dim * n_agents
        self.joint_act = act_dim * n_agents

    def init(self, generator: torch.Generator) -> Dict:
        return {
            "actor": _stacked_mlp_params(
                generator, self.n_agents,
                (self.obs_dim, self.hidden, self.hidden, self.act_dim),
                final_scale=0.01),
            "critic": _stacked_mlp_params(
                generator, self.n_agents,
                (self.state_dim + self.joint_act, self.hidden,
                 self.hidden, 1)),
        }

    def _squash(self, raw):
        mid = (self.act_high + self.act_low) / 2.0
        half = (self.act_high - self.act_low) / 2.0
        return mid + half * torch.tanh(raw)

    def actions(self, params, obs_all):
        """obs_all [B, n_agents, obs_dim] -> [B, n_agents, act_dim]."""
        raw = _stacked_forward(params["actor"], obs_all.transpose(0, 1))
        return self._squash(raw).transpose(0, 1)

    def q_values(self, params, state, joint_actions):
        """state [B, state_dim], joint_actions [B, joint_act] ->
        [B, n_agents]."""
        x = torch.cat([state, joint_actions], dim=-1)
        return _stacked_forward(params["critic"], x)[..., 0].transpose(0, 1)


class MADDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MADDPG)
        self.lr = 1e-3
        self.critic_lr = 1e-3
        self.gamma = 0.95
        self.tau = 0.01                     # polyak
        self.train_batch_size = 128
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 300
        self.exploration_noise = 0.3        # gaussian on actions
        self.hidden_dim = 64
        self.num_env_steps_per_iter = 128

    def _training_keys(self):
        return {"critic_lr", "tau", "train_batch_size",
                "replay_buffer_capacity", "exploration_noise",
                "hidden_dim", "num_env_steps_per_iter",
                "num_steps_sampled_before_learning_starts"}


class MADDPG(Algorithm):
    """Self-contained trainer over a MultiAgentEnv with continuous
    per-agent action spaces (the QMIX in-process collection pattern;
    distributed rollout rides MultiAgentEnvRunner when envs are costly)."""

    @classmethod
    def get_default_config(cls):
        return MADDPGConfig(algo_class=cls)

    def __init__(self, config):
        # bypass Algorithm.__init__'s env-runner/learner-group setup:
        # MADDPG owns its own in-process loop (the QMIX pattern)
        self.config = config
        self.setup(config)

    def setup(self, _config) -> None:
        cfg = self.config
        self.device = resolve_device(cfg.learner_device)
        self._env = cfg.make_env()()
        self.agents = list(self._env.possible_agents)
        obs_space = self._env.observation_spaces[self.agents[0]]
        act_space = self._env.action_spaces[self.agents[0]]
        self.obs_dim = int(np.prod(obs_space.shape))
        self.act_dim = int(np.prod(act_space.shape))
        self.model = MADDPGModel(
            self.obs_dim, self.act_dim, len(self.agents),
            hidden=cfg.hidden_dim,
            act_low=float(np.min(act_space.low)),
            act_high=float(np.max(act_space.high)))
        params = self.model.init(
            torch.Generator(device=self.device).manual_seed(cfg.seed))
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.target_params = copy_tree(self.params)
        # optax.adam, one for the actors and one for the critics
        self.opt_actor = torch.optim.Adam(
            tree_leaves(self.params["actor"]), lr=cfg.lr, eps=1e-8)
        self.opt_critic = torch.optim.Adam(
            tree_leaves(self.params["critic"]), lr=cfg.critic_lr, eps=1e-8)
        self.replay = ReplayBuffer(cfg.replay_buffer_capacity,
                                   seed=cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self._obs: Any = None
        self._ep_return = 0.0
        self._total_env_steps = 0
        self._episode_returns: List[float] = []
        self._iteration = 0

    # ------------------------------------------------------------ updates
    def _critic_loss(self, critic, batch):
        gamma = self.config.gamma
        model, target = self.model, self.target_params
        with torch.no_grad():
            next_act = model.actions({"actor": target["actor"]},
                                     batch["next_obs"])
            next_q = model.q_values(
                {"critic": target["critic"]}, batch["next_state"],
                next_act.reshape(next_act.shape[0], -1))   # [B, n]
            y = batch["rewards"] + gamma * \
                (1.0 - batch["dones"][:, None]) * next_q
        q = model.q_values({"critic": critic}, batch["state"],
                           batch["joint_actions"])
        return torch.mean((q - y) ** 2)

    def _actor_loss(self, actor, critic, batch):
        model = self.model
        acts = model.actions({"actor": actor}, batch["obs"])  # [B, n, act]
        # each agent's critic scores the joint action where ONLY its own
        # slot comes from its live actor; other slots use the replayed
        # actions (Lowe 2017 eq. 6)
        replay_acts = batch["joint_actions"].reshape(acts.shape)
        losses = []
        for i in range(len(self.agents)):
            joint = torch.cat([replay_acts[:, :i], acts[:, i:i + 1],
                               replay_acts[:, i + 1:]], dim=1)
            qi = model.q_values({"critic": critic}, batch["state"],
                                joint.reshape(joint.shape[0], -1))
            losses.append(-torch.mean(qi[:, i]))
        return sum(losses) / len(self.agents)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """The critics' Adam step, then the actors' against the updated
        critics, then the polyak step of every target: (critic loss, actor
        loss) as floats."""
        tb = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(
            self.device) for k, v in batch.items()}
        self.opt_critic.zero_grad(set_to_none=True)
        cl = self._critic_loss(self.params["critic"], tb)
        cl.backward()
        adam_step(self.opt_critic, self.params["critic"])
        self.opt_actor.zero_grad(set_to_none=True)
        # the critics on detached copies: the actor loss trains the actors
        al = self._actor_loss(self.params["actor"],
                              copy_tree(self.params["critic"]), tb)
        al.backward()
        adam_step(self.opt_actor, self.params["actor"])
        polyak(self.target_params, self.params, self.config.tau)
        cl, al = torch.stack([cl.detach(), al.detach()]).tolist()
        return {"critic_loss": cl, "actor_loss": al}

    # ---------------------------------------------------------- collection
    def _obs_matrix(self, obs_dict) -> np.ndarray:
        return np.stack([np.asarray(obs_dict[a], np.float32).reshape(-1)
                         for a in self.agents])

    @torch.no_grad()
    def _act(self, obs: np.ndarray) -> np.ndarray:
        out = self.model.actions(self.params, torch.from_numpy(
            obs[None]).to(self.device))
        return out[0].cpu().numpy()                    # [n, act_dim]

    def _collect(self, n_steps: int) -> int:
        cfg = self.config
        if self._obs is None:
            obs_dict, _ = self._env.reset(seed=int(self._rng.integers(1e9)))
            self._obs = self._obs_matrix(obs_dict)
            self._ep_return = 0.0
        for _ in range(n_steps):
            obs = self._obs
            acts = self._act(obs)
            acts = acts + self._rng.normal(
                0.0, cfg.exploration_noise, acts.shape)
            acts = np.clip(acts, self.model.act_low, self.model.act_high)
            action_dict = {a: acts[i].astype(np.float32)
                           for i, a in enumerate(self.agents)}
            nxt, rewards, terms, truncs, _ = self._env.step(action_dict)
            done_all = bool(terms.get("__all__"))
            trunc_all = bool(truncs.get("__all__"))
            nxt_m = self._obs_matrix(nxt)
            r_vec = np.asarray([float(rewards.get(a, 0.0))
                                for a in self.agents], np.float32)
            self._ep_return += float(r_vec.sum())
            self.replay.add_batch({
                "obs": obs[None],
                "joint_actions": acts.reshape(1, -1).astype(np.float32),
                "rewards": r_vec[None],
                "next_obs": nxt_m[None],
                "state": obs.reshape(1, -1),
                "next_state": nxt_m.reshape(1, -1),
                "dones": np.asarray([float(done_all)], np.float32),
            })
            self._total_env_steps += 1
            if done_all or trunc_all:
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
        metrics: Dict[str, Any] = {"env_steps_this_iter": new}
        if len(self.replay) >= cfg.num_steps_sampled_before_learning_starts:
            for _ in range(max(1, new // 32)):
                out = self.update(self.replay.sample(cfg.train_batch_size))
            metrics.update(out)
        if self._episode_returns:
            metrics["episode_return_mean"] = float(
                np.mean(self._episode_returns[-100:]))
        return metrics

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
