# Ported from ray_tpu/rllib/algorithms/dqn/dqn.py (ray_tpu -> ray_tpu_torch).
"""DQN — double DQN with target network and (optionally prioritized)
replay (reference: rllib/algorithms/dqn/dqn.py DQNConfig/DQN and
dqn/torch/dqn_torch_learner.py loss; Mnih 2015 / van Hasselt 2016).

The update — gather Q(s,a), double-DQN target from the online argmax + the
target net under ``no_grad``, Huber loss, the learner's clipped Adam step —
runs on the learner's device; the replay buffer stays host-side numpy and
ships one contiguous minibatch per step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner, cpu_snapshot
from ray_tpu_torch.rllib.core.rl_module import (
    ACTIVATIONS, mlp_forward, mlp_params)
from ray_tpu_torch.rllib.utils.replay_buffer import (
    PrioritizedReplayBuffer,
    ReplayBuffer,
)


# ------------------------------------------------------------------- module
@dataclasses.dataclass
class DQNModuleSpec:
    """Q-network spec (reference: dqn/dqn_rl_module.py)."""

    obs_dim: int
    action_dim: int
    discrete: bool = True  # DQN is discrete-only
    hiddens: Tuple[int, ...] = (64, 64)
    activation: str = "relu"
    dueling: bool = True

    def build(self) -> "DQNModule":
        return DQNModule(self)


def huber(td: torch.Tensor) -> torch.Tensor:
    return torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)


class DQNModule:
    """MLP Q-network, optionally dueling (value + advantage streams,
    reference: dqn dueling head)."""

    def __init__(self, spec: DQNModuleSpec):
        self.spec = spec
        self._act = ACTIVATIONS[spec.activation]

    def init(self, generator: torch.Generator) -> Dict:
        sizes = (self.spec.obs_dim, *self.spec.hiddens)
        # He-normal on every layer, the last one too
        params = {"q": mlp_params(generator, sizes + (self.spec.action_dim,),
                                  final_scale=1.0)}
        if self.spec.dueling:
            params["v"] = mlp_params(generator, sizes + (1,),
                                     final_scale=1.0)
        # exploration epsilon rides in params so that the env runners'
        # weights carry it; it is not trained
        params["epsilon"] = torch.tensor(1.0, device=generator.device)
        return params

    def q_values(self, params, obs) -> torch.Tensor:
        adv = mlp_forward(params["q"], obs, self._act)
        if self.spec.dueling:
            v = mlp_forward(params["v"], obs, self._act)
            return v + adv - adv.mean(dim=-1, keepdim=True)
        return adv

    # env-runner interface (same contract as MLPModule)
    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        q = self.q_values(params, obs)
        return {"logits": q, "vf": q.max(dim=-1).values}

    def explore_action(self, params, obs, generator: torch.Generator):
        q = self.q_values(params, obs)
        greedy = torch.argmax(q, dim=-1)
        random_a = torch.randint(0, self.spec.action_dim, greedy.shape,
                                 generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < params["epsilon"]
        action = torch.where(explore, random_a, greedy)
        zeros = torch.zeros_like(q[..., 0])
        return action, zeros, zeros  # logp/vf unused by off-policy replay


def copy_tree(tree):
    """Detached copies of a tree's leaves (a target network)."""
    return tree_map(lambda t: t.detach().clone(), tree)


@torch.no_grad()
def polyak(target, online, tau: float) -> None:
    """target <- (1 - tau) * target + tau * online, leaf by leaf, in place
    (tau=1 is a hard copy)."""
    for t, o in zip(tree_leaves(target), tree_leaves(online)):
        t.copy_((1 - tau) * t + tau * o.detach())


@torch.no_grad()
def load_tree(dst, src) -> None:
    """Copy a tree of tensors or numpy arrays into ``dst``'s leaves."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(torch.as_tensor(s))


# ------------------------------------------------------------------ learner
class DQNLearner(Learner):
    """Double-DQN Huber loss with target network
    (reference: dqn_torch_learner.py compute_loss_for_module)."""

    def __init__(self, module_spec, config, use_mesh: bool = False,
                 device=None):
        # one process's learner: the target params are read by the loss as
        # they are, so the update does not run on the data mesh
        super().__init__(module_spec, config, use_mesh=False, device=device)
        self.target_params = copy_tree(self.params)

    def loss(self, params, batch):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        q_all = self.module.q_values(params, batch["obs"])
        q_sa = q_all.gather(1, batch["actions"].long()[:, None])[:, 0]
        with torch.no_grad():
            # double DQN: online net picks a*, target net evaluates it
            next_online = self.module.q_values(params, batch["next_obs"])
            a_star = torch.argmax(next_online, dim=-1)
            next_target = self.module.q_values(self.target_params,
                                               batch["next_obs"])
            q_next = next_target.gather(1, a_star[:, None])[:, 0]
            target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * \
                q_next
        td = q_sa - target
        loss_terms = huber(td)
        weights = batch.get("weights")
        loss = torch.mean(loss_terms * weights) if weights is not None \
            else torch.mean(loss_terms)
        return loss, {"td_error_mean": torch.mean(td.abs()),
                      "qf_mean": torch.mean(q_sa), "td_error": td}

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        batch = dict(batch)
        idx = batch.pop("batch_indexes", None)
        # epsilon is exploration state, not a trainable: the loss does not
        # read it, so its grad is zero and Adam leaves it where it is
        metrics = self.compute_grads(self._batch(batch))
        self.opt_state.step()
        metrics.pop("grad_norm")
        td = metrics.pop("td_error").cpu().numpy()
        out = {k: float(v) for k, v in metrics.items()}
        out["_td_error"] = td
        out["_batch_indexes"] = idx
        return out

    def sync_target(self, tau: float = 1.0) -> None:
        """Hard (tau=1) or polyak target update."""
        polyak(self.target_params, self.params, tau)

    def set_epsilon(self, eps: float) -> None:
        with torch.no_grad():
            self.params["epsilon"].fill_(eps)

    def get_state(self) -> Dict:
        s = super().get_state()
        s["target_params"] = cpu_snapshot(self.target_params)
        return s

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        load_tree(self.target_params, state["target_params"])


# ---------------------------------------------------------------- algorithm
class DQNConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DQN)
        self.lr = 5e-4
        self.train_batch_size = 32
        self.replay_buffer_capacity = 50_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # env steps
        self.training_intensity = 1.0  # updates per env step sampled
        self.epsilon = [(0, 1.0), (10_000, 0.05)]  # linear schedule
        self.double_q = True
        self.dueling = True
        self.prioritized_replay = False
        self.rollout_fragment_length = 4
        self.num_env_runners = 1

    def _training_keys(self):
        return {"replay_buffer_capacity", "target_network_update_freq",
                "num_steps_sampled_before_learning_starts", "epsilon",
                "double_q", "dueling", "prioritized_replay",
                "training_intensity"}

    def module_spec(self) -> DQNModuleSpec:
        base = super().module_spec()
        if not base.discrete:
            raise ValueError("DQN supports discrete action spaces only")
        return DQNModuleSpec(
            obs_dim=base.obs_dim, action_dim=base.action_dim,
            hiddens=tuple(self.model.get("hiddens", (64, 64))),
            activation=self.model.get("activation", "relu"),
            dueling=self.dueling)


def add_transitions(replay, samples) -> None:
    """The runners' fragments, flattened to rows without the autoreset
    steps, into a flat replay buffer."""
    for s in samples:
        flat = lambda a: a.reshape((-1,) + a.shape[2:])
        mask = flat(s["valid"])
        replay.add_batch({
            "obs": flat(s["obs"])[mask],
            "actions": flat(s["actions"])[mask],
            "rewards": flat(s["rewards"])[mask],
            "next_obs": flat(s["next_obs"])[mask],
            "dones": flat(s["dones"])[mask],
        })


class DQN(Algorithm):
    learner_cls = DQNLearner

    @classmethod
    def get_default_config(cls):
        return DQNConfig(algo_class=cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self.config
        self.replay = (PrioritizedReplayBuffer(cfg.replay_buffer_capacity,
                                               seed=cfg.seed)
                       if cfg.prioritized_replay
                       else ReplayBuffer(cfg.replay_buffer_capacity,
                                         seed=cfg.seed))
        self._steps_since_target_sync = 0

    def _make_runner(self, idx: int):
        cfg = self.config
        from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

        return ray_tpu_torch.remote(SingleAgentEnvRunner).options(
            resources={"CPU": 1}).remote(
                cfg.make_env(), cfg.num_envs_per_env_runner,
                cfg.rollout_fragment_length, self._module_spec,
                seed=cfg.seed + idx * 1000 + 1, explore=cfg.explore,
                gamma=cfg.gamma, collect_next_obs=True,
                connector=cfg.connector)

    def _epsilon_at(self, step: int) -> float:
        from ray_tpu_torch.rllib.utils.schedules import piecewise_linear

        return piecewise_linear(self.config.epsilon, step)

    def training_step(self) -> Dict:
        cfg = self.config
        learner = self.learner_group.local_learner()
        learner.set_epsilon(self._epsilon_at(self._total_env_steps))
        weights_ref = ray_tpu_torch.put(learner.get_weights())

        samples = self._sample_from_runners(weights_ref)
        new_steps = sum(s["env_steps"] for s in samples)
        add_transitions(self.replay, samples)

        metrics: Dict = {"env_steps_this_iter": new_steps}
        if len(self.replay) < cfg.num_steps_sampled_before_learning_starts:
            return metrics

        num_updates = max(1, int(new_steps * cfg.training_intensity /
                                 max(cfg.train_batch_size, 1)))
        for _ in range(num_updates):
            batch = self.replay.sample(cfg.train_batch_size)
            out = learner.update(batch)
            td = out.pop("_td_error", None)
            idx = out.pop("_batch_indexes", None)
            if idx is not None and td is not None and hasattr(
                    self.replay, "update_priorities"):
                self.replay.update_priorities(idx, td)
            metrics.update(out)
        self._steps_since_target_sync += new_steps
        if self._steps_since_target_sync >= cfg.target_network_update_freq:
            learner.sync_target()
            self._steps_since_target_sync = 0
        metrics["epsilon"] = self._epsilon_at(self._total_env_steps)
        return metrics
