# Ported from ray_tpu/rllib/algorithms/ddpg/ddpg.py (ray_tpu -> ray_tpu_torch).
"""DDPG + TD3 — deterministic-policy-gradient continuous control
(reference: rllib/algorithms/ddpg/ddpg.py and td3.py, externalized to
rllib_contrib in the snapshot; Lillicrap 2015, Fujimoto 2018).

One module/learner pair covers both: TD3 is DDPG with (a) twin critics
taking the min for the target, (b) target-policy smoothing noise, and
(c) delayed actor updates — all config flags here, defaulted per paper in
``TD3Config``. Target networks for actor and critics use polyak averaging.
The smoothing noise is a standard-normal draw the learner's
``torch.Generator`` makes before the loss (``draws``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import copy_tree, polyak
from ray_tpu_torch.rllib.algorithms.sac.sac import (
    SAC, _ReplayLearner, adam_step, batch_tensors)
from ray_tpu_torch.rllib.core.rl_module import (
    ACTIVATIONS, mlp_forward, mlp_params)


# ------------------------------------------------------------------- module
@dataclasses.dataclass
class DDPGModuleSpec:
    obs_dim: int
    action_dim: int
    discrete: bool = False
    hiddens: Tuple[int, ...] = (256, 256)
    activation: str = "relu"
    exploration_noise: float = 0.1  # sigma of the behavior Gaussian

    def build(self) -> "DDPGModule":
        return DDPGModule(self)


class DDPGModule:
    """tanh deterministic actor + twin Q towers (the second tower is
    ignored when twin_q=False)."""

    def __init__(self, spec: DDPGModuleSpec):
        self.spec = spec
        self._act = ACTIVATIONS[spec.activation]

    def init(self, generator: torch.Generator) -> Dict:
        h = self.spec.hiddens
        obs, act = self.spec.obs_dim, self.spec.action_dim
        return {
            "actor": mlp_params(generator, (obs, *h, act), final_scale=1.0),
            "q1": mlp_params(generator, (obs + act, *h, 1), final_scale=1.0),
            "q2": mlp_params(generator, (obs + act, *h, 1), final_scale=1.0),
        }

    def pi(self, params, obs):
        return torch.tanh(mlp_forward(params["actor"], obs, self._act))

    def q(self, params, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return (mlp_forward(params["q1"], x, self._act)[..., 0],
                mlp_forward(params["q2"], x, self._act)[..., 0])

    # env-runner interface
    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        action = self.pi(params, obs)
        q1, _ = self.q(params, obs, action)
        return {"logits": action, "vf": q1}

    def explore_action(self, params, obs, generator: torch.Generator):
        a = self.pi(params, obs)
        noise = self.spec.exploration_noise * torch.randn(
            a.shape, generator=generator, device=a.device)
        a = torch.clamp(a + noise, -1.0, 1.0)
        q1, _ = self.q(params, obs, a)
        return a, torch.zeros(a.shape[:-1], device=a.device), q1

    def greedy_action(self, params, obs):
        a = self.pi(params, obs)
        q1, _ = self.q(params, obs, a)
        return a, torch.zeros(a.shape[:-1], device=a.device), q1


# ------------------------------------------------------------------ learner
class DDPGLearner(_ReplayLearner):
    """Critic TD step + (possibly delayed) deterministic actor step
    (Learner duck-type like SACLearner)."""

    def __init__(self, module_spec: DDPGModuleSpec, config: Dict,
                 use_mesh: bool = True, device=None):
        super().__init__(module_spec, config, 1e-3, device)
        self.target_params = copy_tree(self.params)
        self._n_updates = 0

    def _draws(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The target-policy smoothing noise's standard-normal draw."""
        return {"target_noise": self._randn(batch_size,
                                            self.module.spec.action_dim)}

    def _losses(self, params, target_params, batch, draws):
        """(critic loss, actor loss, metrics)."""
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        twin_q = cfg.get("twin_q", False)
        smooth = cfg.get("target_noise", 0.0)
        noise_clip = cfg.get("noise_clip", 0.5)
        with torch.no_grad():
            next_a = self.module.pi(target_params, batch["next_obs"])
            if smooth > 0:
                eps = torch.clamp(smooth * draws["target_noise"],
                                  -noise_clip, noise_clip)
                next_a = torch.clamp(next_a + eps, -1.0, 1.0)
            tq1, tq2 = self.module.q(target_params, batch["next_obs"],
                                     next_a)
            q_next = torch.minimum(tq1, tq2) if twin_q else tq1
            target = batch["rewards"] + gamma * (1 - batch["dones"]) * \
                q_next
        q1, q2 = self.module.q(params, batch["obs"], batch["actions"])
        critic_loss = torch.mean((q1 - target) ** 2)
        if twin_q:
            critic_loss = critic_loss + torch.mean((q2 - target) ** 2)
        # the actor through the action only: the critic on detached leaves
        a = self.module.pi(params, batch["obs"])
        frozen = {**params, "q1": copy_tree(params["q1"]),
                  "q2": copy_tree(params["q2"])}
        actor_loss = -torch.mean(self.module.q(frozen, batch["obs"], a)[0])
        return critic_loss, actor_loss, {"critic_loss": critic_loss,
                                         "qf_mean": torch.mean(q1)}

    def update(self, batch: Dict[str, np.ndarray],
               draws: Optional[Dict] = None) -> Dict[str, float]:
        """One update; ``draws`` (the ``_draws`` layout) replaces the
        generator's."""
        self._n_updates += 1
        delay = self.config.get("policy_delay", 1)
        do_actor = (self._n_updates % delay) == 0
        tb = batch_tensors(batch, self.device)
        draws = (self._draws(len(tb["obs"])) if draws is None
                 else self._draws_to(draws))
        self.opt.zero_grad(set_to_none=True)
        critic_loss, actor_loss, metrics = self._losses(
            self.params, self.target_params, tb, draws)
        # delayed policy update: the actor's grads are zero on off ticks,
        # and Adam still steps it on its moments (as the reference's
        # masked grads do)
        (critic_loss + (1.0 if do_actor else 0.0) * actor_loss).backward()
        adam_step(self.opt, self.params)
        polyak(self.target_params, self.params, self.config.get("tau",
                                                                0.005))
        metrics["actor_loss"] = actor_loss
        return {k: float(v.detach()) for k, v in metrics.items()}

    def get_state(self) -> Dict:
        return dict(super().get_state(), n_updates=self._n_updates)

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        self._n_updates = state.get("n_updates", 0)


# ---------------------------------------------------------------- algorithm
class DDPGConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DDPG)
        self.lr = 1e-3
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1500
        self.tau = 0.005
        self.twin_q = False
        self.policy_delay = 1
        self.target_noise = 0.0
        self.noise_clip = 0.5
        self.exploration_noise = 0.1
        self.training_intensity = 1.0
        self.rollout_fragment_length = 1
        self.num_env_runners = 1
        self.model = {"hiddens": (256, 256), "activation": "relu"}

    def _training_keys(self):
        return {"replay_buffer_capacity", "tau", "twin_q", "policy_delay",
                "target_noise", "noise_clip", "exploration_noise",
                "num_steps_sampled_before_learning_starts",
                "training_intensity"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d.update({"tau": self.tau, "twin_q": self.twin_q,
                  "policy_delay": self.policy_delay,
                  "target_noise": self.target_noise,
                  "noise_clip": self.noise_clip})
        return d

    def module_spec(self) -> DDPGModuleSpec:
        base = super().module_spec()
        if base.discrete:
            raise ValueError("DDPG/TD3 are continuous-control only")
        return DDPGModuleSpec(
            obs_dim=base.obs_dim, action_dim=base.action_dim,
            hiddens=tuple(self.model.get("hiddens", (256, 256))),
            activation=self.model.get("activation", "relu"),
            exploration_noise=self.exploration_noise)


class TD3Config(DDPGConfig):
    """Fujimoto 2018 defaults (reference: rllib td3.py)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or TD3)
        self.twin_q = True
        self.policy_delay = 2
        self.target_noise = 0.2


class DDPG(SAC):
    """SAC's replay, runners and training step, with DDPG's learner."""

    learner_cls = DDPGLearner

    @classmethod
    def get_default_config(cls):
        return DDPGConfig(algo_class=cls)


class TD3(DDPG):
    @classmethod
    def get_default_config(cls):
        return TD3Config(algo_class=cls)
