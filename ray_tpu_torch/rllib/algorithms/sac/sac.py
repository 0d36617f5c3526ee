# Ported from ray_tpu/rllib/algorithms/sac/sac.py (ray_tpu -> ray_tpu_torch).
"""SAC — soft actor-critic with twin Q critics, polyak targets, and
auto-tuned temperature (reference: rllib/algorithms/sac/sac.py +
sac/torch/sac_torch_learner.py; Haarnoja 2018).

One update covers the critic, actor and alpha losses — one backward
through their sum, one Adam step over every leaf, ``log_alpha`` included,
then the polyak step of the target critics. The losses take their
standard-normal draws as tensors (``draws``); the learner's
``torch.Generator`` makes them before the call, so a caller can feed the
same draws to two learners.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import (
    add_transitions, copy_tree, load_tree, polyak)
from ray_tpu_torch.rllib.core.learner import cpu_snapshot
from ray_tpu_torch.rllib.core.rl_module import (
    ACTIVATIONS, mlp_forward, mlp_params)
from ray_tpu_torch.rllib.utils.replay_buffer import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


# ------------------------------------------------------------------- module
@dataclasses.dataclass
class SACModuleSpec:
    """Actor + twin critics (reference: sac/sac_rl_module.py)."""

    obs_dim: int
    action_dim: int
    discrete: bool = False  # SAC here is continuous-only
    hiddens: Tuple[int, ...] = (256, 256)
    activation: str = "relu"

    def build(self) -> "SACModule":
        return SACModule(self)


def _squashed_logp(raw, mean, log_std):
    """log N(raw; mean, std) with the tanh-squash correction (SAC appendix
    C), summed over the action dims."""
    std = torch.exp(log_std)
    logp_raw = torch.sum(
        -0.5 * ((raw - mean) / std) ** 2 - log_std
        - 0.5 * math.log(2 * math.pi), dim=-1)
    return logp_raw - torch.sum(
        2.0 * (math.log(2.0) - raw - F.softplus(-2.0 * raw)), dim=-1)


class SACModule:
    def __init__(self, spec: SACModuleSpec):
        self.spec = spec
        self._act = ACTIVATIONS[spec.activation]

    def init(self, generator: torch.Generator) -> Dict:
        h = self.spec.hiddens
        obs, act = self.spec.obs_dim, self.spec.action_dim
        return {
            "actor": mlp_params(generator, (obs, *h, 2 * act),
                                final_scale=1.0),
            "q1": mlp_params(generator, (obs + act, *h, 1), final_scale=1.0),
            "q2": mlp_params(generator, (obs + act, *h, 1), final_scale=1.0),
            "log_alpha": torch.tensor(0.0, device=generator.device),
        }

    def _mean_log_std(self, params, obs):
        out = mlp_forward(params["actor"], obs, self._act)
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return mean, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    # squashed-Gaussian policy
    def pi(self, params, obs, noise: torch.Tensor):
        """(action, its logp, the greedy action) for standard-normal
        ``noise`` of the actions' shape; ``obs`` may carry leading sample
        dims beyond the batch's (one set of draws a sample)."""
        mean, log_std = self._mean_log_std(params, obs)
        raw = mean + torch.exp(log_std) * noise
        return torch.tanh(raw), _squashed_logp(raw, mean, log_std), \
            torch.tanh(mean)

    def q(self, params, obs, action):
        x = torch.cat([obs, action], dim=-1)
        return (mlp_forward(params["q1"], x, self._act)[..., 0],
                mlp_forward(params["q2"], x, self._act)[..., 0])

    def logp(self, params, obs, action):
        """Log-density of a GIVEN squashed action under the current
        policy (offline learners — CRR/AWR-style — regress onto dataset
        actions, so they need logp at arbitrary a, not just samples)."""
        mean, log_std = self._mean_log_std(params, obs)
        raw = torch.atanh(torch.clamp(action, -1.0 + 1e-6, 1.0 - 1e-6))
        return _squashed_logp(raw, mean, log_std)

    # env-runner interface
    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        out = mlp_forward(params["actor"], obs, self._act)
        mean, _ = torch.chunk(out, 2, dim=-1)
        q1, _ = self.q(params, obs, torch.tanh(mean))
        return {"logits": out, "vf": q1}

    def explore_action(self, params, obs, generator: torch.Generator):
        noise = torch.randn(obs.shape[:-1] + (self.spec.action_dim,),
                            generator=generator, device=obs.device)
        action, logp, _ = self.pi(params, obs, noise)
        q1, _ = self.q(params, obs, action)
        return action, logp, q1

    def greedy_action(self, params, obs):
        mean, _ = self._mean_log_std(params, obs)
        action = torch.tanh(mean)
        q1, _ = self.q(params, obs, action)
        zeros = torch.zeros(action.shape[:-1], device=action.device)
        return action, zeros, q1


# ------------------------------------------------------------ learner parts
def batch_tensors(batch: Dict[str, np.ndarray], device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """A numpy batch as fp32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32).to(device)
            for k, v in batch.items()}


def adam_step(opt: torch.optim.Optimizer, params) -> None:
    """One step over every leaf: a leaf without a grad gets a zero one, so
    that Adam moves it on its moments as optax moves every leaf."""
    for p in tree_leaves(params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()


class _ReplayLearner:
    """What the off-policy actor-critic learners share: the params on
    ``device`` (None: the CUDA card, which raises without one), a
    ``torch.Generator`` seeded from the config for the init and the
    losses' draws, ``torch.optim.Adam`` over every leaf (optax.adam: eps
    outside the square root, bias-corrected), and the Learner duck-type
    (weights and state as CPU tensors)."""

    def __init__(self, module_spec, config: Dict, lr_default: float,
                 device=None):
        self.device = resolve_device(device)
        self.module = module_spec.build()
        self.config = config
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.get("seed", 0))
        params = self.module.init(self._gen)
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.opt = torch.optim.Adam(tree_leaves(self.params),
                                    lr=config.get("lr", lr_default),
                                    eps=1e-8)

    def _randn(self, *shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen, device=self.device)

    def _draws_to(self, draws: Dict) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device, torch.float32)
                for k, v in draws.items()}

    # Learner duck-type
    def get_weights(self):
        return cpu_snapshot(self.params)

    def set_weights(self, weights) -> None:
        load_tree(self.params, weights)

    def get_state(self) -> Dict:
        return {"params": cpu_snapshot(self.params),
                "target_params": cpu_snapshot(self.target_params),
                "opt_state": cpu_snapshot(self.opt.state_dict())}

    def set_state(self, state: Dict) -> None:
        load_tree(self.params, state["params"])
        load_tree(self.target_params, state["target_params"])
        self.opt.load_state_dict(state["opt_state"])


# ------------------------------------------------------------------ learner
class SACLearner(_ReplayLearner):
    """Critic + actor + temperature updates (reference:
    sac_torch_learner.py compute_loss_for_module). One Adam over all the
    params, so it implements the Learner duck-type rather than subclassing
    the PG Learner."""

    def __init__(self, module_spec: SACModuleSpec, config: Dict,
                 use_mesh: bool = True, device=None):
        super().__init__(module_spec, config, 3e-4, device)
        self.target_params = copy_tree(
            {"q1": self.params["q1"], "q2": self.params["q2"]})
        self.target_entropy = config.get(
            "target_entropy", -float(module_spec.action_dim))

    def _draws(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The losses' standard-normal draws: the target actions' at
        next_obs and the actor's at obs."""
        a = self.module.spec.action_dim
        return {"next": self._randn(batch_size, a),
                "pi": self._randn(batch_size, a)}

    def _losses(self, params, target_params, batch, draws):
        """Joint critic+actor+alpha loss; overridable (CQL adds its
        conservative penalty on top, reference: cql_torch_learner)."""
        gamma = self.config.get("gamma", 0.99)
        alpha = torch.exp(params["log_alpha"])
        # ---- critic target (no gradient)
        with torch.no_grad():
            next_a, next_logp, _ = self.module.pi(
                params, batch["next_obs"], draws["next"])
            tq1, tq2 = self.module.q(
                {**params, "q1": target_params["q1"],
                 "q2": target_params["q2"]},
                batch["next_obs"], next_a)
            q_next = torch.minimum(tq1, tq2) - alpha * next_logp
            target = batch["rewards"] + gamma * (1 - batch["dones"]) * \
                q_next
        q1, q2 = self.module.q(params, batch["obs"], batch["actions"])
        critic_loss = torch.mean((q1 - target) ** 2) + \
            torch.mean((q2 - target) ** 2)
        # ---- actor: the critics are evaluated on detached copies of their
        # leaves, so the actor loss trains the actor through the action only
        new_a, logp, _ = self.module.pi(params, batch["obs"], draws["pi"])
        frozen = {**params, "q1": copy_tree(params["q1"]),
                  "q2": copy_tree(params["q2"])}
        pq1, pq2 = self.module.q(frozen, batch["obs"], new_a)
        actor_loss = torch.mean(alpha.detach() * logp
                                - torch.minimum(pq1, pq2))
        # ---- temperature
        alpha_loss = -torch.mean(
            params["log_alpha"] * (logp + self.target_entropy).detach())
        total = critic_loss + actor_loss + alpha_loss
        return total, {
            "critic_loss": critic_loss, "actor_loss": actor_loss,
            "alpha_loss": alpha_loss, "alpha": alpha,
            "qf_mean": torch.mean(q1), "entropy": -torch.mean(logp),
        }

    def update(self, batch: Dict[str, np.ndarray],
               draws: Optional[Dict] = None) -> Dict[str, float]:
        """One update; ``draws`` (the ``_draws`` layout, tensors or numpy)
        replaces the generator's."""
        tb = batch_tensors(batch, self.device)
        draws = (self._draws(len(tb["obs"])) if draws is None
                 else self._draws_to(draws))
        self.opt.zero_grad(set_to_none=True)
        loss, metrics = self._losses(self.params, self.target_params, tb,
                                     draws)
        loss.backward()
        adam_step(self.opt, self.params)
        polyak(self.target_params,
               {"q1": self.params["q1"], "q2": self.params["q2"]},
               self.config.get("tau", 0.005))
        metrics["total_loss"] = loss
        return {k: float(v.detach()) for k, v in metrics.items()}


# ---------------------------------------------------------------- algorithm
class SACConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or SAC)
        self.lr = 3e-4
        self.train_batch_size = 256
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1500
        self.tau = 0.005
        self.target_entropy = None  # None -> -action_dim
        self.training_intensity = 1.0
        self.rollout_fragment_length = 1
        self.num_env_runners = 1
        self.model = {"hiddens": (256, 256), "activation": "relu"}

    def _training_keys(self):
        return {"replay_buffer_capacity", "tau", "target_entropy",
                "num_steps_sampled_before_learning_starts",
                "training_intensity"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d["tau"] = self.tau
        if self.target_entropy is not None:
            d["target_entropy"] = self.target_entropy
        return d

    def module_spec(self) -> SACModuleSpec:
        base = super().module_spec()
        if base.discrete:
            raise ValueError("this SAC implements continuous control only")
        return SACModuleSpec(
            obs_dim=base.obs_dim, action_dim=base.action_dim,
            hiddens=tuple(self.model.get("hiddens", (256, 256))),
            activation=self.model.get("activation", "relu"))


class SAC(Algorithm):
    learner_cls = SACLearner

    @classmethod
    def get_default_config(cls):
        return SACConfig(algo_class=cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        self.replay = ReplayBuffer(self.config.replay_buffer_capacity,
                                   seed=self.config.seed)

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

    def training_step(self) -> Dict:
        cfg = self.config
        learner = self.learner_group.local_learner()
        weights_ref = ray_tpu_torch.put(learner.get_weights())

        samples = self._sample_from_runners(weights_ref)
        new_steps = sum(s["env_steps"] for s in samples)
        add_transitions(self.replay, samples)

        metrics: Dict = {"env_steps_this_iter": new_steps}
        if len(self.replay) < cfg.num_steps_sampled_before_learning_starts:
            return metrics
        # training_intensity = replayed/sampled step ratio (same semantics
        # as DQN): updates * batch_size ~= new_steps * intensity
        num_updates = max(1, int(new_steps * cfg.training_intensity /
                                 max(cfg.train_batch_size, 1)))
        for _ in range(num_updates):
            metrics.update(learner.update(
                self.replay.sample(cfg.train_batch_size)))
        return metrics
