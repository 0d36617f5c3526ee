# Ported from ray_tpu/rllib/algorithms/ppo/multi_agent.py (ray_tpu -> ray_tpu_torch).
"""Multi-agent PPO (reference: RLlib's multi-agent support —
AlgorithmConfig.multi_agent(policies, policy_mapping_fn) and the
multi-agent train batch split in algorithm.py/rollout_worker.py; each
policy gets its own module + optimizer and learns only from the agents
mapped to it).

Per-policy updates are independent PPO learners, each on
``config.learner_device``; shared-policy
self-play is the policies={'shared'} + constant mapping special case.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import is_discrete
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig
from ray_tpu_torch.rllib.core.learner import PPOLearner
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnvRunner


def _stream_gae(rewards, vf, dones, gamma, lam):
    """GAE over a single row stream; fragment end bootstraps with 0 (the
    stream is cut mid-episode at worst — small, standard bias)."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    next_vf = 0.0
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_vf * nonterminal - vf[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
        next_vf = vf[t]
    return adv, adv + vf


class MultiAgentPPOConfig(PPOConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or MultiAgentPPO)
        self.policies: List[str] = []
        self.policy_mapping_fn: Callable[[str], str] = lambda aid: "default"
        self.num_env_runners = 2
        self.train_batch_size = 512

    def multi_agent(self, *, policies: List[str],
                    policy_mapping_fn: Callable[[str], str]
                    ) -> "MultiAgentPPOConfig":
        self.policies = list(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self

    def _training_keys(self):
        return super()._training_keys() | {"policies", "policy_mapping_fn"}

    def multi_module_specs(self) -> Dict[str, RLModuleSpec]:
        """One spec per policy, derived from a mapped agent's spaces
        (read by duck typing)."""
        probe = self.make_env()()
        try:
            specs: Dict[str, RLModuleSpec] = {}
            for agent_id in probe.possible_agents:
                pid = self.policy_mapping_fn(agent_id)
                if pid in specs:
                    continue
                obs_space = probe.observation_spaces[agent_id]
                act_space = probe.action_spaces[agent_id]
                discrete = is_discrete(act_space)
                specs[pid] = RLModuleSpec(
                    obs_dim=int(obs_space.shape[0]),
                    action_dim=(int(act_space.n) if discrete
                                else int(act_space.shape[0])),
                    discrete=discrete,
                    hiddens=tuple(self.model.get("hiddens", (64, 64))),
                    activation=self.model.get("activation", "tanh"))
            missing = set(self.policies) - set(specs)
            if missing:
                raise ValueError(
                    f"policies {sorted(missing)} not reachable by "
                    "policy_mapping_fn from any possible agent")
            return specs
        finally:
            probe.close()


class MultiAgentPPO(Algorithm):
    @classmethod
    def get_default_config(cls):
        return MultiAgentPPOConfig(algo_class=cls)

    def setup(self, _config) -> None:
        cfg = self.config = self._algo_config
        if not cfg.policies:
            raise ValueError(
                "MultiAgentPPO requires config.multi_agent(policies=...)")
        self._module_specs = cfg.multi_module_specs()
        lcfg = cfg.learner_config_dict()
        self.learners: Dict[str, PPOLearner] = {
            pid: PPOLearner(spec, lcfg, device=cfg.learner_device)
            for pid, spec in self._module_specs.items()}
        self.env_runners = [self._make_runner(i)
                            for i in range(cfg.num_env_runners)]
        self._total_env_steps = 0
        self._episode_returns: List[float] = []

    def _make_runner(self, idx: int):
        cfg = self.config
        return ray_tpu_torch.remote(MultiAgentEnvRunner).options(
            resources={"CPU": 1}).remote(
                cfg.make_env(), cfg.rollout_fragment_length,
                self._module_specs, cfg.policy_mapping_fn,
                seed=cfg.seed + idx * 1000 + 1, gamma=cfg.gamma)

    def get_weights(self) -> Dict[str, Dict]:
        return {pid: ln.get_weights() for pid, ln in self.learners.items()}

    def training_step(self) -> Dict:
        cfg = self.config
        weights_ref = ray_tpu_torch.put(self.get_weights())
        merged: Dict[str, Dict[str, List[np.ndarray]]] = {
            pid: {"obs": [], "actions": [], "logp": [], "advantages": [],
                  "value_targets": []}
            for pid in self.learners}
        env_steps = 0
        while env_steps < cfg.train_batch_size:
            parts = self._sample_from_runners(weights_ref)
            if not parts:
                break
            for s in parts:
                env_steps += s["env_steps"]
                for pid, per_agent in s["agent_batches"].items():
                    # GAE per agent stream (time recursion must never
                    # cross agents), then rows pool per policy
                    for b in per_agent.values():
                        adv, vt = _stream_gae(
                            b["rewards"], b["vf"], b["dones"],
                            cfg.gamma, cfg.lambda_)
                        merged[pid]["obs"].append(b["obs"])
                        merged[pid]["actions"].append(b["actions"])
                        merged[pid]["logp"].append(b["logp"])
                        merged[pid]["advantages"].append(adv)
                        merged[pid]["value_targets"].append(vt)

        metrics: Dict = {"env_steps_this_iter": env_steps}
        for pid, cols in merged.items():
            if not cols["obs"]:
                continue
            batch = {k: np.concatenate(v) for k, v in cols.items()}
            pm = self.learners[pid].update(batch)
            metrics.update({f"{pid}/{k}": v for k, v in pm.items()})
        return metrics

    @torch.no_grad()
    def compute_single_action(self, obs, policy_id: str = "default",
                              explore: bool = False):
        module = self._module_specs[policy_id].build()
        obs = torch.from_numpy(np.asarray(obs, np.float32))[None]
        out = module.forward(self.learners[policy_id].get_weights(), obs)
        logits = out["logits"].numpy()[0]
        if module.spec.discrete:
            return int(np.argmax(logits))
        return np.tanh(logits[:module.spec.action_dim])

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        state = {pid: ln.get_state() for pid, ln in self.learners.items()}
        with open(os.path.join(checkpoint_dir, "ma_learners.pkl"),
                  "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        with open(os.path.join(checkpoint_dir, "ma_learners.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        for pid, st in state.items():
            self.learners[pid].set_state(st)

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
