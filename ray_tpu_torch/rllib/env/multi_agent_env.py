# Ported from ray_tpu/rllib/env/multi_agent_env.py (ray_tpu -> ray_tpu_torch).
"""Multi-agent environments + rollout (reference: rllib/env/
multi_agent_env.py MultiAgentEnv and the multi-agent sampling path in
evaluation/rollout_worker.py — dict-keyed obs/rewards per agent, a
policy_mapping_fn routing each agent to a policy).

Per-policy inference batches are built by grouping live agents by their
mapped policy each step, so one forward serves all agents of a policy
regardless of how many are alive. Batch shapes vary
with the number of live agents; CPU-side inference handles that (ragged
steps are the nature of multi-agent), while learner updates stay
fixed-shape row batches.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.env.env_runner import (
    CPU, cpu_weights, one_thread)


class MultiAgentEnv:
    """Dict-keyed multi-agent env (reference: env/multi_agent_env.py).

    Contract: ``reset() -> (obs_dict, info_dict)``;
    ``step(action_dict) -> (obs, rewards, terminateds, truncateds, infos)``
    with per-agent dicts; terminateds/truncateds carry the special
    ``"__all__"`` key ending the episode for everyone.
    """

    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError

    def close(self) -> None:
        pass

    @property
    def observation_spaces(self) -> Dict[str, Any]:
        raise NotImplementedError

    @property
    def action_spaces(self) -> Dict[str, Any]:
        raise NotImplementedError


class MultiAgentEnvRunner:
    """Rollout actor for MultiAgentEnv (reference: the multi-agent branch
    of RolloutWorker.sample): collects per-POLICY row batches with
    per-agent GAE-ready reward/done streams. The modules run on the CPU,
    exploring with a CPU ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, env_creator: Callable[[], MultiAgentEnv],
                 rollout_fragment_length: int,
                 module_specs: Dict[str, Any],
                 policy_mapping_fn: Callable[[str], str],
                 seed: int = 0, gamma: float = 0.99):
        self.env = env_creator()
        self.T = rollout_fragment_length
        self.gamma = gamma
        self.policy_mapping_fn = policy_mapping_fn
        self.modules = {pid: spec.build()
                        for pid, spec in module_specs.items()}
        self._gen = torch.Generator(device=CPU).manual_seed(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._ep_return = 0.0
        self._ep_len = 0
        self._completed: List[Dict] = []

    def ping(self) -> bool:
        return True

    @torch.no_grad()
    def sample(self, weights: Dict[str, Any]) -> Dict[str, Any]:
        """Run T env steps; returns {"agent_batches": {pid: {agent_id:
        rows}}, "episodes": [...], "env_steps": n}. Rows are PER-AGENT
        streams so GAE's time recursion never crosses agents sharing a
        policy."""
        with one_thread():
            return self._sample({pid: cpu_weights(w)
                                 for pid, w in weights.items()})

    def _sample(self, weights: Dict[str, Any]) -> Dict[str, Any]:
        # per-(policy, agent) row buffers
        buf: Dict[tuple, Dict[str, List]] = {}

        def agent_buf(pid: str, agent_id: str) -> Dict[str, List]:
            return buf.setdefault((pid, agent_id), {
                "obs": [], "actions": [], "logp": [], "vf": [],
                "rewards": [], "dones": []})
        env_steps = 0
        t0 = time.perf_counter()
        for _ in range(self.T):
            # group live agents by policy for batched inference
            by_policy: Dict[str, List[str]] = {}
            for agent_id in self._obs:
                by_policy.setdefault(
                    self.policy_mapping_fn(agent_id), []).append(agent_id)
            actions: Dict[str, Any] = {}
            step_meta: Dict[str, tuple] = {}  # agent -> (pid, logp, vf)
            for pid, agent_ids in by_policy.items():
                batch = np.stack([np.asarray(self._obs[a], np.float32)
                                  for a in agent_ids])
                act, logp, vf = self.modules[pid].explore_action(
                    weights[pid], torch.from_numpy(batch), self._gen)
                act = np.asarray(act)
                logp, vf = np.asarray(logp), np.asarray(vf)
                for i, a in enumerate(agent_ids):
                    actions[a] = act[i]
                    step_meta[a] = (pid, logp[i], vf[i])
            obs2, rewards, terms, truncs, _ = self.env.step(actions)
            done_all = terms.get("__all__", False) or \
                truncs.get("__all__", False)
            for a, action in actions.items():
                pid, logp, vf = step_meta[a]
                done = bool(terms.get(a, False) or truncs.get(a, False)
                            or done_all)
                ab = agent_buf(pid, a)
                ab["obs"].append(np.asarray(self._obs[a], np.float32))
                ab["actions"].append(np.asarray(action))
                ab["logp"].append(np.float32(logp))
                ab["vf"].append(np.float32(vf))
                ab["rewards"].append(np.float32(rewards.get(a, 0.0)))
                ab["dones"].append(np.float32(done))
            self._ep_return += float(sum(rewards.values()))
            self._ep_len += 1
            env_steps += 1
            if done_all:
                self._completed.append({
                    "episode_return": self._ep_return,
                    "episode_len": self._ep_len})
                self._obs, _ = self.env.reset()
                self._ep_return, self._ep_len = 0.0, 0
            else:
                self._obs = obs2

        agent_batches: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
        for (pid, agent_id), cols in buf.items():
            if not cols["obs"]:
                continue
            agent_batches.setdefault(pid, {})[agent_id] = {
                k: np.stack(v) if k in ("obs", "actions")
                else np.asarray(v, np.float32)
                for k, v in cols.items()}
        episodes, self._completed = self._completed, []
        return {"agent_batches": agent_batches, "episodes": episodes,
                "env_steps": env_steps,
                "sample_time_s": time.perf_counter() - t0}

    def stop(self) -> bool:
        self.env.close()
        return True
