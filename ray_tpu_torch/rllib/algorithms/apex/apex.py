# Copied from ray_tpu/rllib/algorithms/apex/apex.py (ray_tpu -> ray_tpu_torch).
"""Ape-X DQN — distributed prioritized replay (reference:
rllib/algorithms/dqn's APEX variant, Horgan et al. 2018: many parallel
actors with an exploration-epsilon ladder feed a CENTRAL prioritized
replay that lives off the learner, which trains at its own cadence).

Here the replay buffer is a dedicated actor: env runners' samples are
shipped to it, the learner pulls batches and sends priority updates back
— the driver never hosts the data, so replay capacity and sampling scale
independently of the learner process (the architectural point of Ape-X).
Per-runner epsilons follow the Ape-X ladder eps_i = eps^(1 + i/(N-1)*7).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.utils.replay_buffer import PrioritizedReplayBuffer


class ReplayActor:
    """Actor hosting the shared prioritized replay buffer."""

    def __init__(self, capacity: int, seed: int = 0, alpha: float = 0.6,
                 beta: float = 0.4):
        self._buffer = PrioritizedReplayBuffer(capacity, alpha=alpha,
                                               beta=beta, seed=seed)

    def add_batch(self, batch: Dict[str, np.ndarray]) -> int:
        self._buffer.add_batch(batch)
        return len(self._buffer)

    def sample(self, batch_size: int) -> Optional[Dict[str, np.ndarray]]:
        # sampling with replacement works below batch_size (matching the
        # local buffer's semantics); only an empty buffer has nothing
        if len(self._buffer) == 0:
            return None
        return self._buffer.sample(batch_size)

    def update_priorities(self, indexes, td_errors) -> bool:
        self._buffer.update_priorities(indexes, td_errors)
        return True

    def size(self) -> int:
        return len(self._buffer)


class _RemoteReplayFacade:
    """Duck-types the local buffer so DQN.training_step drives the actor
    unchanged."""

    def __init__(self, actor):
        self._actor = actor
        self._size = 0

    def add_batch(self, batch) -> None:
        self._size = ray_tpu_torch.get(self._actor.add_batch.remote(batch),
                                 timeout=120)

    def sample(self, batch_size: int):
        out = ray_tpu_torch.get(self._actor.sample.remote(batch_size),
                          timeout=120)
        if out is None:
            raise RuntimeError("replay actor is empty")
        return out

    def update_priorities(self, indexes, td_errors) -> None:
        self._actor.update_priorities.remote(indexes, td_errors)

    def __len__(self) -> int:
        return self._size


class ApexDQNConfig(DQNConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ApexDQN)
        self.num_env_runners = 2
        self.prioritized_replay = True
        self.apex_base_epsilon = 0.4
        self.apex_epsilon_exponent = 7.0

    def _training_keys(self):
        return super()._training_keys() | {
            "apex_base_epsilon", "apex_epsilon_exponent"}


class ApexDQN(DQN):
    @classmethod
    def get_default_config(cls):
        return ApexDQNConfig(algo_class=cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self.config
        # replace the driver-local buffer with the replay actor
        self._replay_actor = ray_tpu_torch.remote(ReplayActor).options(
            num_cpus=0.1).remote(cfg.replay_buffer_capacity, cfg.seed)
        self.replay = _RemoteReplayFacade(self._replay_actor)

    def _runner_epsilons(self) -> List[float]:
        cfg = self.config
        n = max(cfg.num_env_runners, 1)
        if n == 1:
            return [cfg.apex_base_epsilon]
        return [cfg.apex_base_epsilon **
                (1.0 + i / (n - 1) * cfg.apex_epsilon_exponent)
                for i in range(n)]

    def _sample_from_runners(self, weights_ref) -> List[Dict]:
        """Ape-X ladder: each runner explores at its own fixed epsilon
        (set through per-runner weights overrides)."""
        epsilons = self._runner_epsilons()
        base = ray_tpu_torch.get(weights_ref, timeout=60)
        refs = {}
        for i, runner in enumerate(self.env_runners):
            w = dict(base)
            w["epsilon"] = np.asarray(epsilons[i % len(epsilons)],
                                      np.float32)
            refs[runner.sample.remote(w)] = i
        out: List[Dict] = []
        for ref, idx in refs.items():
            try:
                out.append(ray_tpu_torch.get(ref, timeout=300))
            except Exception:
                if not self.config.restart_failed_env_runners:
                    raise
                self.env_runners[idx] = self._make_runner(idx)
        for s in out:
            self._total_env_steps += s["env_steps"]
            for ep in s["episodes"]:
                self._episode_returns.append(ep["episode_return"])
        return out

    def training_step(self) -> Dict:
        metrics = super().training_step()
        metrics["runner_epsilons"] = self._runner_epsilons()
        metrics["replay_actor_size"] = len(self.replay)
        return metrics
