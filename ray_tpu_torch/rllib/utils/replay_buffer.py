# Copied from ray_tpu/rllib/utils/replay_buffer.py (ray_tpu -> ray_tpu_torch).
"""Replay buffers (reference: rllib/utils/replay_buffers/ —
EpisodeReplayBuffer / PrioritizedEpisodeReplayBuffer used by DQN/SAC).

Flat numpy ring buffers over transitions: contiguous arrays keep sampling a
single fancy-index gather, and the sampled minibatch ships to the learner as
one host→HBM transfer.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform ring buffer of (obs, action, reward, next_obs, done)."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def _init_storage(self, batch: Dict[str, np.ndarray]) -> None:
        self._storage = {
            k: np.empty((self.capacity,) + v.shape[1:], v.dtype)
            for k, v in batch.items()
        }

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Append N transitions given as row-stacked arrays."""
        n = len(next(iter(batch.values())))
        if self._storage is None:
            self._init_storage(batch)
        for k, v in batch.items():
            store = self._storage[k]
            first = min(n, self.capacity - self._idx)
            store[self._idx:self._idx + first] = v[:first]
            if first < n:  # wrap
                store[: n - first] = v[first:]
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._storage.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (reference:
    utils/replay_buffers/prioritized_episode_buffer.py; PER, Schaul 2015).
    Priorities default to max-seen so new transitions are sampled soon."""

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4,
                 seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._prios = np.zeros(capacity, np.float64)
        self._max_prio = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        start = self._idx
        super().add_batch(batch)
        idx = (start + np.arange(n)) % self.capacity
        self._prios[idx] = self._max_prio

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        p = self._prios[: self._size] ** self.alpha
        p = p / p.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=p)
        weights = (self._size * p[idx]) ** (-self.beta)
        out = {k: v[idx] for k, v in self._storage.items()}
        out["weights"] = (weights / weights.max()).astype(np.float32)
        out["batch_indexes"] = idx
        return out

    def update_priorities(self, idx: np.ndarray, prios: np.ndarray) -> None:
        prios = np.abs(prios) + 1e-6
        self._prios[idx] = prios
        self._max_prio = max(self._max_prio, float(prios.max()))


class SequenceReplayBuffer:
    """Fixed-length-sequence replay with stored recurrent state
    (reference: rllib/algorithms/r2d2 — replay of [B, T] sequences whose
    LSTM state at sequence start was recorded at collection time, so the
    learner resumes the net mid-episode instead of from zeros; Kapturowski
    2019 "stored state" strategy).

    Each stored item is one sequence: time-major arrays [T, ...] plus the
    (h, c) state at t=0. Sampling returns batch-major [B, T, ...] arrays
    and stacked states — one contiguous host->HBM transfer, same design
    rationale as the flat buffer above.
    """

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity  # in sequences
        self._storage: Optional[Dict[str, np.ndarray]] = None
        self._state_storage: Optional[tuple] = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_sequences(self, batch: Dict[str, np.ndarray],
                      state_in: tuple) -> None:
        """batch: time-major [T, N, ...] arrays (one fragment, N envs);
        state_in: per-env (h, c) at t=0, each [N, cell]."""
        n = next(iter(batch.values())).shape[1]
        if self._storage is None:
            self._storage = {
                k: np.empty((self.capacity,) + v.shape[:1] + v.shape[2:],
                            v.dtype)
                for k, v in batch.items()}
            self._state_storage = tuple(
                np.zeros((self.capacity,) + s.shape[1:], np.float32)
                for s in state_in)
        for j in range(n):  # sequences land as independent items
            for k, v in batch.items():
                self._storage[k][self._idx] = v[:, j]
            for store, s in zip(self._state_storage, state_in):
                store[self._idx] = s[j]
            self._idx = (self._idx + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        out = {k: v[idx] for k, v in self._storage.items()}
        out["state_in"] = tuple(s[idx] for s in self._state_storage)
        return out
