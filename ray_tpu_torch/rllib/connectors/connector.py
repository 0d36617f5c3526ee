# Copied from ray_tpu/rllib/connectors/connector.py (ray_tpu -> ray_tpu_torch).
"""Connectors — observation/action transform pipelines between env and
module (reference: rllib/connectors/ — agent connectors transform obs on
the way into inference, action connectors transform the module's output
on the way to env.step; SURVEY §2.4 "connectors (agent/action pipelines,
connectors/ 5.0k)").

Connectors here are stateful per-env transforms running CPU-side in the
env runner's hot loop, so they stay numpy (the jitted module sees the
transformed, fixed-shape batch).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform. ``on_obs`` maps the env observation batch before
    inference (``reset_mask[i]`` flags envs whose obs starts a fresh
    episode — stateful connectors clear that env's history); ``on_action``
    maps the module's action batch before env.step."""

    def on_obs(self, obs: np.ndarray,
               reset_mask: Optional[np.ndarray] = None) -> np.ndarray:
        return obs

    def on_action(self, action: np.ndarray) -> np.ndarray:
        return action

    def on_episode_start(self) -> None:
        pass

    def state(self) -> Dict[str, Any]:
        return {}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class ConnectorPipeline(Connector):
    """Obs transforms run in order; action transforms in reverse order
    (reference: connector_pipeline_v2)."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors = list(connectors or [])

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def on_obs(self, obs: np.ndarray,
               reset_mask: Optional[np.ndarray] = None) -> np.ndarray:
        for c in self.connectors:
            obs = c.on_obs(obs, reset_mask)
        return obs

    def on_action(self, action: np.ndarray) -> np.ndarray:
        for c in reversed(self.connectors):
            action = c.on_action(action)
        return action

    def on_episode_start(self) -> None:
        for c in self.connectors:
            c.on_episode_start()

    def state(self) -> Dict[str, Any]:
        return {str(i): c.state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: Dict[str, Any]) -> None:
        for i, c in enumerate(self.connectors):
            if str(i) in state:
                c.set_state(state[str(i)])

    @property
    def obs_multiplier(self) -> int:
        """Product of the pipeline's obs-dim multipliers (FrameStack k)."""
        m = 1
        for c in self.connectors:
            m *= getattr(c, "obs_dim_multiplier", 1)
        return m


class NormalizeObs(Connector):
    """Running mean/std normalization (reference: MeanStdFilter agent
    connector). Batched Chan/parallel-Welford merge — O(1) python ops per
    observation batch (this runs in the env runner's hot loop)."""

    def __init__(self, clip: float = 10.0):
        self.clip = clip
        self._count = 0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def on_obs(self, obs: np.ndarray,
               reset_mask: Optional[np.ndarray] = None) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        flat = obs.reshape(-1, obs.shape[-1]).astype(np.float64)
        if self._mean is None:
            self._mean = np.zeros(obs.shape[-1], np.float64)
            self._m2 = np.ones(obs.shape[-1], np.float64)
        n_b = flat.shape[0]
        mean_b = flat.mean(axis=0)
        m2_b = ((flat - mean_b) ** 2).sum(axis=0)
        delta = mean_b - self._mean
        total = self._count + n_b
        self._mean += delta * n_b / total
        self._m2 += m2_b + delta ** 2 * self._count * n_b / total
        self._count = total
        std = np.sqrt(self._m2 / max(self._count, 2)).astype(np.float32)
        out = (obs - self._mean.astype(np.float32)) / np.maximum(std, 1e-6)
        return np.clip(out, -self.clip, self.clip)

    def state(self) -> Dict[str, Any]:
        return {"count": self._count,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self._count = state["count"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class FrameStack(Connector):
    """Stack the last k observations along the feature axis, with
    PER-ENV history (reference: frame-stacking agent connector). An env's
    rows clear at its episode boundary via ``reset_mask``."""

    def __init__(self, k: int = 4):
        self.k = k
        self.obs_dim_multiplier = k
        self._stack: Optional[np.ndarray] = None  # [E, k, F]

    def on_episode_start(self) -> None:
        self._stack = None

    def on_obs(self, obs: np.ndarray,
               reset_mask: Optional[np.ndarray] = None) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        batched = obs.ndim == 2
        view = obs if batched else obs[None]
        E, F = view.shape
        if self._stack is None or self._stack.shape[0] != E or \
                self._stack.shape[2] != F:
            self._stack = np.zeros((E, self.k, F), np.float32)
        elif reset_mask is not None and np.any(reset_mask):
            self._stack[np.asarray(reset_mask, bool)] = 0.0
        self._stack = np.roll(self._stack, -1, axis=1)
        self._stack[:, -1] = view
        out = self._stack.reshape(E, self.k * F)
        return out if batched else out[0]


class FlattenObs(Connector):
    """Flatten trailing obs dims to 1-D features (reference: flatten
    agent connector)."""

    def on_obs(self, obs: np.ndarray,
               reset_mask: Optional[np.ndarray] = None) -> np.ndarray:
        obs = np.asarray(obs, np.float32)
        if obs.ndim <= 2:
            return obs
        return obs.reshape(obs.shape[0], -1)


class ActionClip(Connector):
    """Clip continuous actions into the env's box (reference: clip_actions
    action connector)."""

    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low = low
        self.high = high

    def on_action(self, action: np.ndarray) -> np.ndarray:
        if np.issubdtype(np.asarray(action).dtype, np.floating):
            return np.clip(action, self.low, self.high)
        return action
