# Copied from ray_tpu/rllib/offline/estimators.py (ray_tpu -> ray_tpu_torch).
"""Off-policy estimators (reference: rllib/offline/estimators/ —
ImportanceSampling, WeightedImportanceSampling, DirectMethod,
DoublyRobust; SURVEY §2.4 "offline data ... off-policy estimators").

Estimate a target policy's value from logged behavior-policy episodes
without running it (OPE). Input format: episodes as dicts with
``rewards`` [T], behavior ``logp`` [T], and the target policy's
``target_logp`` [T] on the logged actions (computed by the caller from
its module — keeps the estimators framework-agnostic math).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _per_episode_rho(ep: Dict, clip: float) -> np.ndarray:
    """Cumulative importance ratios rho_{0..t} for one episode."""
    log_ratio = np.asarray(ep["target_logp"], np.float64) - \
        np.asarray(ep["logp"], np.float64)
    rho = np.exp(np.cumsum(log_ratio))
    return np.clip(rho, 0.0, clip)


class ImportanceSampling:
    """Per-decision IS estimator (reference: estimators/
    importance_sampling.py): V = E[ sum_t gamma^t rho_{0..t} r_t ]."""

    def __init__(self, gamma: float = 0.99, rho_clip: float = 100.0):
        self.gamma = gamma
        self.rho_clip = rho_clip

    def estimate(self, episodes: List[Dict]) -> Dict[str, float]:
        vals = []
        for ep in episodes:
            rho = _per_episode_rho(ep, self.rho_clip)
            r = np.asarray(ep["rewards"], np.float64)
            disc = self.gamma ** np.arange(len(r))
            vals.append(float(np.sum(disc * rho * r)))
        v = np.asarray(vals)
        return {"v_target": float(v.mean()),
                "v_target_std": float(v.std()),
                "num_episodes": len(vals)}


class WeightedImportanceSampling:
    """Per-decision WIS (reference: estimators/weighted_importance_
    sampling.py): ratios normalized by their per-step mean across
    episodes — biased but much lower variance than IS."""

    def __init__(self, gamma: float = 0.99, rho_clip: float = 100.0):
        self.gamma = gamma
        self.rho_clip = rho_clip

    def estimate(self, episodes: List[Dict]) -> Dict[str, float]:
        T = max(len(ep["rewards"]) for ep in episodes)
        rhos = np.zeros((len(episodes), T))
        alive = np.zeros((len(episodes), T))
        for i, ep in enumerate(episodes):
            r = _per_episode_rho(ep, self.rho_clip)
            rhos[i, :len(r)] = r
            alive[i, :len(r)] = 1.0
        # per-step normalizer: mean rho over episodes still running
        denom = np.where(alive.sum(0) > 0,
                         rhos.sum(0) / np.maximum(alive.sum(0), 1), 1.0)
        vals = []
        for i, ep in enumerate(episodes):
            r = np.asarray(ep["rewards"], np.float64)
            t = len(r)
            w = rhos[i, :t] / np.maximum(denom[:t], 1e-12)
            disc = self.gamma ** np.arange(t)
            vals.append(float(np.sum(disc * w * r)))
        v = np.asarray(vals)
        return {"v_target": float(v.mean()),
                "v_target_std": float(v.std()),
                "num_episodes": len(vals)}


class DirectMethod:
    """DM estimator (reference: estimators/direct_method.py): value is the
    critic's estimate at initial states; no importance ratios. Needs
    ``v0`` per episode (the target policy's value prediction at s_0)."""

    def estimate(self, episodes: List[Dict]) -> Dict[str, float]:
        v = np.asarray([float(ep["v0"]) for ep in episodes])
        return {"v_target": float(v.mean()),
                "v_target_std": float(v.std()),
                "num_episodes": len(v)}


class DoublyRobust:
    """DR estimator (reference: estimators/doubly_robust.py): DM baseline
    plus per-decision IS correction of the critic's residuals. Needs
    per-step ``values`` (V(s_t)) and ``q_values`` (Q(s_t, a_t)) from the
    target policy's critic in each episode dict."""

    def __init__(self, gamma: float = 0.99, rho_clip: float = 100.0):
        self.gamma = gamma
        self.rho_clip = rho_clip

    def estimate(self, episodes: List[Dict]) -> Dict[str, float]:
        vals = []
        for ep in episodes:
            r = np.asarray(ep["rewards"], np.float64)
            v_t = np.asarray(ep["values"], np.float64)
            q_t = np.asarray(ep["q_values"], np.float64)
            rho = _per_episode_rho(ep, self.rho_clip)
            rho_prev = np.concatenate([[1.0], rho[:-1]])
            disc = self.gamma ** np.arange(len(r))
            # per-decision DR: V = sum_t gamma^t
            #   (rho_{t-1} V(s_t) - rho_t Q(s_t,a_t) + rho_t r_t)
            dr = np.sum(disc * (rho_prev * v_t - rho * q_t + rho * r))
            vals.append(float(dr))
        v = np.asarray(vals)
        return {"v_target": float(v.mean()),
                "v_target_std": float(v.std()),
                "num_episodes": len(vals)}
