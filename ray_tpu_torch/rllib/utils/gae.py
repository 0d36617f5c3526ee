# Copied from ray_tpu/rllib/utils/gae.py (ray_tpu -> ray_tpu_torch).
"""Generalized Advantage Estimation (reference:
rllib/evaluation/postprocessing.py compute_gae_for_sample_batch).

Vectorized over (T, E) rollout fragments in numpy; bootstrap from the value
of the final observation, with episode boundaries cutting the recursion.
"""

from __future__ import annotations

import numpy as np


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                dones: np.ndarray, last_values: np.ndarray,
                gamma: float = 0.99, lam: float = 0.95):
    """rewards/values/dones: (T, E); last_values: (E,).

    Returns (advantages, value_targets), both (T, E).
    """
    T = rewards.shape[0]
    adv = np.zeros_like(rewards)
    not_done = 1.0 - dones.astype(rewards.dtype)
    gae = np.zeros_like(last_values)
    next_values = last_values
    for t in range(T - 1, -1, -1):
        delta = rewards[t] + gamma * next_values * not_done[t] - values[t]
        gae = delta + gamma * lam * not_done[t] * gae
        adv[t] = gae
        next_values = values[t]
    return adv, adv + values
