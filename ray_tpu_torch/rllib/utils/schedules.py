# Copied from ray_tpu/rllib/utils/schedules.py (ray_tpu -> ray_tpu_torch).
"""Piecewise-linear schedules (reference: rllib/utils/schedules/
piecewise_schedule.py — the exploration-epsilon / lr schedule shape).

One shared implementation for every epsilon-greedy algorithm (DQN, R2D2,
QMIX, Ape-X): duplicated per-algorithm copies interpolated only between
the first and last points, silently dropping documented midpoints.
"""

from __future__ import annotations

from typing import List, Tuple


def piecewise_linear(schedule: List[Tuple[int, float]], step: int) -> float:
    """Interpolate over ADJACENT (step, value) pairs; clamps outside the
    range. A 3-point schedule like [(0, 1.0), (1000, 0.1), (10000, 0.05)]
    honors the fast initial decay instead of one flat ramp."""
    if not schedule:
        raise ValueError("empty schedule")
    if step <= schedule[0][0]:
        return schedule[0][1]
    for (s0, v0), (s1, v1) in zip(schedule[:-1], schedule[1:]):
        if step <= s1:
            frac = (step - s0) / max(s1 - s0, 1)
            return v0 + frac * (v1 - v0)
    return schedule[-1][1]
