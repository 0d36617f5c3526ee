# Ported from ray_tpu/rllib/utils/vtrace.py (ray_tpu -> ray_tpu_torch).
"""V-trace off-policy correction (reference: rllib/algorithms/impala/
vtrace_torch.py; Espeholt 2018 IMPALA eq. 1).

Tensors in, tensors out: the correction runs inside the learner's loss, on
the learner's device. The JAX package's ``lax.scan`` over the time axis is
a reverse loop over T here, and its ``stop_gradient`` is ``detach``.
"""

from __future__ import annotations

import torch


def vtrace(behavior_logp, target_logp, rewards, values, dones, bootstrap,
           gamma: float = 0.99, clip_rho: float = 1.0, clip_c: float = 1.0):
    """All inputs (T, B); bootstrap (B,). Returns (vs, pg_advantages).

    vs_t = V(x_t) + sum_k gamma^k (prod c) rho_k delta_k  computed as the
    standard backward recursion: acc_t = delta_t + gamma c_t acc_{t+1}.
    """
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=clip_rho)
    c = torch.clamp(ratio, max=clip_c)
    not_done = 1.0 - dones

    next_values = torch.cat([values[1:], bootstrap[None]], dim=0)
    # episode boundaries cut the bootstrap
    deltas = rho * (rewards + gamma * next_values * not_done - values)

    acc = torch.zeros_like(bootstrap)
    accs = [None] * deltas.shape[0]
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * c[t] * not_done[t] * acc
        accs[t] = acc
    vs = values + torch.stack(accs)

    next_vs = torch.cat([vs[1:], bootstrap[None]], dim=0)
    pg_adv = rho * (rewards + gamma * next_vs * not_done - values)
    return vs.detach(), pg_adv.detach()
