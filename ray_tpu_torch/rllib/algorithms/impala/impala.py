# Ported from ray_tpu/rllib/algorithms/impala/impala.py (ray_tpu -> ray_tpu_torch).
"""IMPALA — asynchronous actor-learner with V-trace
(reference: rllib/algorithms/impala/impala.py, ~1.3k LoC: async sample
queues feeding a central learner; Espeholt 2018).

Async shape here: every env runner always has exactly one sample() in
flight; the learner consumes whichever fragments are ready
(``ray_tpu_torch.wait``), corrects them with V-trace for their staleness,
updates, and re-arms the runner with fresh weights. No barrier — slow runners never
stall the learner, the hallmark of IMPALA vs synchronous PPO.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.utils.vtrace import vtrace


class ImpalaLearner(Learner):
    """Policy-gradient + value + entropy loss on V-trace targets
    (reference: impala/torch/impala_torch_learner.py). Batches stay (T, B)
    so the recursion in vtrace() runs inside the loss, on the learner's
    device."""

    def loss(self, params, batch):
        cfg = self.config
        # fragments arrive BATCH-major (B, T, ...) so the mesh data axis
        # shards env-batch rows (base Learner shards axis 0); transpose to
        # time-major here for the forward + vtrace recursion
        tT = lambda a: a.transpose(0, 1)
        obs, actions = tT(batch["obs"]), tT(batch["actions"])
        out = self.module.forward(params, obs)
        dist = self.module.dist
        target_logp = dist.logp(out["logits"], actions)
        vs, pg_adv = vtrace(
            tT(batch["logp"]), target_logp, tT(batch["rewards"]), out["vf"],
            tT(batch["dones"]), batch["bootstrap"],
            gamma=cfg.get("gamma", 0.99),
            clip_rho=cfg.get("vtrace_clip_rho_threshold", 1.0),
            clip_c=cfg.get("vtrace_clip_c_threshold", 1.0))
        mask = tT(batch["valid"])
        denom = torch.clamp(mask.sum(), min=1.0)
        pi_loss = -torch.sum(target_logp * pg_adv * mask) / denom
        vf_loss = 0.5 * torch.sum((out["vf"] - vs) ** 2 * mask) / denom
        entropy = torch.sum(dist.entropy(out["logits"]) * mask) / denom
        total = (pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss
                 - cfg.get("entropy_coeff", 0.01) * entropy)
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    def __init__(self, module_spec, config, use_mesh: bool = False,
                 device=None):
        # central single-mesh learner (the IMPALA shape); scale-out is via
        # num_learners>0 remote learners, not intra-learner sharding
        super().__init__(module_spec, config, use_mesh=use_mesh,
                         device=device)

    def update(self, batch):
        """One whole-fragment update — no row shuffling (it would scramble
        the V-trace time recursion): the grads, then one optimizer step."""
        metrics = self.compute_grads(self._batch(batch))
        self.opt_state.step()
        return {k: float(v) for k, v in metrics.items()}


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or IMPALA)
        self.lr = 5e-4
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.num_fragments_per_step = 8  # fragments consumed per step()
        self.broadcast_interval = 1  # updates between weight re-broadcasts
        self.minibatch_size = None  # whole fragments; no re-shuffling
        self.num_epochs = 1

    def _training_keys(self):
        return {"vf_loss_coeff", "entropy_coeff",
                "vtrace_clip_rho_threshold", "vtrace_clip_c_threshold",
                "num_fragments_per_step", "broadcast_interval"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d.update({
            "vf_loss_coeff": self.vf_loss_coeff,
            "entropy_coeff": self.entropy_coeff,
            "vtrace_clip_rho_threshold": self.vtrace_clip_rho_threshold,
            "vtrace_clip_c_threshold": self.vtrace_clip_c_threshold,
        })
        return d


class IMPALA(Algorithm):
    learner_cls = ImpalaLearner

    @classmethod
    def get_default_config(cls):
        return IMPALAConfig(algo_class=cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        # arm every runner once; from now on each always has one in-flight
        self._inflight: Dict = {}
        self._weights_ref = None
        self._updates_since_broadcast = 0
        self._rearm_all()

    def _rearm_all(self) -> None:
        weights_ref = ray_tpu_torch.put(self.learner_group.get_weights())
        for i, runner in enumerate(self.env_runners):
            if not any(idx == i for idx in self._inflight.values()):
                self._inflight[runner.sample.remote(weights_ref)] = i

    def training_step(self) -> Dict:
        cfg = self.config
        learner = self.learner_group.local_learner()
        consumed: List[Dict] = []
        metrics: Dict = {}
        while len(consumed) < cfg.num_fragments_per_step:
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                    timeout=300)
            if not ready:
                break
            ref = ready[0]
            idx = self._inflight.pop(ref)
            try:
                sample = ray_tpu_torch.get(ref, timeout=60)
            except Exception:
                if not cfg.restart_failed_env_runners:
                    raise
                self.env_runners[idx] = self._make_runner(idx)
                weights_ref = ray_tpu_torch.put(learner.get_weights())
                self._inflight[
                    self.env_runners[idx].sample.remote(weights_ref)] = idx
                continue
            self._total_env_steps += sample["env_steps"]
            for ep in sample["episodes"]:
                self._episode_returns.append(ep["episode_return"])
            consumed.append(sample)
            # learn on this fragment immediately (off-policyness handled by
            # V-trace), then re-arm the runner; weights re-broadcast every
            # broadcast_interval updates (reference: impala.py
            # broadcast_interval) — V-trace absorbs the extra staleness
            metrics = learner.update(self._to_batch(sample))
            self._updates_since_broadcast += 1
            if (self._weights_ref is None or
                    self._updates_since_broadcast >= cfg.broadcast_interval):
                self._weights_ref = ray_tpu_torch.put(learner.get_weights())
                self._updates_since_broadcast = 0
            self._inflight[
                self.env_runners[idx].sample.remote(self._weights_ref)] = idx
        metrics["env_steps_this_iter"] = sum(
            s["env_steps"] for s in consumed)
        metrics["num_fragments_consumed"] = len(consumed)
        return metrics

    def _to_batch(self, s: Dict) -> Dict[str, np.ndarray]:
        bT = lambda a: np.ascontiguousarray(np.swapaxes(a, 0, 1))
        return {  # batch-major (B, T, ...): axis 0 shards over the mesh
            "obs": bT(s["obs"]), "actions": bT(s["actions"]),
            "logp": bT(s["logp"]), "rewards": bT(s["rewards"]),
            "dones": bT(s["dones"]),
            "valid": bT(s["valid"].astype(np.float32)),
            "bootstrap": s["last_vf"],
        }

    def cleanup(self) -> None:
        self._inflight.clear()
        super().cleanup()
