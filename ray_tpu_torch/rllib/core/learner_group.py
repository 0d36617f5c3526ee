"""LearnerGroup: one local learner, or N learner actors.

Port of ``ray_tpu/rllib/core/learner_group.py``. Two modes:

- **local** (``num_learners=0``): one in-process Learner, on the data mesh
  when a process group of more than one rank is up (``learner.py``).
- **remote** (``num_learners=N``): N learner actors on the port's runtime,
  decentralized data parallelism (DD-PPO): each computes the gradients of
  its shard of the batch and all-reduces them through
  ``ray_tpu_torch.util.collective`` (NCCL between cards, the host group
  between CPU learners) before its optimizer applies them, so the params
  stay the same on every learner with no parameter server.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.rllib.core.learner import Learner
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec


class _RemoteLearner:
    """Actor hosting one Learner with the gradient all-reduce."""

    def __init__(self, learner_cls, module_spec, config: Dict,
                 group_name: str, rank: int, world_size: int,
                 device: Optional[str] = None):
        self._learner = learner_cls(module_spec, config, use_mesh=False,
                                    device=device)
        self._group_name = group_name
        self._world = world_size
        if world_size > 1:
            from ray_tpu_torch.util import collective as col

            backend = ("nccl" if self._learner.device.type == "cuda"
                       else "cpu")
            col.init_collective_group(world_size, rank, backend=backend,
                                      group_name=group_name)
            self._col = col

    def _allreduce_grads(self) -> None:
        """Every param's grad replaced by its mean over the learners, one
        flat all-reduce."""
        leaves = tree_leaves(self._learner.params)
        flat = torch.cat([p.grad.reshape(-1) for p in leaves])
        flat = self._col.allreduce(flat, group_name=self._group_name)
        flat = flat / self._world
        off = 0
        for p in leaves:
            n = p.grad.numel()
            p.grad = flat[off:off + n].reshape(p.grad.shape).clone()
            off += n

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        lrn = self._learner
        cfg = lrn.config
        num_epochs = cfg.get("num_epochs", 1)
        minibatch = cfg.get("minibatch_size") or len(batch["obs"])
        n = len(batch["obs"])
        rng = np.random.default_rng(cfg.get("seed", 0))
        metrics: Dict[str, Any] = {}
        for _ in range(num_epochs):
            order = rng.permutation(n)
            for s in range(0, n - minibatch + 1, minibatch):
                idx = order[s:s + minibatch]
                mb = lrn._batch({k: v[idx] for k, v in batch.items()})
                metrics = lrn.compute_grads(mb)
                metrics.pop("grad_norm")  # of this learner's shard only
                if self._world > 1:
                    self._allreduce_grads()
                lrn.opt_state.step()
        return {k: float(v) for k, v in metrics.items()}

    def get_weights(self):
        return self._learner.get_weights()

    def set_weights(self, weights):
        self._learner.set_weights(weights)
        return True

    def get_state(self):
        return self._learner.get_state()

    def set_state(self, state):
        self._learner.set_state(state)
        return True

    def stop(self):
        return True


class LearnerGroup:
    """``device`` is each learner's (None: the CUDA card); remote learners
    take ``resources_per_learner`` (default one CPU; a learner on the card
    needs ``{"GPU": 1}``)."""

    def __init__(self, learner_cls, module_spec: RLModuleSpec, config: Dict,
                 num_learners: int = 0,
                 resources_per_learner: Optional[Dict] = None,
                 device: Optional[str] = None):
        self._num = num_learners
        self._local: Optional[Learner] = None
        self._workers: List = []
        if num_learners == 0:
            self._local = learner_cls(module_spec, config, device=device)
        else:
            import uuid

            group = f"learners_{uuid.uuid4().hex[:6]}"
            res = dict(resources_per_learner or {"CPU": 1})
            num_gpus = res.pop("GPU", 0)
            num_cpus = res.pop("CPU", 1)
            for rank in range(num_learners):
                self._workers.append(
                    ray_tpu_torch.remote(_RemoteLearner).options(
                        num_cpus=num_cpus, num_gpus=num_gpus,
                        resources=res).remote(
                            learner_cls, module_spec, config, group,
                            rank, num_learners, device))

    @property
    def is_local(self) -> bool:
        return self._local is not None

    def local_learner(self) -> Learner:
        """The in-process learner (off-policy algos drive it directly for
        target-net/epsilon state; they require num_learners=0)."""
        if self._local is None:
            raise RuntimeError(
                "this algorithm drives a local learner; configure "
                "num_learners=0")
        return self._local

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        if self._local is not None:
            return self._local.update(batch)
        # shard the train batch across learners (equal slices)
        n = len(batch["obs"])
        k = len(self._workers)
        per = n // k
        refs = []
        for i, w in enumerate(self._workers):
            shard = {key: v[i * per:(i + 1) * per] for key, v in batch.items()}
            refs.append(w.update.remote(shard))
        all_metrics = ray_tpu_torch.get(refs, timeout=600)
        return {k2: float(np.mean([m[k2] for m in all_metrics]))
                for k2 in all_metrics[0]}

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        return ray_tpu_torch.get(self._workers[0].get_weights.remote(),
                                 timeout=120)

    def set_weights(self, weights) -> None:
        if self._local is not None:
            self._local.set_weights(weights)
        else:
            ray_tpu_torch.get([w.set_weights.remote(weights)
                               for w in self._workers], timeout=120)

    def get_state(self) -> Dict:
        if self._local is not None:
            return self._local.get_state()
        return ray_tpu_torch.get(self._workers[0].get_state.remote(),
                                 timeout=120)

    def set_state(self, state: Dict) -> None:
        if self._local is not None:
            self._local.set_state(state)
        else:
            ray_tpu_torch.get([w.set_state.remote(state)
                               for w in self._workers], timeout=120)

    def shutdown(self) -> None:
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
