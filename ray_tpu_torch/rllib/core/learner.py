"""Learner and the PPO loss.

Port of ``ray_tpu/rllib/core/learner.py``. A learner owns the module's
params (a tree of leaves that require grad) and the optimizer over them,
``clip_adam`` (``optax.chain(clip_by_global_norm(grad_clip), adam(lr))``).
When a ``torch.distributed`` process group of more than one rank is up (the
JAX package's test is ``len(jax.devices()) > 1``), the update runs on
``create_mesh(MeshConfig(data=-1))`` over it: the params are replicated
DTensors, each minibatch is sharded over ``data``, the loss runs through
DTensor (its means and the advantages' standardisation are over the whole
minibatch, as GSPMD computes them), and each grad is reduced to its param's
replicated placement before the clip and the update: the gradient
all-reduce of the JAX package's sharded ``jit``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.parallel.optim import clip_adam
from ray_tpu_torch.parallel.sharding import (
    NamedSharding, PartitionSpec, compat_mesh_ctx, shard_tensor)
from ray_tpu_torch.parallel.train_step import global_norm
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    """A batch column as a tensor: integer actions as int64 (the gather's
    index type), the rest as they are."""
    t = torch.as_tensor(np.asarray(v))
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)


class Learner:
    """Owns module params and optimizer state; subclasses define the loss.
    ``device`` None is the CUDA card (it raises without one); the CPU is
    taken when asked for."""

    def __init__(self, module_spec: RLModuleSpec, config: Dict,
                 use_mesh: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.module = module_spec.build()
        self.config = config
        gen = torch.Generator(device=self.device).manual_seed(
            config.get("seed", 0))
        params = self.module.init(gen)

        self._mesh = None
        if use_mesh and dist.is_initialized() and dist.get_world_size() > 1:
            from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

            self._mesh = create_mesh(MeshConfig(data=-1), device=self.device)
            repl = NamedSharding(self._mesh, PartitionSpec())
            params = tree_map(lambda t: shard_tensor(t, repl), params)
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.tx = clip_adam(config.get("lr", 3e-4),
                            config.get("grad_clip", 0.5))
        self.opt_state = self.tx(self.params)

    # --------------------------------------------------------------- loss
    def loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def _batch(self, mb: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy minibatch as tensors, sharded over ``data`` on a mesh."""
        out = {k: _as_tensor(v, self.device) for k, v in mb.items()}
        if self._mesh is not None:
            rows = NamedSharding(self._mesh, PartitionSpec("data"))
            out = {k: shard_tensor(v, rows) for k, v in out.items()}
        return out

    def compute_grads(self, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """The loss's grads into each param's ``.grad`` (reduced over
        ``data`` to the param's placement on a mesh), and the metrics: the
        loss's own, ``total_loss`` and ``grad_norm`` (fp32, before the
        clip), as tensors."""
        self.opt_state.zero_grad(set_to_none=True)
        with compat_mesh_ctx(self._mesh):
            loss, metrics = self.loss(self.params, batch)
        loss.backward()
        leaves = tree_leaves(self.params)
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif isinstance(p, DTensor) and p.grad.placements != \
                    p.placements:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        metrics = dict(metrics, total_loss=loss)
        metrics["grad_norm"] = global_norm(p.grad for p in leaves)
        return {k: _full(v.detach()) for k, v in metrics.items()}

    # ------------------------------------------------------------- update
    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One minibatch-SGD pass; batch rows pre-shuffled by the caller."""
        num_epochs = self.config.get("num_epochs", 1)
        minibatch = self.config.get("minibatch_size") or len(batch["obs"])
        n = len(batch["obs"])
        if self._mesh is not None:
            # pad minibatch to the data-axis multiple for even sharding
            d = self._mesh.size(0)
            minibatch = max(d, (minibatch // d) * d)
        metrics: Dict[str, Any] = {}
        rng = np.random.default_rng(self.config.get("seed", 0))
        for _ in range(num_epochs):
            order = rng.permutation(n)
            for s in range(0, n - minibatch + 1, minibatch):
                idx = order[s:s + minibatch]
                mb = self._batch({k: v[idx] for k, v in batch.items()})
                metrics = self.compute_grads(mb)
                self.opt_state.step()
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------ weights
    def get_weights(self):
        """The params as a tree of CPU tensors."""
        return tree_map(lambda t: _full(t.detach()).cpu().clone(),
                        self.params)

    def set_weights(self, weights) -> None:
        """Copy a tree of tensors (or numpy arrays) into the params in
        place: the optimizer keeps the same leaves."""
        flat = tree_leaves(weights)
        with torch.no_grad():
            for p, w in zip(tree_leaves(self.params), flat):
                local = p.to_local() if isinstance(p, DTensor) else p
                local.copy_(w if isinstance(w, torch.Tensor)
                            else torch.from_numpy(np.asarray(w)))

    def get_state(self) -> Dict:
        return {"params": self.get_weights(),
                "opt_state": self.opt_state.state_dict()}

    def set_state(self, state: Dict) -> None:
        self.set_weights(state["params"])
        self.opt_state.load_state_dict(state["opt_state"])


class PPOLearner(Learner):
    """Clipped-surrogate PPO loss."""

    def loss(self, params, batch):
        cfg = self.config
        clip = cfg.get("clip_param", 0.2)
        vf_clip = cfg.get("vf_clip_param", 10.0)
        vf_coeff = cfg.get("vf_loss_coeff", 0.5)
        ent_coeff = cfg.get("entropy_coeff", 0.0)

        out = self.module.forward(params, batch["obs"])
        dist_ = self.module.dist
        logp = dist_.logp(out["logits"], batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        # standardize advantages per minibatch (the population std, as
        # jnp.std)
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        pi_loss = -torch.mean(surrogate)

        vf_err = (out["vf"] - batch["value_targets"]) ** 2
        vf_loss = torch.mean(torch.clamp(vf_err, max=vf_clip ** 2))
        entropy = torch.mean(dist_.entropy(out["logits"]))

        total = pi_loss + vf_coeff * vf_loss - ent_coeff * entropy
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
            "mean_kl": torch.mean(batch["logp"] - logp),
        }


__all__ = ["Learner", "PPOLearner"]
