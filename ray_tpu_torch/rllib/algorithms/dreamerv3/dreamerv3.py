# Ported from ray_tpu/rllib/algorithms/dreamerv3/dreamerv3.py (ray_tpu -> ray_tpu_torch).
"""DreamerV3 — model-based RL via latent imagination (reference:
rllib/algorithms/dreamerv3/dreamerv3.py (TF); Hafner 2023): an RSSM world
model (GRU deterministic path + categorical stochastic latents) learns to
predict observations, rewards, and episode continuation; the actor-critic
trains entirely on imagined latent rollouts, so the env is touched only
for replay data.

Compact, keeping the paper's robustness machinery: symlog targets, twohot
reward/value distributions over symexp-spaced bins, unimix categorical
latents with straight-through gradients, KL balancing with free bits,
percentile return normalization for the actor, and an EMA critic
regularizer. Deviations (documented, sized for a one-CPU test box): MLP
encoder/decoder only (no CNN path), discrete actions only, and imagination
starts from every posterior state of the replayed batch.

One update is eager on the learner's device (``learners(device=)``; None:
the CUDA card): the RSSM over the sequence and the rollout over the
imagination horizon are Python loops, and the λ-returns a reverse loop.
A categorical sample is ``argmax(logits + gumbel)`` (what
``jax.random.categorical`` computes); the update takes its Gumbel draws
as tensors (``draws``), which the learner's ``torch.Generator`` makes
before the call, so a caller can feed the same draws to two learners.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.tree import tree_map
from ray_tpu_torch.parallel.optim import clip_adam
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import (
    copy_tree, load_tree, polyak)
from ray_tpu_torch.rllib.algorithms.sac.sac import adam_step
from ray_tpu_torch.rllib.core.learner import cpu_snapshot
from ray_tpu_torch.rllib.utils.replay_buffer import SequenceReplayBuffer


# ----------------------------------------------------------- symlog/twohot
def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def make_bins(num_bins: int = 41, low: float = -20.0, high: float = 20.0,
              device=None):
    """symexp-spaced bins: dense near 0, exponentially wide at the tails
    (Hafner 2023 uses 255 over [-20, 20]; fewer suffice at toy scale)."""
    return symexp(torch.linspace(low, high, num_bins, device=device))


def twohot(x, bins):
    """Project scalars onto the two neighboring bins (linear weights)."""
    x = torch.clamp(x, bins[0], bins[-1])
    idx_hi = torch.clamp(torch.searchsorted(bins, x.contiguous()), 1,
                         len(bins) - 1)
    idx_lo = idx_hi - 1
    lo, hi = bins[idx_lo], bins[idx_hi]
    w_hi = torch.where(hi > lo, (x - lo) / (hi - lo + 1e-12),
                       torch.ones_like(x))
    one_lo = F.one_hot(idx_lo, len(bins)).to(x.dtype)
    one_hi = F.one_hot(idx_hi, len(bins)).to(x.dtype)
    return one_lo * (1 - w_hi)[..., None] + one_hi * w_hi[..., None]


def dist_mean(logits, bins):
    return torch.sum(torch.softmax(logits, dim=-1) * bins, dim=-1)


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws, -log(-log(u)) with u uniform in [tiny, 1)
    (``jax.random.gumbel``'s form), on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(torch.float32).tiny)))


# ------------------------------------------------------------------- module
@dataclasses.dataclass
class DreamerModuleSpec:
    obs_dim: int
    action_dim: int
    discrete: bool = True
    deter: int = 128          # GRU state size
    stoch: int = 8            # categorical latents
    classes: int = 8          # classes per latent
    hidden: int = 128         # MLP width for all heads
    num_bins: int = 41
    unimix: float = 0.01

    def build(self) -> "DreamerModule":
        return DreamerModule(self)


class DreamerModule:
    """RSSM + heads. Params are plain dicts of w/b MLP stacks (house
    style); the GRU is a single fused cell."""

    def __init__(self, spec: DreamerModuleSpec):
        self.spec = spec
        self._bins: Dict[torch.device, torch.Tensor] = {}

    def bins(self, device) -> torch.Tensor:
        """The twohot bins on ``device`` (made once per device)."""
        device = torch.device(device)
        if device not in self._bins:
            self._bins[device] = make_bins(self.spec.num_bins, device=device)
        return self._bins[device]

    # --- param init -------------------------------------------------------
    @staticmethod
    def _mlp(generator, sizes):
        dev = generator.device
        return [{"w": torch.randn((a, b), generator=generator, device=dev)
                 * math.sqrt(2.0 / a),
                 "b": torch.zeros((b,), device=dev)}
                for a, b in zip(sizes[:-1], sizes[1:])]

    def init(self, generator: torch.Generator) -> Dict:
        s = self.spec
        z_dim = s.stoch * s.classes
        gru_in = z_dim + s.action_dim
        h = s.hidden
        return {
            "embed": self._mlp(generator, (s.obs_dim, h, h)),
            # fused GRU: [x, h] -> (reset, update, candidate)
            "gru": {"w": torch.randn((gru_in + s.deter, 3 * s.deter),
                                     generator=generator,
                                     device=generator.device)
                    * math.sqrt(1.0 / (gru_in + s.deter)),
                    "b": torch.zeros((3 * s.deter,),
                                     device=generator.device)},
            "prior": self._mlp(generator, (s.deter, h, z_dim)),
            "post": self._mlp(generator, (s.deter + h, h, z_dim)),
            "decoder": self._mlp(generator, (s.deter + z_dim, h, s.obs_dim)),
            "reward": self._mlp(generator, (s.deter + z_dim, h, s.num_bins)),
            "cont": self._mlp(generator, (s.deter + z_dim, h, 1)),
            "actor": self._mlp(generator, (s.deter + z_dim, h,
                                           s.action_dim)),
            "critic": self._mlp(generator, (s.deter + z_dim, h, s.num_bins)),
        }

    # --- building blocks --------------------------------------------------
    @staticmethod
    def _tower(layers, x, act=F.silu):
        for layer in layers[:-1]:
            x = act(x @ layer["w"] + layer["b"])
        last = layers[-1]
        return x @ last["w"] + last["b"]

    def _z_logits(self, raw):
        """(.., stoch*classes) -> unimix logits (.., stoch, classes)."""
        s = self.spec
        logits = raw.reshape(raw.shape[:-1] + (s.stoch, s.classes))
        probs = (1 - s.unimix) * torch.softmax(logits, dim=-1) + \
            s.unimix / s.classes
        return torch.log(probs)

    def _z_sample(self, logits, gumbel_draws):
        """Straight-through categorical sample, flattened; ``gumbel_draws``
        has the logits' shape."""
        s = self.spec
        idx = torch.argmax(logits + gumbel_draws, dim=-1)
        one = F.one_hot(idx, s.classes).to(logits.dtype)
        probs = torch.softmax(logits, dim=-1)
        one = one + probs - probs.detach()
        return one.reshape(one.shape[:-2] + (s.stoch * s.classes,))

    def sequence_step(self, params, h, z, action_onehot):
        """h_t = GRU(h_{t-1}, [z_{t-1}, a_{t-1}])."""
        x = torch.cat([z, action_onehot], -1)
        return self._gru_cell(params, x, h)

    def _gru_cell(self, params, x, h):
        gates = torch.cat([x, h], -1) @ params["gru"]["w"] + \
            params["gru"]["b"]
        r, u, c = torch.chunk(gates, 3, dim=-1)
        r, u = torch.sigmoid(r), torch.sigmoid(u)
        return u * h + (1 - u) * torch.tanh(r * c)

    def prior_logits(self, params, h):
        return self._z_logits(self._tower(params["prior"], h))

    def post_logits(self, params, h, obs):
        embed = self._tower(params["embed"], symlog(obs))
        return self._z_logits(self._tower(
            params["post"], torch.cat([h, embed], -1)))

    @staticmethod
    def feat(h, z):
        return torch.cat([h, z], -1)

    # --- env-runner interface (recurrent policy) -------------------------
    def initial_state(self, batch_size: int) -> Tuple:
        s = self.spec
        return (np.zeros((batch_size, s.deter), np.float32),
                np.zeros((batch_size, s.stoch * s.classes), np.float32),
                np.zeros((batch_size, s.action_dim), np.float32))

    def explore_draws(self, generator: torch.Generator,
                      batch_size: int) -> Dict[str, torch.Tensor]:
        """The Gumbel draws of one ``explore_action_recurrent`` step: the
        posterior sample's and the action's."""
        s = self.spec
        return {"z": gumbel(generator, (batch_size, s.stoch, s.classes)),
                "a": gumbel(generator, (batch_size, s.action_dim))}

    def explore_action_recurrent(self, params, obs, state,
                                 generator: torch.Generator,
                                 draws: Optional[Dict] = None):
        """One stateful step; ``draws`` (``explore_draws``' layout)
        replaces the generator's."""
        h, z, prev_a = state
        if draws is None:
            draws = self.explore_draws(generator, obs.shape[0])
        h = self.sequence_step(params, h, z, prev_a)
        z = self._z_sample(self.post_logits(params, h, obs), draws["z"])
        feat = self.feat(h, z)
        logits = self._tower(params["actor"], feat)
        action = torch.argmax(logits + draws["a"], dim=-1)
        logp = torch.log_softmax(logits, dim=-1).gather(
            -1, action[:, None])[:, 0]
        vf = dist_mean(self._tower(params["critic"], feat),
                       self.bins(feat.device))
        onehot = F.one_hot(action, self.spec.action_dim).to(feat.dtype)
        return action, logp, vf, (h, z, onehot)

    def explore_action(self, params, obs, generator: torch.Generator):
        """Stateless variant: one posterior step from a zero latent
        state (R2D2 ships one the same way)."""
        action, logp, vf, _ = self.explore_action_recurrent(
            params, obs, self._zero_state(obs.shape[0], obs.device),
            generator)
        return action, logp, vf

    def _zero_state(self, batch_size: int, device=None) -> Tuple:
        s = self.spec
        return (torch.zeros((batch_size, s.deter), device=device),
                torch.zeros((batch_size, s.stoch * s.classes),
                            device=device),
                torch.zeros((batch_size, s.action_dim), device=device))

    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        """Stateless fallback (bootstrap values at truncations): runs one
        posterior step from a zero state."""
        B = obs.shape[0]
        s = self.spec
        h = torch.zeros((B, s.deter), device=obs.device)
        z_logits = self.post_logits(params, h, obs)
        z = torch.softmax(z_logits, dim=-1).reshape(B, s.stoch * s.classes)
        feat = self.feat(h, z)
        return {"logits": self._tower(params["actor"], feat),
                "vf": dist_mean(self._tower(params["critic"], feat),
                                self.bins(feat.device))}


# ------------------------------------------------------------------ learner
def _kl(p_logits, q_logits):
    p = torch.softmax(p_logits, dim=-1)
    return torch.sum(p * (torch.log_softmax(p_logits, dim=-1)
                          - torch.log_softmax(q_logits, dim=-1)), -1)


class DreamerLearner:
    """World model + actor + critic, one update over a [B, L] sequence
    batch (reference: dreamerv3/dreamerv3_learner.py), on ``device``
    (None: the CUDA card). The optimizer is ``clip_adam`` (optax's
    ``chain(clip_by_global_norm, adam)``); the slow critic's EMA and the
    return scale are learner state."""

    def __init__(self, module_spec: DreamerModuleSpec, config: Dict,
                 use_mesh: bool = True, device=None):
        self.device = resolve_device(device)
        self.module = module_spec.build()
        self.config = config
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.get("seed", 0))
        params = self.module.init(self._gen)
        self.params = tree_map(lambda t: t.requires_grad_(True), params)
        self.slow_critic = copy_tree(self.params["critic"])
        self.opt = clip_adam(config.get("lr", 4e-4),
                             config.get("grad_clip", 100.0))(self.params)
        # percentile return-normalization state (EMA of the 5..95 range)
        self.ret_scale = torch.tensor(1.0, device=self.device)

    def draws(self, batch_size: int, length: int) -> Dict[str, torch.Tensor]:
        """The Gumbel draws of one update over a [batch_size, length]
        batch: the posterior samples' [L, B, stoch, classes], and the
        imagined actions' [H, N, action_dim] and latents' [H, N, stoch,
        classes] (N = B * L starts)."""
        s = self.module.spec
        H = self.config.get("imagine_horizon", 10)
        N = batch_size * length
        return {"post": gumbel(self._gen,
                               (length, batch_size, s.stoch, s.classes)),
                "img_a": gumbel(self._gen, (H, N, s.action_dim)),
                "img_z": gumbel(self._gen, (H, N, s.stoch, s.classes))}

    # --- world model + imagination loss -----------------------------------
    def _wm_and_img(self, params, slow_critic, batch, ret_scale, draws):
        m = self.module
        s = m.spec
        cfg = self.config
        bins = m.bins(self.device)
        obs = batch["obs"]            # [B, L, D]
        actions = batch["actions"]    # [B, L]
        rewards = batch["rewards"]
        dones = batch["dones"]
        is_first = batch["is_first"]
        B, L = actions.shape
        a_onehot = F.one_hot(actions, s.action_dim).float()
        prev_a = torch.cat([torch.zeros((B, 1, s.action_dim),
                                        device=self.device),
                            a_onehot[:, :-1]], 1)

        # the RSSM over the sequence, time-major
        h = torch.zeros((B, s.deter), device=self.device)
        z = torch.zeros((B, s.stoch * s.classes), device=self.device)
        hs, zs, posts, priors = [], [], [], []
        for t in range(L):
            # episode boundary: reset the latent state rows
            keep = (1.0 - is_first[:, t])[:, None]
            h, z = h * keep, z * keep
            h = m.sequence_step(params, h, z, prev_a[:, t] * keep)
            post = m.post_logits(params, h, obs[:, t])
            prior = m.prior_logits(params, h)
            z = m._z_sample(post, draws["post"][t])
            hs.append(h)
            zs.append(z)
            posts.append(post)
            priors.append(prior)
        # batch-major
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)
        posts, priors = torch.stack(posts, 1), torch.stack(priors, 1)
        feat = m.feat(hs, zs)                       # [B, L, F]

        # prediction losses (symlog decoder, twohot reward, bernoulli cont)
        obs_hat = m._tower(params["decoder"], feat)
        recon_loss = torch.mean(torch.sum(
            (obs_hat - symlog(obs)) ** 2, -1))
        r_logits = m._tower(params["reward"], feat)
        r_target = twohot(symlog(rewards), bins)
        reward_loss = -torch.mean(torch.sum(
            r_target * torch.log_softmax(r_logits, dim=-1), -1))
        c_logits = m._tower(params["cont"], feat)[..., 0]
        cont_target = 1.0 - dones
        cont_loss = torch.mean(
            torch.clamp(c_logits, min=0) - c_logits * cont_target
            + torch.log1p(torch.exp(-torch.abs(c_logits))))

        # KL balancing with free bits (Hafner 2023 Eq. 5)
        dyn_kl = _kl(posts.detach(), priors).sum(-1)
        rep_kl = _kl(posts, priors.detach()).sum(-1)
        free = cfg.get("free_bits", 1.0)
        dyn_loss = torch.mean(torch.clamp(dyn_kl, min=free))
        rep_loss = torch.mean(torch.clamp(rep_kl, min=free))
        wm_loss = recon_loss + reward_loss + cont_loss + \
            cfg.get("dyn_scale", 0.5) * dyn_loss + \
            cfg.get("rep_scale", 0.1) * rep_loss

        # ---- imagination from every posterior state. Gradients stop at
        # the handoff (the world model is the actor's environment) and
        # every loss reads the rollout through a stop-gradient, so it runs
        # without the autograd graph.
        H = cfg.get("imagine_horizon", 10)
        with torch.no_grad():
            h = hs.reshape(-1, s.deter)
            z = zs.reshape(-1, s.stoch * s.classes)
            img_feat, img_a, img_next = [], [], []
            for t in range(H):
                feat_t = m.feat(h, z)
                a_logits = m._tower(params["actor"], feat_t)
                a = torch.argmax(a_logits + draws["img_a"][t], dim=-1)
                a_1h = F.one_hot(a, s.action_dim).float()
                h = m.sequence_step(params, h, z, a_1h)
                z = m._z_sample(m.prior_logits(params, h), draws["img_z"][t])
                img_feat.append(feat_t)
                img_a.append(a)
                img_next.append(m.feat(h, z))
            img_feat = torch.stack(img_feat)        # [H, N, F]
            img_a = torch.stack(img_a)
            img_feat_next = torch.stack(img_next)
            # heads along the imagined trajectory [H, N]
            r_pred = dist_mean(m._tower(params["reward"], img_feat_next),
                               bins)
            cont_pred = torch.sigmoid(
                m._tower(params["cont"], img_feat_next)[..., 0])
            v = dist_mean(m._tower(params["critic"], img_feat_next), bins)
            gamma = cfg.get("gamma", 0.997) * cont_pred
            lam = cfg.get("lambda_", 0.95)
            rets = [None] * H
            nxt = v[-1]
            for t in range(H - 1, -1, -1):
                nxt = r_pred[t] + gamma[t] * ((1 - lam) * v[t] + lam * nxt)
                rets[t] = nxt
            rets = torch.stack(rets)                 # [H, N] lambda-returns

            # percentile normalization of returns (Hafner 2023 Sec. 3)
            qs = torch.quantile(rets.reshape(-1), torch.tensor(
                [0.05, 0.95], device=self.device), interpolation="linear")
            new_scale = 0.99 * ret_scale + 0.01 * torch.clamp(
                qs[1] - qs[0], min=1.0)
            v_base = dist_mean(m._tower(params["critic"], img_feat), bins)
            adv = (rets - v_base) / new_scale
            tgt = twohot(symlog(rets), bins)
            slow_tgt = torch.softmax(m._tower(slow_critic, img_feat), dim=-1)

        # actor: reinforce with normalized advantage + entropy
        a_logits_all = m._tower(params["actor"], img_feat)
        logp_all = torch.log_softmax(a_logits_all, dim=-1)
        logp_taken = torch.sum(
            logp_all * F.one_hot(img_a, s.action_dim).float(), -1)
        entropy = -torch.sum(torch.softmax(a_logits_all, dim=-1) * logp_all,
                             -1)
        actor_loss = -torch.mean(logp_taken * adv) - \
            cfg.get("entropy_scale", 3e-3) * torch.mean(entropy)

        # critic: twohot CE to lambda-returns + EMA regularizer
        c_logp_img = torch.log_softmax(
            m._tower(params["critic"], img_feat), dim=-1)
        critic_loss = -torch.mean(torch.sum(tgt * c_logp_img, -1))
        critic_loss = critic_loss + cfg.get("slow_reg", 1.0) * -torch.mean(
            torch.sum(slow_tgt * c_logp_img, -1))

        total = wm_loss + actor_loss + critic_loss
        metrics = {
            "wm_loss": wm_loss, "recon_loss": recon_loss,
            "reward_loss": reward_loss, "cont_loss": cont_loss,
            "dyn_kl": torch.mean(dyn_kl), "rep_kl": torch.mean(rep_kl),
            "actor_loss": actor_loss, "critic_loss": critic_loss,
            "imagined_return_mean": torch.mean(rets),
            "return_scale": new_scale,
        }
        return total, metrics, new_scale

    def _batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.as_tensor(np.asarray(v)).to(self.device)
               for k, v in batch.items()}
        return {k: (v.long() if k == "actions" else v.float())
                for k, v in out.items()}

    def update(self, batch: Dict[str, np.ndarray],
               draws: Optional[Dict] = None) -> Dict[str, float]:
        """One update; ``draws`` (the ``draws`` layout, tensors or numpy)
        replaces the generator's."""
        tb = self._batch(batch)
        B, L = tb["actions"].shape
        draws = (self.draws(B, L) if draws is None else
                 {k: torch.as_tensor(v).to(self.device, torch.float32)
                  for k, v in draws.items()})
        self.opt.zero_grad(set_to_none=True)
        loss, metrics, new_scale = self._wm_and_img(
            self.params, self.slow_critic, tb, self.ret_scale, draws)
        loss.backward()
        adam_step(self.opt, self.params)
        polyak(self.slow_critic, self.params["critic"],
               self.config.get("slow_critic_tau", 0.02))
        self.ret_scale = new_scale
        metrics["total_loss"] = loss
        names = list(metrics)
        values = torch.stack([metrics[k].detach().reshape(())
                              for k in names]).tolist()
        return dict(zip(names, values))

    # Learner duck-type
    def get_weights(self):
        return cpu_snapshot(self.params)

    def set_weights(self, weights) -> None:
        load_tree(self.params, weights)

    def get_state(self) -> Dict:
        return {"params": cpu_snapshot(self.params),
                "slow_critic": cpu_snapshot(self.slow_critic),
                "opt_state": cpu_snapshot(self.opt.state_dict()),
                "ret_scale": self.ret_scale.detach().cpu().clone()}

    def set_state(self, state: Dict) -> None:
        load_tree(self.params, state["params"])
        load_tree(self.slow_critic, state["slow_critic"])
        self.opt.load_state_dict(state["opt_state"])
        self.ret_scale = torch.as_tensor(
            state["ret_scale"], dtype=torch.float32).to(self.device)


# ------------------------------------------------------------------- config
class DreamerV3Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or DreamerV3)
        self.gamma = 0.997
        self.lambda_ = 0.95
        self.lr = 4e-4
        self.deter = 128
        self.stoch = 8
        self.classes = 8
        self.model_hidden = 128
        self.num_bins = 41
        self.imagine_horizon = 10
        self.free_bits = 1.0
        self.dyn_scale = 0.5
        self.rep_scale = 0.1
        self.entropy_scale = 3e-3
        self.slow_critic_tau = 0.02
        self.train_ratio = 64     # replayed steps trained per env step
        self.batch_length = 16
        self.batch_size_seqs = 8
        self.replay_capacity_seqs = 2000
        self.rollout_fragment_length = 16
        self.num_env_runners = 1
        self.num_envs_per_env_runner = 4

    def _training_keys(self):
        return {"lambda_", "deter", "stoch", "classes", "model_hidden",
                "num_bins", "imagine_horizon", "free_bits", "dyn_scale",
                "rep_scale", "entropy_scale", "slow_critic_tau",
                "train_ratio", "batch_length", "batch_size_seqs",
                "replay_capacity_seqs"}

    def module_spec(self) -> DreamerModuleSpec:
        base = super().module_spec()
        if not base.discrete:
            raise ValueError(
                "this DreamerV3 implements discrete action spaces")
        return DreamerModuleSpec(
            obs_dim=base.obs_dim, action_dim=base.action_dim,
            deter=self.deter, stoch=self.stoch, classes=self.classes,
            hidden=self.model_hidden, num_bins=self.num_bins)

    def learner_config_dict(self) -> Dict:
        return {"lr": self.lr, "seed": self.seed, "gamma": self.gamma,
                "lambda_": self.lambda_,
                "imagine_horizon": self.imagine_horizon,
                "free_bits": self.free_bits, "dyn_scale": self.dyn_scale,
                "rep_scale": self.rep_scale,
                "entropy_scale": self.entropy_scale,
                "slow_critic_tau": self.slow_critic_tau}


class DreamerV3(Algorithm):
    learner_cls = DreamerLearner

    @classmethod
    def get_default_config(cls):
        return DreamerV3Config(algo_class=cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self.config
        self.replay = SequenceReplayBuffer(cfg.replay_capacity_seqs,
                                           seed=cfg.seed)

    def training_step(self) -> Dict:
        cfg = self.config
        learner = self.learner_group.local_learner()
        weights_ref = ray_tpu_torch.put(learner.get_weights())
        samples = self._sample_from_runners(weights_ref)
        new_steps = sum(s["env_steps"] for s in samples)
        for s in samples:
            T, E = s["rewards"].shape
            # is_first: step 0 of the fragment, or right after a done
            is_first = np.zeros((T, E), np.float32)
            is_first[0] = 1.0
            is_first[1:] = s["dones"][:-1]
            self.replay.add_sequences(
                {"obs": s["obs"], "actions": s["actions"],
                 "rewards": s["rewards"], "dones": s["dones"],
                 "is_first": is_first},
                state_in=s.get("state_in") or
                tuple(np.zeros((E, 1), np.float32)))
        metrics: Dict = {"env_steps_this_iter": new_steps}
        if len(self.replay) < cfg.batch_size_seqs:
            return metrics
        updates = max(1, int(new_steps * cfg.train_ratio
                             / (cfg.batch_size_seqs * cfg.batch_length)))
        for _ in range(updates):
            seq = self.replay.sample(cfg.batch_size_seqs)
            batch = {k: seq[k] for k in
                     ("obs", "actions", "rewards", "dones", "is_first")}
            metrics.update(learner.update(batch))
        metrics["replay_seqs"] = len(self.replay)
        metrics["updates_this_iter"] = updates
        return metrics
