# Ported from ray_tpu/rllib/algorithms/r2d2/r2d2.py (ray_tpu -> ray_tpu_torch).
"""R2D2 — Recurrent Replay Distributed DQN (reference:
rllib/algorithms/r2d2/r2d2.py R2D2Config + r2d2_torch_policy.py loss;
Kapturowski et al. 2019).

The three R2D2 mechanics:
- **Stored recurrent state**: env runners carry the LSTM (h, c) across
  steps and record each fragment's starting state; replay resumes the net
  from that state instead of zeros (``SequenceReplayBuffer``).
- **Burn-in**: the first ``burn_in`` steps of every replayed sequence run
  forward only to warm the state (the carry is detached after them); the
  loss covers the remaining unroll.
- **Value rescaling**: targets use h(x) = sign(x)(√(|x|+1)−1) + εx and
  its inverse, stabilizing bootstrap magnitudes across reward scales.

The sequence update — burn-in, double-DQN targets along the unroll, Huber
loss, the clipped Adam step — runs over [B, T] batches on the learner's
device; the LSTM unroll is a Python loop over T.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn.dqn import (
    DQNLearner, huber)
from ray_tpu_torch.rllib.core.rl_module import mlp_forward, mlp_params
from ray_tpu_torch.rllib.utils.replay_buffer import SequenceReplayBuffer


def h_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def h_inverse(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    # closed-form inverse of h_rescale (Kapturowski 2019 appendix)
    num = torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0 + eps)) - 1.0
    return torch.sign(x) * (torch.square(num / (2.0 * eps)) - 1.0)


# ------------------------------------------------------------------- module
@dataclasses.dataclass
class R2D2ModuleSpec:
    """Recurrent Q-network spec (reference: r2d2 + recurrent_net.py)."""

    obs_dim: int
    action_dim: int
    discrete: bool = True
    hiddens: Tuple[int, ...] = (64,)
    lstm_cell_size: int = 64
    dueling: bool = True

    def build(self) -> "R2D2Module":
        return R2D2Module(self)


class R2D2Module:
    """Encoder MLP → LSTM → (dueling) Q heads. The recurrent interface
    (initial_state / explore_action_recurrent) plugs into the env runner's
    stateful path; q_seq is the learner's unroll over stored sequences."""

    def __init__(self, spec: R2D2ModuleSpec):
        self.spec = spec
        self._act = torch.relu
        self.cell_size = spec.lstm_cell_size

    def init(self, generator: torch.Generator) -> Dict:
        dev = generator.device
        enc_sizes = (self.spec.obs_dim, *self.spec.hiddens)
        H, E = self.cell_size, enc_sizes[-1]
        scale = math.sqrt(1.0 / (E + H))
        params = {
            "enc": mlp_params(generator, enc_sizes, final_scale=1.0),
            "lstm": {
                "wx": torch.randn((E, 4 * H), generator=generator,
                                  device=dev) * scale,
                "wh": torch.randn((H, 4 * H), generator=generator,
                                  device=dev) * scale,
                "b": torch.zeros((4 * H,), device=dev),
            },
            "adv": mlp_params(generator, (H, self.spec.action_dim)),
            # exploration epsilon rides in params (as DQNModule's)
            "epsilon": torch.tensor(1.0, device=dev),
        }
        if self.spec.dueling:
            params["v"] = mlp_params(generator, (H, 1))
        return params

    def initial_state(self, batch_size: int, device=None) -> Tuple:
        """Zero (h, c) on ``device`` (None: the CPU)."""
        return (torch.zeros((batch_size, self.cell_size), device=device),
                torch.zeros((batch_size, self.cell_size), device=device))

    def _encode(self, params, obs):
        x = obs
        for layer in params["enc"]:
            x = self._act(x @ layer["w"] + layer["b"])
        return x

    def _cell(self, params, x, state):
        h, c = state
        gates = (x @ params["lstm"]["wx"] + h @ params["lstm"]["wh"]
                 + params["lstm"]["b"])
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    def _q_from_h(self, params, h):
        adv = mlp_forward(params["adv"], h, self._act)
        if self.spec.dueling:
            v = mlp_forward(params["v"], h, self._act)
            return v + adv - adv.mean(dim=-1, keepdim=True)
        return adv

    def q_seq(self, params, obs_seq, state, reset_mask=None):
        """obs_seq [T, B, obs] + (h, c) → (q [T, B, A], final_state).

        reset_mask [T, B] (optional): rows where the carry is zeroed
        BEFORE consuming step t — replayed sequences spanning episode
        boundaries must reset the state exactly where the env runner did
        at collection time, or post-boundary targets train on hidden
        state inference never sees."""
        enc = self._encode(params, obs_seq)
        hs = []
        for t in range(enc.shape[0]):
            if reset_mask is not None:
                keep = (1.0 - reset_mask[t])[:, None]
                state = tuple(c * keep for c in state)
            h, state = self._cell(params, enc[t], state)
            hs.append(h)
        return self._q_from_h(params, torch.stack(hs)), state

    # ------------------------------------------- env-runner interfaces
    def explore_action_recurrent(self, params, obs, state,
                                 generator: torch.Generator):
        """One stateful step: eps-greedy over Q(h)."""
        enc = self._encode(params, obs)
        h, new_state = self._cell(params, enc, state)
        q = self._q_from_h(params, h)
        greedy = torch.argmax(q, dim=-1)
        random_a = torch.randint(0, self.spec.action_dim, greedy.shape,
                                 generator=generator, device=q.device)
        explore = torch.rand(greedy.shape, generator=generator,
                             device=q.device) < params["epsilon"]
        action = torch.where(explore, random_a, greedy)
        zeros = torch.zeros_like(q[..., 0])
        return action, zeros, q.max(dim=-1).values, new_state

    def forward(self, params, obs) -> Dict[str, torch.Tensor]:
        """Stateless facade (zero state) for last-vf bootstraps and
        non-recurrent callers."""
        squeeze = obs.dim() == 1
        x = obs[None] if squeeze else obs
        enc = self._encode(params, x)
        h, _ = self._cell(params, enc,
                          self.initial_state(x.shape[0], x.device))
        q = self._q_from_h(params, h)
        out = {"logits": q, "vf": q.max(dim=-1).values}
        if squeeze:
            out = {k: v[0] for k, v in out.items()}
        return out

    def explore_action(self, params, obs, generator: torch.Generator):
        a, logp, vf, _ = self.explore_action_recurrent(
            params, obs, self.initial_state(obs.shape[0], obs.device),
            generator)
        return a, logp, vf


# ------------------------------------------------------------------ learner
class R2D2Learner(DQNLearner):
    """Burn-in + double-DQN-along-the-unroll sequence loss
    (reference: r2d2_torch_policy.py r2d2_loss). The target sync, epsilon
    and state are DQN's."""

    def loss(self, params, batch):
        cfg = self.config
        gamma = cfg.get("gamma", 0.99)
        burn_in = cfg.get("burn_in", 0)
        use_h = cfg.get("use_h_function", True)
        tp = self.target_params

        # [B, T, ...] -> time-major [T, B, ...]
        obs = batch["obs"].transpose(0, 1)
        actions = batch["actions"].transpose(0, 1).long()
        rewards = batch["rewards"].transpose(0, 1)
        dones = batch["dones"].transpose(0, 1)
        valid = batch["valid"].transpose(0, 1).float()
        state = tuple(batch["state_in"])
        # mirror collection-time behavior: the runner zeroes (h, c) on the
        # step after a done, so the replayed unroll must reset the carry at
        # the same positions (step t resets iff step t-1 terminated)
        resets = torch.cat([torch.zeros_like(dones[:1]), dones[:-1]], dim=0)

        if burn_in > 0:
            # warm the state; no gradient through the burn-in prefix
            with torch.no_grad():
                _, state_on = self.module.q_seq(
                    params, obs[:burn_in], state, resets[:burn_in])
                _, state_tgt = self.module.q_seq(
                    tp, obs[:burn_in], state, resets[:burn_in])
            obs, actions = obs[burn_in:], actions[burn_in:]
            rewards = rewards[burn_in:]
            valid = valid[burn_in:]
            resets, dones = resets[burn_in:], dones[burn_in:]
        else:
            state_on = state_tgt = state

        q_online, _ = self.module.q_seq(params, obs, state_on, resets)
        with torch.no_grad():
            q_target, _ = self.module.q_seq(tp, obs, state_tgt, resets)
            # double DQN along the unroll: online argmax at t+1, target
            # eval
            a_star = torch.argmax(q_online[1:], dim=-1)           # [T-1,B]
            q_next = q_target[1:].gather(-1, a_star[..., None])[..., 0]
            if use_h:
                q_next = h_inverse(q_next)
            target = rewards[:-1] + gamma * (1.0 - dones[:-1]) * q_next
            if use_h:
                target = h_rescale(target)

        q_sa = q_online.gather(-1, actions[..., None])[..., 0]    # [T,B]
        td = q_sa[:-1] - target
        # the last step has no within-sequence successor; autoreset rows
        # are invalid. Terminal steps keep their loss even though their
        # successor row is an (invalid) autoreset step — done cuts the
        # bootstrap, so no successor is needed, and they carry the reward.
        mask = valid[:-1] * torch.maximum(dones[:-1], valid[1:])
        denom = torch.clamp(torch.sum(mask), min=1.0)
        loss = torch.sum(huber(td) * mask) / denom
        return loss, {
            "td_error_mean": torch.sum(td.abs() * mask) / denom,
            "qf_mean": torch.mean(q_sa),
        }

    def _batch(self, mb):
        mb = dict(mb)
        state = mb.pop("state_in")
        out = super()._batch(mb)
        out["state_in"] = tuple(torch.as_tensor(np.asarray(s)).to(
            self.device) for s in state)
        return out

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        metrics = self.compute_grads(self._batch(batch))
        self.opt_state.step()
        metrics.pop("grad_norm")
        return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------- algorithm
class R2D2Config(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or R2D2)
        self.lr = 5e-4
        self.train_batch_size = 16          # sequences per update
        self.replay_buffer_capacity = 4000  # sequences
        self.num_steps_sampled_before_learning_starts = 200
        self.target_network_update_freq = 400  # env steps
        self.training_intensity = 4.0
        self.epsilon = [(0, 1.0), (5_000, 0.05)]
        self.burn_in = 4
        self.model = {"use_lstm": True, "lstm_cell_size": 64,
                      "hiddens": (64,)}
        self.rollout_fragment_length = 20   # burn_in + unroll
        self.num_env_runners = 1
        self.use_h_function = True

    def _training_keys(self):
        return {"replay_buffer_capacity", "target_network_update_freq",
                "num_steps_sampled_before_learning_starts", "epsilon",
                "burn_in", "training_intensity", "use_h_function"}

    def learner_config_dict(self) -> Dict:
        d = super().learner_config_dict()
        d.update({"burn_in": self.burn_in,
                  "use_h_function": self.use_h_function})
        return d

    def module_spec(self) -> R2D2ModuleSpec:
        base = super().module_spec()
        if not base.discrete:
            raise ValueError("R2D2 supports discrete action spaces only")
        return R2D2ModuleSpec(
            obs_dim=base.obs_dim, action_dim=base.action_dim,
            hiddens=tuple(self.model.get("hiddens", (64,))),
            lstm_cell_size=int(self.model.get("lstm_cell_size", 64)),
            dueling=bool(self.model.get("dueling", True)))


class R2D2(Algorithm):
    learner_cls = R2D2Learner

    @classmethod
    def get_default_config(cls):
        return R2D2Config(algo_class=cls)

    def setup(self, _config) -> None:
        super().setup(_config)
        cfg = self.config
        self.replay = SequenceReplayBuffer(cfg.replay_buffer_capacity,
                                           seed=cfg.seed)
        self._steps_since_target_sync = 0

    def _epsilon_at(self, step: int) -> float:
        from ray_tpu_torch.rllib.utils.schedules import piecewise_linear

        return piecewise_linear(self.config.epsilon, step)

    def training_step(self) -> Dict:
        cfg = self.config
        learner = self.learner_group.local_learner()
        learner.set_epsilon(self._epsilon_at(self._total_env_steps))
        weights_ref = ray_tpu_torch.put(learner.get_weights())

        samples = self._sample_from_runners(weights_ref)
        new_steps = sum(s["env_steps"] for s in samples)
        for s in samples:
            self.replay.add_sequences(
                {"obs": s["obs"], "actions": s["actions"],
                 "rewards": s["rewards"], "dones": s["dones"],
                 "valid": s["valid"].astype(np.float32)},
                tuple(np.asarray(x) for x in s["state_in"]))

        metrics: Dict = {"env_steps_this_iter": new_steps}
        seq_len = cfg.rollout_fragment_length
        if len(self.replay) * seq_len < \
                cfg.num_steps_sampled_before_learning_starts:
            return metrics

        num_updates = max(1, int(new_steps * cfg.training_intensity
                                 / max(cfg.train_batch_size * seq_len, 1)))
        for _ in range(num_updates):
            batch = self.replay.sample(cfg.train_batch_size)
            # sampled sequences are [B, T, ...] already (buffer layout)
            metrics.update(learner.update(batch))
        self._steps_since_target_sync += new_steps
        if self._steps_since_target_sync >= cfg.target_network_update_freq:
            learner.sync_target()
            self._steps_since_target_sync = 0
        metrics["epsilon"] = self._epsilon_at(self._total_env_steps)
        return metrics
