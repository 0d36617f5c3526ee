# Ported from ray_tpu/rllib/env/env_runner.py (ray_tpu -> ray_tpu_torch).
"""EnvRunner — rollout actor (reference: rllib/env/env_runner.py:15 +
env/single_agent_env_runner.py; the old-stack RolloutWorker
evaluation/rollout_worker.py:159 ``sample`` :653).

CPU actor stepping a vector env (``vector.py``, the port's copy of
gymnasium's ``SyncVectorEnv`` stepping); policy inference is the RLModule's
forward on a (num_envs, obs_dim) batch of CPU tensors, so the hot loop is
numpy env stepping + one forward per step. The runner's module runs on the
CPU whatever device the learner holds: the weights it is given are CPU
tensors (``Learner.get_weights``), and exploration draws from a CPU
``torch.Generator`` seeded with the runner's seed (the JAX package's
``jax.random`` key).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.tree import tree_map
from ray_tpu_torch.rllib.env.vector import SyncVectorEnv

CPU = torch.device("cpu")


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block: the runner's inference
    batches are a few rows, where waking the thread pool costs more than
    the products."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def cpu_weights(weights):
    """A weights tree (tensors or numpy arrays) as CPU tensors; CPU tensors
    pass through as they are."""
    return tree_map(lambda w: torch.as_tensor(w, device=CPU), weights)


class SingleAgentEnvRunner:
    def __init__(self, env_creator: Callable, num_envs: int,
                 rollout_fragment_length: int, module_spec,
                 seed: int = 0, explore: bool = True,
                 gamma: float = 0.99, collect_next_obs: bool = False,
                 connector=None):
        self.num_envs = num_envs
        self.T = rollout_fragment_length
        self.gamma = gamma
        self.env = SyncVectorEnv(
            [lambda i=i: env_creator() for i in range(num_envs)])
        self.module = module_spec.build()
        self._gen = torch.Generator(device=CPU).manual_seed(seed)
        self._explore = explore
        # obs/action transform pipeline (reference: rllib/connectors/)
        self.connector = connector
        # off-policy algos (DQN/SAC) need (s, a, r, s') tuples
        self._collect_next_obs = collect_next_obs

        # recurrent modules (R2D2's LSTM Q-net) expose explore_action_
        # recurrent + initial_state: the runner carries (h, c) across
        # steps, zeroes rows on episode reset, and records each fragment's
        # STARTING state so replay can resume it (reference:
        # rllib/algorithms/r2d2 stored-state replay)
        self._recurrent = hasattr(self.module, "explore_action_recurrent") \
            and hasattr(self.module, "initial_state")
        if self._recurrent:
            self._state = tuple(np.asarray(s) for s in
                                self.module.initial_state(num_envs))
            if explore:
                self._explore_rec = self.module.explore_action_recurrent
            else:
                # evaluation rollouts: force greedy by zeroing the
                # module's exploration epsilon (rides in params)
                def _greedy_rec(weights, obs, state, generator):
                    if "epsilon" in weights:
                        weights = dict(
                            weights,
                            epsilon=torch.zeros_like(weights["epsilon"]))
                    return self.module.explore_action_recurrent(
                        weights, obs, state, generator)

                self._explore_rec = _greedy_rec
        if explore:
            self._explore_fn = self.module.explore_action
        else:
            # greedy/deterministic inference (ES candidate evaluation,
            # evaluation rollouts): mode of the action distribution
            self._explore_fn = self._greedy_action

        obs, _ = self.env.reset(seed=seed)
        if self.connector is not None:
            self.connector.on_episode_start()
            obs = self.connector.on_obs(obs)
        self._obs = obs.astype(np.float32)
        self._ep_return = np.zeros(num_envs)
        self._ep_len = np.zeros(num_envs, dtype=np.int64)
        self._completed: List[Dict] = []
        # gymnasium >= 1.0 vector envs autoreset on the step AFTER an
        # episode ends (the action there is ignored, reward is 0) — those
        # transitions are bogus training samples and get masked out
        self._prev_done = np.zeros(num_envs, dtype=bool)

    def _greedy_action(self, weights, obs, generator):
        """Deterministic action with the explore_action signature: argmax
        for discrete modules, distribution mode / deterministic policy
        output for continuous ones."""
        if hasattr(self.module, "greedy_action"):
            return self.module.greedy_action(weights, obs)
        out = self.module.forward(weights, obs)
        logits = out["logits"]
        if getattr(self.module.spec, "discrete", False):
            action = torch.argmax(logits, dim=-1)
            logp = self.module.dist.logp(logits, action) \
                if hasattr(self.module, "dist") else torch.zeros(obs.shape[0])
        elif hasattr(self.module, "dist"):
            action = self.module.dist.split(logits)[0] \
                if hasattr(self.module.dist, "split") else logits
            logp = self.module.dist.logp(logits, action)
        else:
            # deterministic continuous modules (SAC/DDPG forward already
            # returns the greedy action as "logits")
            action = logits
            logp = torch.zeros(obs.shape[0])
        return action, logp, out["vf"]

    def _vf(self, weights, obs: np.ndarray) -> np.ndarray:
        return self.module.forward(
            weights, torch.from_numpy(obs))["vf"].numpy().astype(np.float32)

    def ping(self) -> bool:
        return True

    def device_report(self) -> Dict[str, Any]:
        """This runner's process and what it sees of CUDA: its pid, its
        ``CUDA_VISIBLE_DEVICES`` (set only by a GPU lease) and whether CUDA
        was initialized in it (never by the runner: its module runs on the
        CPU)."""
        import os

        return {"pid": os.getpid(),
                "cuda_visible_devices": os.environ.get(
                    "CUDA_VISIBLE_DEVICES"),
                "cuda_initialized": torch.cuda.is_initialized()}

    @torch.no_grad()
    def sample(self, weights) -> Dict[str, Any]:
        """One (T, E) fragment using the given policy weights."""
        with one_thread():
            return self._sample(cpu_weights(weights))

    def _sample(self, weights) -> Dict[str, Any]:
        t0 = time.perf_counter()
        obs_buf = np.empty((self.T, self.num_envs) + self._obs.shape[1:],
                           np.float32)
        act_buf: Optional[np.ndarray] = None
        logp_buf = np.empty((self.T, self.num_envs), np.float32)
        vf_buf = np.empty((self.T, self.num_envs), np.float32)
        rew_buf = np.empty((self.T, self.num_envs), np.float32)
        done_buf = np.empty((self.T, self.num_envs), np.float32)
        valid_buf = np.empty((self.T, self.num_envs), bool)
        next_obs_buf = (np.empty_like(obs_buf)
                        if self._collect_next_obs else None)

        # fragment-start recurrent state (rides the sample for replay)
        start_state = (tuple(s.copy() for s in self._state)
                       if self._recurrent else None)

        for t in range(self.T):
            obs_t = torch.from_numpy(self._obs)
            if self._recurrent:
                # zero state rows whose episode just reset (autoreset step)
                if self._prev_done.any():
                    mask = (~self._prev_done).astype(np.float32)[:, None]
                    self._state = tuple(s * mask for s in self._state)
                    if t == 0:
                        start_state = tuple(s.copy() for s in self._state)
                action, logp, vf, new_state = self._explore_rec(
                    weights, obs_t,
                    tuple(torch.from_numpy(np.asarray(s))
                          for s in self._state), self._gen)
                self._state = tuple(np.asarray(s) for s in new_state)
            else:
                action, logp, vf = self._explore_fn(weights, obs_t,
                                                    self._gen)
            action = np.asarray(action)
            if act_buf is None:
                act_buf = np.empty((self.T,) + action.shape, action.dtype)
            obs_buf[t] = self._obs
            act_buf[t] = action
            logp_buf[t] = np.asarray(logp)
            vf_buf[t] = np.asarray(vf)
            env_action = action
            if self.connector is not None:
                env_action = self.connector.on_action(env_action)
            if not self.module.spec.discrete:
                low = self.env.single_action_space.low
                high = self.env.single_action_space.high
                env_action = np.clip(env_action, low, high)
            valid_buf[t] = ~self._prev_done
            obs, rew, term, trunc, _ = self.env.step(env_action)
            if self.connector is not None:
                # transform BEFORE any forward pass so vf bootstraps and
                # the stored next obs see the same features as inference.
                # prev_done envs just autoreset: this obs begins a fresh
                # episode, so stateful connectors clear those rows
                obs = self.connector.on_obs(obs,
                                            reset_mask=self._prev_done)
            done = np.logical_or(term, trunc)
            rew = np.asarray(rew, np.float32)
            rew_raw = rew
            trunc_only = np.logical_and(trunc, ~term)
            if trunc_only.any():
                # time-limit truncation: bootstrap with V(final_obs) folded
                # into the reward (the obs returned at a truncated step IS
                # the final obs under next-step autoreset), then cut the
                # recursion like a termination
                vf_final = self._vf(weights, obs.astype(np.float32))
                rew = rew + self.gamma * vf_final * trunc_only
            rew_buf[t] = rew
            done_buf[t] = done.astype(np.float32)
            live = ~self._prev_done
            self._ep_return += rew_raw * live
            self._ep_len += live.astype(np.int64)
            for i in np.nonzero(np.logical_and(done, live))[0]:
                self._completed.append({
                    "episode_return": float(self._ep_return[i]),
                    "episode_len": int(self._ep_len[i]),
                })
                self._ep_return[i] = 0.0
                self._ep_len[i] = 0
            self._prev_done = done
            self._obs = obs.astype(np.float32)
            if next_obs_buf is not None:
                next_obs_buf[t] = self._obs

        last_vf = self._vf(weights, self._obs)
        episodes, self._completed = self._completed, []
        out = {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "vf": vf_buf, "rewards": rew_buf, "dones": done_buf,
            "valid": valid_buf, "last_vf": last_vf,
            "episodes": episodes,
            "env_steps": self.T * self.num_envs,
            "sample_time_s": time.perf_counter() - t0,
        }
        if next_obs_buf is not None:
            out["next_obs"] = next_obs_buf
        if self._recurrent:
            out["state_in"] = start_state
        return out

    def stop(self):
        self.env.close()
        return True
