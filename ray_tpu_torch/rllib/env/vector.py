"""Synchronous vector env: the part of gymnasium's ``SyncVectorEnv`` that
the env runner uses, kept in the port.

The JAX package's ``SingleAgentEnvRunner`` steps a
``gymnasium.vector.SyncVectorEnv``. The port keeps its own copy of that
stepping because the machine that runs the port on the card has no
gymnasium: an env passed as a class or a callable only has to follow
gymnasium's ``reset``/``step`` API, and the runner needs nothing else of
the library. A string env id (``environment("CartPole-v1")``) still goes
through ``gymnasium.make`` (``AlgorithmConfig.make_env``), and raises
``ImportError`` where gymnasium is missing.

What it reproduces of gymnasium >= 1.0's ``SyncVectorEnv``
(``autoreset_mode=NEXT_STEP``, the default):

- ``reset(seed=s)`` resets env i with seed ``s + i`` (``None`` for all when
  ``s`` is None);
- next-step autoreset: the step after env i's episode ended resets env i
  instead of stepping it, ignores its action, and reports reward 0 and
  neither terminated nor truncated, with the new episode's first obs;
- obs stacked along a new first axis (the single obs space's dtype where
  it has one), rewards as float64, ``terminated`` and ``truncated`` as
  bool arrays; infos are not merged (an empty dict);
- ``single_action_space``, ``num_envs`` and ``close``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class SyncVectorEnv:
    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_action_space = self.envs[0].action_space
        self._obs_dtype = getattr(self.envs[0].observation_space, "dtype",
                                  None)
        self._autoreset = np.zeros(self.num_envs, dtype=bool)

    def _stack(self, obs: List) -> np.ndarray:
        return np.stack([np.asarray(o, dtype=self._obs_dtype) for o in obs])

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Dict] = None):
        seeds = ([None] * self.num_envs if seed is None
                 else [seed + i for i in range(self.num_envs)])
        obs = []
        for env, s in zip(self.envs, seeds):
            o, _ = env.reset(seed=s, options=options)
            obs.append(o)
        self._autoreset[:] = False
        return self._stack(obs), {}

    def step(self, actions):
        actions = list(actions)
        obs: List = []
        rewards = np.zeros(self.num_envs, dtype=np.float64)
        terminated = np.zeros(self.num_envs, dtype=bool)
        truncated = np.zeros(self.num_envs, dtype=bool)
        for i, env in enumerate(self.envs):
            if self._autoreset[i]:
                o, _ = env.reset()
            else:
                o, r, term, trunc, _ = env.step(actions[i])
                rewards[i] = r
                terminated[i] = term
                truncated[i] = trunc
            obs.append(o)
        self._autoreset = np.logical_or(terminated, truncated)
        return self._stack(obs), rewards, terminated, truncated, {}

    def close(self) -> None:
        for env in self.envs:
            close = getattr(env, "close", None)
            if close is not None:
                close()


__all__ = ["SyncVectorEnv"]
