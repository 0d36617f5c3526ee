"""Learning checks of the port's on-policy algorithms, with the reference's
configurations and reward thresholds unchanged (``tests/test_rllib.py``'s
``test_ppo_learns_cartpole``, ``tests/test_rllib_learning.py``'s
``test_impala_learns_chain``), the learners on ``device="cpu"``, on the
port's runtime.

One port cluster per module, ``init(num_cpus=4)``. ``ChainEnv`` is made
inside a function, so that it travels to the runners by value and no
worker imports this module."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def _chain_env():
    """``tests/test_rllib_learning.py``'s ChainEnv: a corridor of N cells,
    +1 for reaching the right end, a small step cost. A random walk rarely
    finishes; a learned right-moving policy scores ~0.9."""
    import gymnasium as gym

    class ChainEnv(gym.Env):
        N = 8
        MAX_STEPS = 24

        def __init__(self, config=None):
            self.observation_space = gym.spaces.Box(0.0, 1.0, (self.N,),
                                                    np.float32)
            self.action_space = gym.spaces.Discrete(2)
            self._pos = 0
            self._t = 0

        def _obs(self):
            obs = np.zeros(self.N, np.float32)
            obs[self._pos] = 1.0
            return obs

        def reset(self, *, seed=None, options=None):
            self._pos, self._t = 0, 0
            return self._obs(), {}

        def step(self, action):
            self._t += 1
            self._pos = min(max(self._pos + (1 if action == 1 else -1), 0),
                            self.N - 1)
            done = self._pos == self.N - 1
            trunc = self._t >= self.MAX_STEPS
            reward = 1.0 if done else -0.01
            return self._obs(), reward, done, trunc, {}

    return ChainEnv


def _run_until(algo, threshold, max_iters, key="episode_return_mean"):
    best = -np.inf
    for i in range(max_iters):
        result = algo.train()
        value = result.get(key)
        if value is not None:
            best = max(best, value)
        if best >= threshold:
            return best, i + 1
    return best, max_iters


def test_ppo_learns_cartpole(port_cluster):
    cfg = (PPOConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=8,
                        rollout_fragment_length=64)
           .training(lr=3e-4, train_batch_size=2048, minibatch_size=256,
                     num_epochs=6, entropy_coeff=0.01)
           .learners(device="cpu")
           .debugging(seed=0))
    algo = cfg.build()
    try:
        best, _ = _run_until(algo, threshold=150.0, max_iters=40)
        assert best >= 150.0, f"PPO failed to learn CartPole: best={best}"
        # inference helper: greedy action is valid
        act = algo.compute_single_action(np.zeros(4, np.float32))
        assert act in (0, 1)
    finally:
        algo.stop()


def test_impala_learns_chain(port_cluster):
    cfg = (IMPALAConfig()
           .environment(_chain_env())
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=24)
           .training(lr=3e-3, entropy_coeff=0.005)
           .learners(device="cpu")
           .debugging(seed=0))
    cfg.num_fragments_per_step = 4
    algo = cfg.build()
    try:
        best, _ = _run_until(algo, threshold=0.8, max_iters=60)
        assert best >= 0.8, f"IMPALA failed to learn ChainEnv: best={best}"
    finally:
        algo.stop()
