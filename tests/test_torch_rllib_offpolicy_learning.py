"""The port's off-policy algorithms on the port's runtime, on the CPU: the
reference's mechanics cases of SAC (``tests/test_rllib.py``) and DDPG/TD3
(``tests/test_rllib_algos.py``) on gymnasium's Pendulum, and its learning
cases with their configs and reward thresholds unchanged:
``tests/test_rllib_learning.py``'s DQN learns the chain and SAC learns
target tracking, ``tests/test_rllib_qmix_models.py``'s Ape-X (its replay
in an actor, its runners on an epsilon ladder) learns the chain. The
learners are on ``device="cpu"``.

One port cluster per module, ``init(num_cpus=4)``. ``ChainEnv`` (from
``tests/test_torch_rllib_learning.py``) and ``TargetEnv`` are made inside
functions, so that they travel to the runners by value."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from tests.test_torch_rllib_learning import (  # noqa: E402
    _chain_env, _run_until)
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


def _target_env():
    """``tests/test_rllib_learning.py``'s TargetEnv: 1-D continuous control,
    reward -(action - g(obs))^2 a step. Optimal return 0; a random policy
    in [-2, 2] scores about -1.3 a step."""
    import gymnasium as gym

    class TargetEnv(gym.Env):
        HORIZON = 16

        def __init__(self, config=None):
            self.observation_space = gym.spaces.Box(-1.0, 1.0, (2,),
                                                    np.float32)
            self.action_space = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)
            self._rng = np.random.default_rng(0)
            self._t = 0
            self._obs_v = np.zeros(2, np.float32)

        def _target(self):
            return 0.8 * self._obs_v[0] - 0.5 * self._obs_v[1]

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._t = 0
            self._obs_v = self._rng.uniform(-1, 1, 2).astype(np.float32)
            return self._obs_v.copy(), {}

        def step(self, action):
            self._t += 1
            a = float(np.clip(np.asarray(action).reshape(-1)[0], -2.0, 2.0))
            reward = -((a - self._target()) ** 2)
            self._obs_v = self._rng.uniform(-1, 1, 2).astype(np.float32)
            return (self._obs_v.copy(), reward, False,
                    self._t >= self.HORIZON, {})

    return TargetEnv


# ----------------------------------------------------------- mechanics

def test_sac_mechanics(port_cluster):
    from ray_tpu_torch.rllib import SACConfig

    cfg = (SACConfig()
           .environment("Pendulum-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=8)
           .training(train_batch_size=64,
                     num_steps_sampled_before_learning_starts=100,
                     training_intensity=0.25)
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        for _ in range(6):
            result = algo.step()
        assert np.isfinite(result["critic_loss"])
        assert np.isfinite(result["actor_loss"])
        assert result["alpha"] > 0
        # entropy target pull: alpha must have moved off its init
        assert abs(result["alpha"] - 1.0) > 1e-4
    finally:
        algo.stop()


@pytest.mark.parametrize("algo_name", ["DDPG", "TD3"])
def test_ddpg_td3_mechanics(port_cluster, algo_name):
    import ray_tpu_torch.rllib as rllib

    cfg_cls = getattr(rllib, algo_name + "Config")
    cfg = (cfg_cls()
           .environment("Pendulum-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=8)
           .training(train_batch_size=64,
                     num_steps_sampled_before_learning_starts=100,
                     training_intensity=0.25)
           .learners(device="cpu"))
    if algo_name == "TD3":
        assert cfg.twin_q and cfg.policy_delay == 2 \
            and cfg.target_noise == 0.2
    algo = cfg.build()
    try:
        for _ in range(6):
            r = algo.step()
        assert np.isfinite(r["critic_loss"])
        assert np.isfinite(r["actor_loss"])
        assert np.isfinite(r["qf_mean"])
    finally:
        algo.stop()


# ------------------------------------------------------------ learning

def test_dqn_learns_chain(port_cluster):
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig()
           .environment(_chain_env())
           .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                        rollout_fragment_length=24)
           .training(lr=1e-3, train_batch_size=64, gamma=0.97)
           .learners(device="cpu")
           .debugging(seed=0))
    cfg.epsilon = [(0, 1.0), (10000, 0.05)]
    cfg.num_steps_sampled_before_learning_starts = 400
    cfg.target_network_update_freq = 500
    cfg.training_intensity = 4.0
    algo = cfg.build()
    try:
        # random policy scores ~0.2 and an un-learned greedy policy drifts
        # negative; 0.5 is only reachable by actually learning to go right
        best, iters = _run_until(algo, threshold=0.5, max_iters=100)
        assert best >= 0.5, f"DQN failed to learn ChainEnv: best={best}"
    finally:
        algo.stop()


def test_sac_learns_target_tracking(port_cluster):
    from ray_tpu_torch.rllib import SACConfig

    cfg = (SACConfig()
           .environment(_target_env())
           .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                        rollout_fragment_length=16)
           .training(lr=3e-3, train_batch_size=128, gamma=0.9)
           .learners(device="cpu")
           .debugging(seed=0))
    cfg.num_steps_sampled_before_learning_starts = 256
    algo = cfg.build()
    try:
        # random return ~ -17..-20 per 16-step episode; learned ~ -5
        best, iters = _run_until(algo, threshold=-6.0, max_iters=80)
        assert best >= -6.0, f"SAC failed to learn TargetEnv: best={best}"
    finally:
        algo.stop()


def test_apex_distributed_replay_learns_chain(port_cluster):
    """Ape-X: replay lives in a dedicated actor, runners explore on an
    epsilon ladder — and it still learns (reward-gated)."""
    from ray_tpu_torch.rllib import ApexDQNConfig

    cfg = (ApexDQNConfig()
           .environment(_chain_env())
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=24)
           .training(lr=1e-3, train_batch_size=64, gamma=0.97)
           .learners(device="cpu")
           .debugging(seed=0))
    cfg.epsilon = [(0, 1.0), (10000, 0.05)]
    cfg.num_steps_sampled_before_learning_starts = 400
    cfg.target_network_update_freq = 500
    cfg.training_intensity = 4.0
    algo = cfg.build()
    try:
        eps = algo._runner_epsilons()
        assert len(eps) == 2 and eps[0] > eps[1]  # exploration ladder
        best = -np.inf
        for i in range(100):
            r = algo.train()
            ret = r.get("episode_return_mean")
            if ret is not None:
                best = max(best, ret)
            if i == 3:
                assert r["replay_actor_size"] > 0  # replay is off-driver
            if best >= 0.5:
                break
        assert best >= 0.5, f"ApexDQN failed to learn: best={best}"
    finally:
        algo.stop()
