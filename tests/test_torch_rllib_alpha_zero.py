"""The port's AlphaZero against the JAX package's, on the CPU: the MCTS
(the port keeps its own copy) against JAX's with the same ``predict`` and
numpy rng (equal visit counts), a self-play worker's episodes from carried
weights and the same seed, and one learner step (metrics and params); and
the reference's ``test_alpha_zero_learns_chain``,
``test_alpha_zero_requires_state_hooks`` and
``test_mcts_prefers_rewarding_branch`` (``tests/test_rllib_breadth.py``)
with their configs and thresholds unchanged, the learner on
``device="cpu"``.

``ChainEnv`` is the reference test's corridor with ``get_state`` /
``set_state``, made inside a function so that it travels to the self-play
workers by value. The learning cases run on one port cluster,
``init(num_cpus=4)``. Tolerances: search policies and visit counts
exact; priors, values and the learner's metrics 1e-5 relative (to the
value, or to 0.1 where it is smaller); after the step each param leaf's
distance from JAX's within 1e-3 of its update's norm."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.algorithms.alpha_zero import alpha_zero as jaz  # noqa: E402
from ray_tpu.rllib.core.rl_module import (  # noqa: E402
    RLModuleSpec as JSpec)
from ray_tpu_torch.rllib.algorithms.alpha_zero import (  # noqa: E402
    alpha_zero as taz)
from ray_tpu_torch.rllib.core.rl_module import (  # noqa: E402
    RLModuleSpec, rl_params_from_jax)
from tests.test_torch_rllib_core import (  # noqa: E402
    TOL, _named, _update_close)
from tests.test_torch_rllib_learning import _run_until  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

N = 8
SPEC = dict(obs_dim=N, action_dim=2, hiddens=(16, 16))
MCTS_CFG = {"num_simulations": 24, "c_puct": 1.5, "gamma": 0.99,
            "dirichlet_alpha": 0.3, "dirichlet_eps": 0.25,
            "temperature_moves": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain_env():
    """``tests/test_rllib_breadth.py``'s ChainEnv: a corridor, +1 at the
    right end, a small step cost, and ``get_state`` / ``set_state`` so
    that MCTS can use the env as its own model."""
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

        # perfect-information hooks for AlphaZero's search
        def get_state(self):
            return (self._pos, self._t)

        def set_state(self, state):
            self._pos, self._t = state

    return ChainEnv


def _skewed_predict(obs):
    """A fixed, position-dependent prior and value."""
    pos = int(np.argmax(obs[0]))
    p = np.asarray([0.3 + 0.05 * pos, 0.7 - 0.05 * pos], np.float32)
    return p, 0.1 * pos - 0.2


@pytest.mark.parametrize("start,eps", [(0, 0.25), (3, 0.0), (5, 0.25)])
def test_mcts_visit_counts_match_jax(start, eps):
    env_cls = _chain_env()
    pis = []
    for mcts_cls in (jaz.MCTS, taz.MCTS):
        env = env_cls()
        env.reset()
        env.set_state((start, 0))
        mcts = mcts_cls(env, _skewed_predict, num_simulations=40,
                        dirichlet_eps=eps, rng=np.random.default_rng(4))
        obs = np.zeros(N, np.float32)
        obs[start] = 1.0
        pis.append(mcts.search(obs))
    assert pis[1].dtype == pis[0].dtype == np.float32
    # visit fractions of 41 visits: equal counts, bit for bit
    assert np.array_equal(pis[1], pis[0])


def test_self_play_worker_matches_jax():
    env_cls = _chain_env()
    jp = JSpec(**SPEC).build().init(jax.random.key(2))
    jw = jaz.SelfPlayWorker(env_cls, JSpec(**SPEC), dict(MCTS_CFG), seed=5)
    tw = taz.SelfPlayWorker(env_cls, RLModuleSpec(**SPEC), dict(MCTS_CFG),
                            seed=5)
    want = jw.play(jp, 2)
    got = tw.play(rl_params_from_jax(jax.device_get(jp)), 2)
    assert got["env_steps"] == want["env_steps"]
    assert got["episode_returns"] == want["episode_returns"]
    assert np.array_equal(got["obs"], want["obs"])
    assert np.array_equal(got["pi"], want["pi"])
    assert np.array_equal(got["z"], want["z"])


def test_learner_step_matches_jax():
    config = {"lr": 5e-3, "seed": 0, "vf_coeff": 1.0}
    jl = jaz.AlphaZeroLearner(JSpec(**SPEC), dict(config))
    tl = taz.AlphaZeroLearner(RLModuleSpec(**SPEC), dict(config),
                              device="cpu")
    tl.set_weights(rl_params_from_jax(jax.device_get(jl.params)))
    rng = np.random.default_rng(1)
    init = jax.device_get(jl.params)
    for _ in range(2):
        pi = rng.dirichlet([0.5, 0.5], 32).astype(np.float32)
        batch = {"obs": np.eye(N, dtype=np.float32)[rng.integers(0, N, 32)],
                 "pi": pi, "z": rng.uniform(-1, 1, 32).astype(np.float32)}
        want, got = jl.update(batch), tl.update(batch)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert abs(got[k] - w) <= TOL * max(abs(w), 0.1), k
    _update_close(tl.get_weights(), jax.device_get(jl.params), init)
    state = tl.get_state()
    twin = taz.AlphaZeroLearner(RLModuleSpec(**SPEC), dict(config, seed=3),
                                device="cpu")
    twin.set_state(state)
    assert twin.update(batch) == tl.update(batch)
    assert all(np.array_equal(a, b) for a, b in zip(
        _named(twin.get_weights()).values(),
        _named(tl.get_weights()).values()))


def test_mcts_prefers_rewarding_branch():
    """Search-level unit test: from the second-to-last cell, MCTS visit
    counts must mass on the winning move even with uniform priors."""
    from ray_tpu_torch.rllib.algorithms.alpha_zero import MCTS

    env_cls = _chain_env()
    env = env_cls()
    env.reset()
    env.set_state((env_cls.N - 2, 0))

    def uniform_predict(obs):
        return np.ones(2, np.float32) / 2, 0.0

    mcts = MCTS(env, uniform_predict, num_simulations=64,
                dirichlet_eps=0.0, rng=np.random.default_rng(0))
    obs = np.zeros(env_cls.N, np.float32)
    obs[env_cls.N - 2] = 1.0
    pi = mcts.search(obs)
    assert pi[1] > 0.7, f"MCTS policy {pi}"


# -------------------------------------------------------------- learning

@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_alpha_zero_learns_chain(port_cluster, tmp_path):
    from ray_tpu_torch.rllib import AlphaZeroConfig

    env_cls = _chain_env()
    cfg = (AlphaZeroConfig()
           .environment(env_cls)
           .env_runners(num_env_runners=2)
           .training(lr=5e-3, train_batch_size=128, num_simulations=24,
                     episodes_per_worker=2, sgd_steps_per_iter=8,
                     temperature_moves=4)
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        best, iters = _run_until(algo, 0.8, 12)
        # MCTS lookahead makes the corridor easy: near-optimal fast
        assert best >= 0.8, f"AlphaZero best={best}"
        # and the trained net alone (no search) must act greedily right
        obs = np.zeros(env_cls.N, np.float32)
        obs[0] = 1.0
        assert algo.compute_single_action(obs) == 1
        # a checkpoint restores the learner's params and Adam state
        algo.save_checkpoint(str(tmp_path))
        state = algo.learner.get_state()
        algo.learner.set_weights(taz.AlphaZeroLearner(
            algo._module_spec, {"seed": 9}, device="cpu").get_weights())
        algo.load_checkpoint(str(tmp_path))
        for a, b in zip(_named(algo.learner.get_state()).values(),
                        _named(state).values()):
            assert np.array_equal(a, b)
    finally:
        algo.stop()


def test_alpha_zero_requires_state_hooks(port_cluster):
    from ray_tpu_torch.rllib import AlphaZeroConfig

    class NoStateEnv(_chain_env()):
        get_state = None
        set_state = None

    with pytest.raises(ValueError, match="get_state"):
        AlphaZeroConfig().environment(NoStateEnv).learners(
            device="cpu").build()
