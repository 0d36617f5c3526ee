"""The port's QMIX and MADDPG against the JAX package's, on the CPU: the
agent Q net, the mixer and its monotonicity, the stacked actors and
critics, one update each from carried weights and targets on the same
replay batch (loss and params), and N steps of the driver's collection
step for step from the same numpy seed and carried params; and the
reference's ``test_qmix_learns_coordination``,
``test_qmix_mixer_is_monotonic`` (``tests/test_rllib_qmix_models.py``) and
``test_maddpg_learns_coop_target`` (``tests/test_rllib_maddpg_bandit.py``)
with their configs and thresholds unchanged, on ``device="cpu"``.

Both algorithms drive their env in the driver, so no runtime is booted;
the envs are the reference tests' ``CoordGame`` and ``CoopTargetEnv`` on
the port's ``MultiAgentEnv`` (the JAX algorithms read them by duck
typing). Weights go from JAX to the port through ``rl_params_from_jax``.
Tolerances: forwards, losses and collected actions 1e-5 relative (to the
value, or to 0.1 where it is smaller); after an update each param leaf's
distance from JAX's within 1e-3 of its update's norm."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

from typing import Dict  # noqa: E402

import gymnasium as gym  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.rllib.algorithms.maddpg import maddpg as jmaddpg  # noqa: E402
from ray_tpu.rllib.algorithms.qmix import qmix as jqmix  # noqa: E402
from ray_tpu_torch.rllib.algorithms.dqn.dqn import load_tree  # noqa: E402
from ray_tpu_torch.rllib.algorithms.maddpg import (  # noqa: E402
    maddpg as tmaddpg)
from ray_tpu_torch.rllib.algorithms.qmix import qmix as tqmix  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import rl_params_from_jax  # noqa: E402
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv  # noqa: E402
from tests.test_torch_rllib_core import (  # noqa: E402
    TOL, _named, _rel_max, _update_close)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CoordGame(MultiAgentEnv):
    """Two agents, 3 actions, one step: both picking action 2 pays +10
    total; both picking 0 pays +4 (safe); any mismatch pays 0. Greedy
    independent learners get stuck on the safe action; QMIX's joint value
    factorization finds the coordinated optimum."""

    possible_agents = ["a0", "a1"]

    def __init__(self, config=None):
        self._obs_space = gym.spaces.Box(0.0, 1.0, (2,), np.float32)
        self._act_space = gym.spaces.Discrete(3)

    @property
    def observation_spaces(self):
        return {a: self._obs_space for a in self.possible_agents}

    @property
    def action_spaces(self):
        return {a: self._act_space for a in self.possible_agents}

    def reset(self, *, seed=None):
        obs = np.asarray([1.0, 0.0], np.float32)
        return {a: obs.copy() for a in self.possible_agents}, {}

    def step(self, action_dict):
        a0, a1 = action_dict["a0"], action_dict["a1"]
        if a0 == 2 and a1 == 2:
            team = 10.0
        elif a0 == 0 and a1 == 0:
            team = 4.0
        else:
            team = 0.0
        obs = {a: np.asarray([0.0, 1.0], np.float32)
               for a in self.possible_agents}
        rewards = {a: team / 2 for a in self.possible_agents}
        dones = {"__all__": True, "a0": True, "a1": True}
        truncs = {"__all__": False}
        return obs, rewards, dones, truncs, {}


class CoopTargetEnv(MultiAgentEnv):
    """Two agents each see a private target; team reward =
    -Σ(a_i - target_i)² per step. Optimal return 0; random ~ -2/step."""

    HORIZON = 8
    possible_agents = ["a0", "a1"]

    def __init__(self, config=None):
        self._box = gym.spaces.Box(-1.0, 1.0, (2,), np.float32)
        self._act = gym.spaces.Box(-1.0, 1.0, (1,), np.float32)
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._obs: Dict[str, np.ndarray] = {}

    @property
    def observation_spaces(self):
        return {a: self._box for a in self.possible_agents}

    @property
    def action_spaces(self):
        return {a: self._act for a in self.possible_agents}

    def _sample_obs(self):
        return {a: self._rng.uniform(-1, 1, 2).astype(np.float32)
                for a in self.possible_agents}

    @staticmethod
    def _target(obs):
        return 0.7 * obs[0] - 0.4 * obs[1]

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._obs = self._sample_obs()
        return self._obs, {}

    def step(self, action_dict):
        self._t += 1
        err = 0.0
        for a in self.possible_agents:
            act = float(np.asarray(action_dict[a]).reshape(-1)[0])
            err += (act - self._target(self._obs[a])) ** 2
        reward = -err
        self._obs = self._sample_obs()
        done = self._t >= self.HORIZON
        rewards = {a: reward / 2 for a in self.possible_agents}
        terms = {a: False for a in self.possible_agents}
        terms["__all__"] = False
        truncs = {a: done for a in self.possible_agents}
        truncs["__all__"] = done
        return self._obs, rewards, terms, truncs, {}


def to_port(tree):
    return rl_params_from_jax(jax.device_get(tree))


def perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda t: t + jnp.asarray(
        0.05 * rng.normal(size=np.shape(t)), jnp.float32), tree)


def _close(got, want):
    return abs(got - want) <= TOL * max(abs(want), 0.1)


def _assert_replay_equal(got, want, exact=("actions", "dones")):
    g, w = got.replay._storage, want.replay._storage
    n = len(want.replay)
    assert len(got.replay) == n and g.keys() == w.keys()
    for k in w:
        if k in exact:
            assert np.array_equal(g[k][:n], w[k][:n]), k
        else:
            assert _rel_max(g[k][:n], w[k][:n], 0.1) <= TOL, k


# ------------------------------------------------------------------ QMIX

def test_qmix_model_matches_jax_and_is_monotonic():
    kw = dict(obs_dim=4, state_dim=8, n_agents=2, n_actions=3, hidden=16,
              mix_embed=8)
    jm, tm = jqmix.QMixModel(**kw), tqmix.QMixModel(**kw)
    jp = jm.init(jax.random.key(1))
    tp = to_port(jp)
    assert _named(tp).keys() == _named(jax.device_get(jp)).keys()
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(5, 2, 4)).astype(np.float32)
    q = rng.normal(size=(5, 2)).astype(np.float32)
    state = rng.normal(size=(5, 8)).astype(np.float32)
    assert _rel_max(tm.agent_qs(tp, torch.from_numpy(obs)),
                    jm.agent_qs(jp, obs)) < TOL
    mixed = tm.mix(tp, torch.from_numpy(q), torch.from_numpy(state))
    assert _rel_max(mixed, jm.mix(jp, q, state)) < TOL
    # raising any agent's Q never lowers Q_tot, row by row
    for i in range(2):
        bumped = q.copy()
        bumped[:, i] += 0.5
        up = tm.mix(tp, torch.from_numpy(bumped), torch.from_numpy(state))
        assert bool((up >= mixed - 1e-5).all())


def test_qmix_mixer_is_monotonic():
    from ray_tpu_torch.rllib.algorithms.qmix.qmix import QMixModel

    model = QMixModel(obs_dim=4, state_dim=8, n_agents=2, n_actions=3)
    params = model.init(torch.Generator().manual_seed(0))
    state = torch.ones((1, 8))
    q = torch.tensor([[0.3, -0.2]])
    base = model.mix(params, q, state)[0]
    # raising any agent's Q must not lower Q_tot (monotonic mixing)
    for i in range(2):
        bumped = q.clone()
        bumped[0, i] += 0.5
        assert model.mix(params, bumped, state)[0] >= base - 1e-5


def _qmix_pair(**training):
    def cfg(mod):
        return (mod.QMIXConfig().environment(CoordGame)
                .training(lr=2e-3, train_batch_size=32, **training)
                .debugging(seed=3))

    jq = cfg(jqmix).build()
    tq = cfg(tqmix).learners(device="cpu").build()
    jq.target_params = perturbed(jq.params, 4)
    load_tree(tq.params, to_port(jq.params))
    load_tree(tq.target_params, to_port(jq.target_params))
    return jq, tq


def test_qmix_collection_and_update_match_jax():
    jq, tq = _qmix_pair()
    # epsilon 1 -> 0.05 over the first 600 steps: both branches are taken
    jq.config.epsilon = tq.config.epsilon = [(0, 1.0), (600, 0.05)]
    for _ in range(4):
        assert jq._collect(200) == tq._collect(200) == 200
    _assert_replay_equal(tq, jq)
    assert tq._episode_returns == jq._episode_returns
    batch, tbatch = jq.replay.sample(32), tq.replay.sample(32)
    assert all(np.array_equal(v, tbatch[k]) for k, v in batch.items())
    init = jax.device_get(jq.params)
    for step in range(2):
        (jq.params, jq.opt_state, loss, td) = jq._update_fn(
            jq.params, jq.target_params, jq.opt_state, batch)
        got = tq.update(batch)
        assert _close(got["qmix_loss"], float(loss)), step
        assert _close(got["td_error_mean"], float(td)), step
    _update_close(tq.params, jax.device_get(jq.params), init)


def test_qmix_checkpoint_round_trip(tmp_path):
    _, tq = _qmix_pair()
    tq.train()
    tq.train()
    tq.train()
    tq.save_checkpoint(str(tmp_path))
    fresh = tqmix.QMIXConfig().environment(CoordGame).learners(
        device="cpu").debugging(seed=9).build()
    fresh.load_checkpoint(str(tmp_path))
    for tree in ("params", "target_params"):
        for a, b in zip(_named(getattr(fresh, tree)).values(),
                        _named(getattr(tq, tree)).values()):
            assert np.array_equal(a, b), tree
    assert fresh._iteration == 3 and \
        fresh._total_env_steps == tq._total_env_steps
    batch = tq.replay.sample(32)
    assert fresh.update(batch) == tq.update(batch)


def test_qmix_learns_coordination():
    from ray_tpu_torch.rllib import QMIXConfig

    cfg = (QMIXConfig()
           .environment(CoordGame)
           .training(lr=2e-3, train_batch_size=64,
                     target_network_update_freq=200,
                     num_env_steps_per_iter=64)
           .learners(device="cpu")
           .debugging(seed=3))
    cfg.epsilon = [(0, 1.0), (2500, 0.05)]
    cfg.num_steps_sampled_before_learning_starts = 128
    algo = cfg.build()
    best = -np.inf
    for i in range(90):
        r = algo.train()
        ret = r.get("episode_return_mean")
        if ret is not None:
            best = max(best, ret)
        if best >= 8.0:
            break
    algo.stop()
    # the safe equilibrium pays 4; >=8 requires coordinated action 2
    assert best >= 8.0, f"QMIX failed to coordinate: best={best}"


# ---------------------------------------------------------------- MADDPG

def test_maddpg_model_matches_jax():
    kw = dict(obs_dim=3, act_dim=2, n_agents=3, hidden=16, act_low=-2.0,
              act_high=1.0)
    jm, tm = jmaddpg.MADDPGModel(**kw), tmaddpg.MADDPGModel(**kw)
    jp = jm.init(jax.random.key(2))
    tp = to_port(jp)
    assert _named(tp).keys() == _named(jax.device_get(jp)).keys()
    assert tp["actor"][0]["w"].shape == (3, 3, 16)
    # the init draws the same layout and scales as JAX's: He-normal
    # weights, the actors' last layer at 0.01
    own = tm.init(torch.Generator().manual_seed(0))
    assert _named(own).keys() == _named(tp).keys()
    for name, w in _named(own).items():
        assert w.shape == _named(tp)[name].shape, name
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(7, 3, 3)).astype(np.float32)
    acts = tm.actions(tp, torch.from_numpy(obs))
    assert acts.shape == (7, 3, 2)
    assert _rel_max(acts, jm.actions(jp, obs)) < TOL
    state = obs.reshape(7, -1)
    joint = rng.uniform(-1, 1, (7, 6)).astype(np.float32)
    assert _rel_max(tm.q_values(tp, torch.from_numpy(state),
                                torch.from_numpy(joint)),
                    jm.q_values(jp, state, joint)) < TOL


def _maddpg_pair():
    def cfg(mod):
        c = (mod.MADDPGConfig().environment(CoopTargetEnv)
             .training(lr=2e-3, train_batch_size=64, gamma=0.9)
             .debugging(seed=1))
        c.hidden_dim = 32
        return c

    jm = cfg(jmaddpg).build()
    tm = cfg(tmaddpg).learners(device="cpu").build()
    jm.target_params = perturbed(jm.params, 6)
    load_tree(tm.params, to_port(jm.params))
    load_tree(tm.target_params, to_port(jm.target_params))
    return jm, tm


def test_maddpg_collection_and_update_match_jax():
    jm, tm = _maddpg_pair()
    for _ in range(3):
        assert jm._collect(96) == tm._collect(96) == 96
    _assert_replay_equal(tm, jm, exact=("dones",))
    assert np.allclose(tm._episode_returns, jm._episode_returns,
                       rtol=TOL, atol=TOL)
    batch = jm.replay.sample(64)
    init = jax.device_get(jm.params)
    init_t = jax.device_get(jm.target_params)
    for step in range(2):
        (jm.params, jm.target_params, jm.opt_actor, jm.opt_critic, cl,
         al) = jm._update_fn(jm.params, jm.target_params, jm.opt_actor,
                             jm.opt_critic, batch)
        got = tm.update(batch)
        assert _close(got["critic_loss"], float(cl)), step
        assert _close(got["actor_loss"], float(al)), step
    _update_close(tm.params, jax.device_get(jm.params), init)
    _update_close(tm.target_params, jax.device_get(jm.target_params),
                  init_t)


def test_maddpg_learns_coop_target():
    from ray_tpu_torch.rllib import MADDPGConfig

    config = (MADDPGConfig()
              .environment(env=CoopTargetEnv)
              .training(lr=2e-3, train_batch_size=128, gamma=0.9)
              .learners(device="cpu"))
    config.exploration_noise = 0.25
    config.num_env_steps_per_iter = 256
    config.num_steps_sampled_before_learning_starts = 256
    algo = config.build()
    try:
        best = -np.inf
        for _ in range(40):
            r = algo.train()
            v = r.get("episode_return_mean")
            if v is not None:
                best = max(best, v)
            if best >= -2.0:
                break
        # random play scores ~ -16 per 8-step episode; learned < -2
        assert best >= -2.0, best
    finally:
        algo.stop()


def test_maddpg_save_checkpoint_fails_in_both_packages(tmp_path):
    """The reference's fault, kept by the port: MADDPG bypasses
    ``Algorithm.__init__`` and has no checkpoint of its own, so
    ``Algorithm.save_checkpoint`` reads a ``learner_group`` it lacks."""
    jm, tm = _maddpg_pair()
    for algo in (jm, tm):
        with pytest.raises(AttributeError, match="learner_group"):
            algo.save_checkpoint(str(tmp_path))
