"""The port's ES, ARS and contextual bandits against the JAX package's, on
the CPU: ES's ravel order against ``jax.flatten_util.ravel_pytree``, one
``training_step`` of ES and of ARS from the same theta, seed and fitness
(theta after the step, and ARS's observation filter and its Chan merge),
LinUCB's choices, ``A`` and ``b`` over the same context stream, LinTS's
with JAX's own normal draws, and ES's and ARS's checkpoint round trips;
and the reference's ``test_es_mechanics`` (``tests/test_rllib_algos.py``),
``test_ars_learns_chain`` (``tests/test_rllib_breadth.py``) and
``test_bandits_approach_oracle`` (``tests/test_rllib_maddpg_bandit.py``)
with their configs and thresholds unchanged, the bandits' state on
``device="cpu"``.

A candidate's fitness in the step tests is a fixed function of its
weights (a weighted sum of every leaf, by name), computed by stand-in
runners: ``put`` and ``get`` of both runtimes are replaced for the test
by an in-process table, so no cluster is booted for them. The mechanics
and learning cases run on one port cluster, ``init(num_cpus=4)``.
Tolerances: theta, the filter, ``A`` and ``b`` 1e-5 relative; the ravel
order and the bandits' choices exact."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import itertools  # noqa: E402

import gymnasium as gym  # noqa: E402
import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.algorithms.ars import ars as jars  # noqa: E402
from ray_tpu.rllib.algorithms.bandit import bandit as jbandit  # noqa: E402
from ray_tpu.rllib.algorithms.es import es as jes  # noqa: E402
from ray_tpu.rllib.core.rl_module import (  # noqa: E402
    RLModuleSpec as JSpec)
from ray_tpu_torch.rllib.algorithms.ars import ars as tars  # noqa: E402
from ray_tpu_torch.rllib.algorithms.bandit import (  # noqa: E402
    bandit as tbandit)
from ray_tpu_torch.rllib.algorithms.es import es as tes  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import (  # noqa: E402
    RLModuleSpec, rl_params_from_jax)
from tests.test_torch_rllib_core import TOL, _named, _rel_max  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402

SPEC = dict(obs_dim=4, action_dim=2, hiddens=(8, 8))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ stand-in runners

class _Remote:
    def __init__(self, fn):
        self.remote = fn


class _Runtime:
    """``put`` / ``get`` over an in-process table, for one runtime."""

    def __init__(self):
        self._table = {}
        self._ids = itertools.count()

    def put(self, value):
        ref = next(self._ids)
        self._table[ref] = value
        return ref

    def get(self, ref, timeout=None):
        return self._table.pop(ref)


class _FakeRunner:
    """Evaluates a candidate with a fixed function of its weights: the
    fitness is a weighted sum of the inner policy's leaves, by name; the
    fragment's observations are a fixed pattern scaled by it."""

    def __init__(self, runtime, coef, obs_dim):
        self._rt = runtime
        self._coef = coef
        self._obs = np.random.default_rng(11).normal(
            size=(3, 2, obs_dim)).astype(np.float32)
        self.sample = _Remote(self._sample)

    def _sample(self, w_ref):
        weights = self._rt.get(w_ref)
        inner = weights["inner"] if "filter" in weights else weights
        fit = sum(float(np.sum(np.asarray(v, np.float64) * self._coef[k]))
                  for k, v in sorted(_named(inner).items()))
        return self._rt.put({
            "episodes": [{"episode_return": fit}], "env_steps": 6,
            "rewards": np.zeros((3, 2), np.float32),
            "obs": self._obs * np.float32(1.0 + 0.1 * fit)})


def _stand_in(monkeypatch, algo, runtime_mod, coef, obs_dim, n_runners=2):
    rt = _Runtime()
    monkeypatch.setattr(runtime_mod, "put", rt.put)
    monkeypatch.setattr(runtime_mod, "get", rt.get)
    algo.env_runners = [_FakeRunner(rt, coef, obs_dim)
                        for _ in range(n_runners)]
    algo._total_env_steps = 0
    algo._episode_returns = []


def _jax_params(seed=0):
    return JSpec(**SPEC).build().init(jax.random.key(seed))


def test_ravel_order_matches_ravel_pytree():
    jp = _jax_params()
    jflat, junravel = jax.flatten_util.ravel_pytree(jp)
    flat, unravel = tes.ravel_params(rl_params_from_jax(
        jax.device_get(jp)))
    assert flat.dtype == np.float32
    assert np.array_equal(flat, np.asarray(jflat))
    vec = np.random.default_rng(0).normal(size=flat.shape).astype(
        np.float32)
    got, want = _named(unravel(vec)), _named(jax.device_get(junravel(vec)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.array_equal(got[k], w), k


def _es_pair(monkeypatch, jcls, tcls, jcfg, tcfg, with_filter):
    """A JAX and a port algorithm of one family, set up as ``setup`` sets
    them up but with stand-in runners, from the same theta."""
    jp = _jax_params(3)
    rng = np.random.default_rng(4)
    coef = {k: rng.normal(size=np.shape(v))
            for k, v in sorted(_named(jax.device_get(jp)).items())}
    pair = []
    for cls, cfg, mod, params in (
            (jcls, jcfg, ray_tpu, jp),
            (tcls, tcfg, ray_tpu_torch,
             rl_params_from_jax(jax.device_get(jp)))):
        algo = object.__new__(cls)
        algo.config = algo._algo_config = cfg
        if cls.__module__.startswith("ray_tpu_torch"):
            algo._theta, algo._unravel = tes.ravel_params(params)
        else:
            flat, algo._unravel = jax.flatten_util.ravel_pytree(params)
            algo._theta = np.asarray(flat, np.float32)
        algo._np_rng = np.random.default_rng(cfg.seed)
        if with_filter:
            algo._filter = {"mu": np.zeros(SPEC["obs_dim"], np.float32),
                            "var": np.ones(SPEC["obs_dim"], np.float32)}
            algo._filter_count = 0
        _stand_in(monkeypatch, algo, mod, coef, SPEC["obs_dim"])
        pair.append(algo)
    return pair


def test_es_training_step_matches_jax(monkeypatch):
    def cfg(mod):
        return mod.ESConfig().training(pop_size=6, noise_stdev=0.1,
                                       step_size=0.05).debugging(seed=5)

    ja, ta = _es_pair(monkeypatch, jes.ES, tes.ES, cfg(jes), cfg(tes),
                      False)
    for _ in range(2):
        want, got = ja.training_step(), ta.training_step()
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert abs(got[k] - w) <= TOL * max(abs(w), 1.0), k
        assert _rel_max(ta._theta, ja._theta) <= TOL
    assert ta._total_env_steps == ja._total_env_steps == 2 * 12 * 6
    assert ta._episode_returns == pytest.approx(ja._episode_returns,
                                                rel=TOL)


def test_ars_training_step_and_filter_match_jax(monkeypatch):
    def cfg(mod):
        return mod.ARSConfig().training(
            pop_size=6, top_directions=3, noise_stdev=0.2,
            step_size=0.1).debugging(seed=7)

    ja, ta = _es_pair(monkeypatch, jars.ARS, tars.ARS, cfg(jars),
                      cfg(tars), True)
    for _ in range(3):
        want, got = ja.training_step(), ta.training_step()
        for k, w in want.items():
            assert abs(got[k] - w) <= TOL * max(abs(w), 1.0), k
        assert _rel_max(ta._theta, ja._theta) <= TOL
        for k in ("mu", "var"):
            assert _rel_max(ta._filter[k], ja._filter[k]) <= TOL, k
        assert ta._filter_count == ja._filter_count
    # every observation the candidates returned: 3 steps of 12 candidates
    # of 6 rows
    assert ta._filter_count == 3 * 12 * 6
    # the port's whitening module reads the filter from the weights
    w = ta.get_weights()
    obs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(5, SPEC["obs_dim"])).astype(np.float32))
    mod = tars.ARSModuleSpec(inner=RLModuleSpec(**SPEC)).build()
    jmod = jars.ARSModuleSpec(inner=JSpec(**SPEC)).build()
    assert _rel_max(mod.forward(w, obs)["logits"],
                    jmod.forward(jax.device_get(ja.get_weights()),
                                 obs.numpy())["logits"]) <= TOL


def test_ars_filter_is_chans_merge():
    algo = object.__new__(tars.ARS)
    algo._algo_config = tars.ARSConfig()
    algo._filter = {"mu": np.zeros(3, np.float32),
                    "var": np.ones(3, np.float32)}
    algo._filter_count = 0
    rng = np.random.default_rng(0)
    batches = [rng.normal(2.0, 3.0, size=(n, 2, 3)).astype(np.float32)
               for n in (4, 7, 1)]
    for b in batches:
        algo._update_filter([b[:, :1], b[:, 1:]])
    flat = np.concatenate([b.reshape(-1, 3) for b in batches])
    assert algo._filter_count == len(flat)
    assert _rel_max(algo._filter["mu"], flat.mean(0)) <= TOL
    assert _rel_max(algo._filter["var"], flat.var(0)) <= TOL


def test_es_and_ars_checkpoint_round_trip(tmp_path):
    for cls, cfg in ((tes.ES, tes.ESConfig()), (tars.ARS, tars.ARSConfig())):
        algo = object.__new__(cls)
        algo._algo_config = algo.config = cfg
        algo._theta = np.arange(7, dtype=np.float32)
        algo._episode_returns = [1.0, 2.5]
        algo._total_env_steps = 12
        algo._filter = {"mu": np.ones(3, np.float32),
                        "var": np.full(3, 2.0, np.float32)}
        algo._filter_count = 5
        d = tmp_path / cls.__name__
        d.mkdir()
        algo.save_checkpoint(str(d))
        fresh = object.__new__(cls)
        fresh._algo_config = fresh.config = cfg
        fresh.load_checkpoint(str(d))
        assert np.array_equal(fresh._theta, algo._theta)
        assert fresh._episode_returns == algo._episode_returns
        assert fresh._total_env_steps == 12
        if cls is tars.ARS:
            assert fresh._filter_count == 5
            assert all(np.array_equal(fresh._filter[k], algo._filter[k])
                       for k in ("mu", "var"))


# --------------------------------------------------------------- bandits

class ContextBanditEnv(gym.Env):
    """5-arm contextual bandit: reward = ctxᵀθ_arm + noise; one-step
    episodes (the reference's bandit env contract). Best-arm mean payoff
    ≈ 0.62; uniform play ≈ 0."""

    def __init__(self, config=None):
        self.observation_space = gym.spaces.Box(-1, 1, (4,), np.float32)
        self.action_space = gym.spaces.Discrete(5)
        rng = np.random.default_rng(7)
        self._thetas = rng.normal(0, 0.5, (5, 4))
        self._rng = np.random.default_rng(0)
        self._ctx = np.zeros(4, np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = self._rng.uniform(-1, 1, 4).astype(np.float32)
        return self._ctx, {}

    def step(self, action):
        mean = float(self._thetas[int(action)] @ self._ctx)
        reward = mean + float(self._rng.normal(0, 0.05))
        return self._ctx, reward, True, False, {}

    def oracle_mean(self, n=2000):
        rng = np.random.default_rng(1)
        ctxs = rng.uniform(-1, 1, (n, 4))
        return float(np.max(ctxs @ self._thetas.T, axis=1).mean())


def _record_arms(algo):
    """Wrap the algorithm's env to keep the arm of every pull."""
    arms, step = [], algo._env.step

    def recorded(action):
        arms.append(int(action))
        return step(action)

    algo._env.step = recorded
    return arms


@pytest.mark.parametrize("kind", ["LinUCB", "LinTS"])
def test_bandit_choices_and_state_match_jax(kind):
    name = "BanditLinUCBConfig" if kind == "LinUCB" else "BanditLinTSConfig"
    jcfg = getattr(jbandit, name)().environment(env=ContextBanditEnv)
    tcfg = getattr(tbandit, name)().environment(
        env=ContextBanditEnv).learners(device="cpu")
    ja, ta = jcfg.build(), tcfg.build()
    assert ta.state.A.dtype == ta.state.b.dtype == torch.float32
    if kind == "LinTS":
        # the port draws the same standard normals JAX's _choose draws:
        # one split of the algorithm's key a pull
        key = jax.random.key(tcfg.seed)

        def jax_draws():
            nonlocal key
            key, sub = jax.random.split(key)
            return torch.from_numpy(np.array(jax.random.normal(
                sub, (ta.n_arms, ta.dim))))

        ta._draws = jax_draws
    jarms, tarms = _record_arms(ja), _record_arms(ta)
    for _ in range(2):
        want, got = ja.train(), ta.train()
        assert got["episode_return_mean"] == pytest.approx(
            want["episode_return_mean"], rel=TOL)
    assert tarms == jarms and len(tarms) == 128
    assert len(set(tarms)) > 1
    assert _rel_max(ta.state.A, ja.state.A) <= TOL
    assert _rel_max(ta.state.b, ja.state.b) <= TOL
    ja.stop()
    ta.stop()


@pytest.mark.parametrize("algo_name", ["LinUCB", "LinTS"])
def test_bandits_approach_oracle(algo_name):
    from ray_tpu_torch.rllib import BanditLinTSConfig, BanditLinUCBConfig

    cfg_cls = BanditLinUCBConfig if algo_name == "LinUCB" \
        else BanditLinTSConfig
    config = cfg_cls().environment(env=ContextBanditEnv).learners(
        device="cpu")
    config.num_env_steps_per_iter = 200
    algo = config.build()
    try:
        for _ in range(5):
            r = algo.train()
        oracle = ContextBanditEnv().oracle_mean()
        # after 1000 pulls the policy earns >= 70% of oracle payoff
        assert r["episode_return_mean"] >= 0.7 * oracle, \
            (r["episode_return_mean"], oracle)
    finally:
        algo.stop()


# ------------------------------------------------- mechanics and learning

@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_es_mechanics(port_cluster):
    """Small smoke: the ES loop must evaluate 2*pop_size candidates,
    count their env steps, and move theta."""
    from ray_tpu_torch.rllib import ESConfig

    cfg = (ESConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=1,
                        rollout_fragment_length=50)
           .training(pop_size=2, noise_stdev=0.1, step_size=0.05))
    algo = cfg.build()
    try:
        theta0 = algo._theta.copy()
        r = algo.step()
        assert np.isfinite(r["fitness_mean"])
        assert r["fitness_max"] >= r["fitness_mean"]
        assert r["env_steps_this_iter"] == 2 * 2 * 50
        assert r["theta_norm"] > 0
        assert np.linalg.norm(algo._theta - theta0) > 0
        assert algo.compute_single_action(np.zeros(4, np.float32)) in (0, 1)
    finally:
        algo.stop()


def test_ars_learns_chain(port_cluster):
    from ray_tpu_torch.rllib import ARSConfig
    from tests.test_torch_rllib_learning import _chain_env, _run_until

    cfg = (ARSConfig()
           .environment(_chain_env())
           .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                        rollout_fragment_length=48)
           .training(pop_size=8, top_directions=4, noise_stdev=0.5,
                     step_size=0.3))
    algo = cfg.build()
    try:
        best, iters = _run_until(algo, 0.5, 25)
        assert best >= 0.5, f"ARS failed to learn ChainEnv: best={best}"
        # the observation filter really is accumulating state statistics
        assert algo._filter_count > 0
        assert float(algo._filter["var"].max()) != 1.0
    finally:
        algo.stop()
