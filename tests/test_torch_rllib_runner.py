"""The port's env runner and learners against the JAX package's, in this
process, on the CPU.

jax's PRNG streams cannot be matched in torch, so the runners are compared
greedy (``explore=False``): the port's ``SingleAgentEnvRunner`` and the
JAX package's, built here on the same env creator, seed and weights (JAX's
module's, carried over with ``rl_params_from_jax``), must give the same
fragment of T=64 on CartPole-v1 with time limits of 6 and 40 steps, so
that truncations and terminations both fall inside it: obs, actions, dones, valid and the episodes
equal; rewards equal except at a truncation, where the runner folds
``gamma * V(final obs)`` into the reward; logp, vf, last_vf and those
rewards at 1e-5 of the largest entry. The same with a
``NormalizeObs``/``FrameStack`` pipeline, with the catalog's LSTM module
(its stateless forward) and with a recurrent module (the LSTM with a
greedy ``explore_action_recurrent``: the state carried across steps,
zeroed at an episode's start and returned as ``state_in``). Exploring, the
port's runner draws from its seeded generator: the same seed gives the
same fragment, and the actions' frequencies follow the policy's
probabilities.

The learners (A2C, IMPALA, APPO) against JAX's on the same batch and
params: the loss and its metrics, every grad, and one update's metrics and
params, at ``tests/test_torch_rllib_core.py``'s tolerances.
``PPO._postprocess`` (GAE per fragment, the autoreset rows dropped) gives
JAX's rows exactly."""

import os
import types

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import gymnasium as gym  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.rllib import connectors as jconn  # noqa: E402
from ray_tpu.rllib.algorithms.a2c.a2c import A2CLearner as JA2C  # noqa: E402
from ray_tpu.rllib.algorithms.appo.appo import (  # noqa: E402
    APPOLearner as JAPPO)
from ray_tpu.rllib.algorithms.impala.impala import (  # noqa: E402
    ImpalaLearner as JImpala)
from ray_tpu.rllib.algorithms.ppo.ppo import PPO as JPPO  # noqa: E402
from ray_tpu.rllib.algorithms.ppo.ppo import (  # noqa: E402
    PPOConfig as JPPOConfig)
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu.rllib.env.env_runner import (  # noqa: E402
    SingleAgentEnvRunner as JRunner)
from ray_tpu.rllib.models import catalog as jcat  # noqa: E402
from ray_tpu_torch._private.tree import tree_map  # noqa: E402
from ray_tpu_torch.rllib import connectors as tconn  # noqa: E402
from ray_tpu_torch.rllib.algorithms.a2c.a2c import A2CLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.appo.appo import (  # noqa: E402
    APPOLearner)
from ray_tpu_torch.rllib.algorithms.impala.impala import (  # noqa: E402
    ImpalaLearner)
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPO, PPOConfig  # noqa
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402
from ray_tpu_torch.rllib.env.env_runner import (  # noqa: E402
    SingleAgentEnvRunner)
from ray_tpu_torch.rllib.models import catalog as tcat  # noqa: E402
from tests.test_torch_rllib_core import (  # noqa: E402
    TOL, _assert_tree_close, _close, _rel_max, _update_close)
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

T, E = 64, 4
# the envs' time limits, by index: episodes end by them and by falling
MAX_STEPS = (6, 40)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cartpole():
    """An env creator whose i-th env has the time limit MAX_STEPS[i % 2]."""
    made = []

    def creator():
        made.append(None)
        return gym.make("CartPole-v1",
                        max_episode_steps=MAX_STEPS[len(made) % 2 - 1])
    return creator


# ------------------------------------------------- the greedy runner vs JAX

class _JRecurrentLSTM(jcat.LSTMModule):
    """The catalog's LSTM with a greedy recurrent action (one step of
    ``forward_recurrent``)."""

    def explore_action_recurrent(self, params, obs, state, rng):
        out, state = self.forward_recurrent(params, obs[None], state)
        logits = out["logits"][0]
        action = jnp.argmax(logits, axis=-1)
        return action, self.dist.logp(logits, action), out["vf"][0], state


class _TRecurrentLSTM(tcat.LSTMModule):
    def explore_action_recurrent(self, params, obs, state, generator):
        out, state = self.forward_recurrent(params, obs[None], state)
        logits = out["logits"][0]
        action = torch.argmax(logits, dim=-1)
        return action, self.dist.logp(logits, action), out["vf"][0], state


class _Spec:
    """An RLModuleSpec whose ``build`` makes ``cls``."""

    def __init__(self, spec, cls):
        self.spec, self.cls = spec, cls
        self.discrete = spec.discrete

    def build(self):
        return self.cls(self.spec)


CASES = {
    "mlp": dict(spec=dict(obs_dim=4, action_dim=2)),
    "connectors": dict(spec=dict(obs_dim=8, action_dim=2),
                       connector=True),
    "lstm": dict(spec=dict(obs_dim=4, action_dim=2, use_lstm=True,
                           lstm_cell_size=16, hiddens=(32,))),
    "recurrent": dict(spec=dict(obs_dim=4, action_dim=2, use_lstm=True,
                                lstm_cell_size=16, hiddens=(32,)),
                      recurrent=True),
}


def _runners(case, seed=1, weight_key=7):
    spec_kw = CASES[case]["spec"]
    jspec, tspec = jrm.RLModuleSpec(**spec_kw), trm.RLModuleSpec(**spec_kw)
    if CASES[case].get("recurrent"):
        jspec, tspec = (_Spec(jspec, _JRecurrentLSTM),
                        _Spec(tspec, _TRecurrentLSTM))
    jw = jax.device_get(jspec.build().init(jax.random.key(weight_key)))
    # a decided policy (the init's last policy layer is scaled by 0.01,
    # near-uniform): no argmax tie for the two packages' last digits
    jw["pi"][-1]["w"] = jw["pi"][-1]["w"] * 100.0
    conn = {}
    if CASES[case].get("connector"):
        conn = dict(
            j=jconn.ConnectorPipeline([jconn.NormalizeObs(),
                                       jconn.FrameStack(k=2)]),
            t=tconn.ConnectorPipeline([tconn.NormalizeObs(),
                                       tconn.FrameStack(k=2)]))
    jr = JRunner(_cartpole(), E, T, jspec, seed=seed, explore=False,
                 gamma=0.97, connector=conn.get("j"))
    tr = SingleAgentEnvRunner(_cartpole(), E, T, tspec, seed=seed,
                              explore=False, gamma=0.97,
                              connector=conn.get("t"))
    return (jr, jw), (tr, trm.rl_params_from_jax(jw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_runner_matches_jax(case):
    (jr, jw), (tr, tw) = _runners(case)
    try:
        assert tr._recurrent == jr._recurrent == (case == "recurrent")
        ends = {"truncated": 0, "terminated": 0}
        for frag in range(2):  # the second starts mid-episode
            want, got = jr.sample(jw), tr.sample(tw)
            assert set(got) == set(want), (set(got) ^ set(want))
            for i, ep in enumerate(want["episodes"]):
                assert ep == got["episodes"][i]
                assert ep["episode_len"] <= max(MAX_STEPS)
            for k in ("obs", "actions", "dones", "valid"):
                assert got[k].shape == want[k].shape, k
                assert np.array_equal(got[k], np.asarray(want[k])), k
            # CartPole pays 1 a live step (0 at an autoreset): any other
            # reward is a truncation's, with gamma * V(final obs) folded in
            trunc = want["valid"] & (want["rewards"] != 1.0)
            ends["truncated"] += int(trunc.sum())
            ends["terminated"] += int(want["dones"].sum() - trunc.sum())
            np.testing.assert_array_equal(got["rewards"][~trunc],
                                          want["rewards"][~trunc])
            for k in ("logp", "vf", "last_vf", "rewards"):
                assert _rel_max(got[k], want[k]) < TOL, k
            if case == "recurrent":
                for g, w in zip(got["state_in"], want["state_in"]):
                    assert g.shape == w.shape
                    assert np.abs(g - w).max() < TOL * max(
                        np.abs(w).max(), 1.0)
            assert got["env_steps"] == want["env_steps"] == T * E
        assert ends["truncated"] > 0 and ends["terminated"] > 0, ends
    finally:
        jr.stop()
        tr.stop()


# ----------------------------------------------------------------- explore

class ConstEnv:
    """One fixed observation, 3 actions, no reward, no end: every step's
    action is a draw from the same probabilities."""

    OBS = np.array([0.3, -1.2, 0.7], np.float32)

    def __init__(self):
        self.observation_space = types.SimpleNamespace(shape=(3,),
                                                       dtype=np.float32)
        self.action_space = types.SimpleNamespace(n=3)

    def reset(self, *, seed=None, options=None):
        return self.OBS.copy(), {}

    def step(self, action):
        assert action in (0, 1, 2)
        return self.OBS.copy(), 0.0, False, False, {}


def test_exploring_runner_follows_its_generator_and_the_probabilities():
    spec = trm.RLModuleSpec(obs_dim=3, action_dim=3)
    module = spec.build()
    w = module.init(torch.Generator().manual_seed(0))
    w["pi"][-1]["w"] = w["pi"][-1]["w"] * 100.0
    frags = [SingleAgentEnvRunner(ConstEnv, 32, 64, spec, seed=5)
             .sample(w) for _ in range(2)]
    assert np.array_equal(frags[0]["actions"], frags[1]["actions"])
    other = SingleAgentEnvRunner(ConstEnv, 32, 64, spec, seed=6).sample(w)
    assert not np.array_equal(frags[0]["actions"], other["actions"])
    with torch.no_grad():
        logits = module.forward(w, torch.from_numpy(ConstEnv.OBS))["logits"]
    probs = torch.softmax(logits, -1).numpy()
    assert probs.min() > 0.05  # every action drawn often enough to count
    freq = np.bincount(frags[0]["actions"].ravel(), minlength=3) / (32 * 64)
    np.testing.assert_allclose(freq, probs, atol=0.03)
    np.testing.assert_allclose(frags[0]["logp"],
                               np.log(probs)[frags[0]["actions"]],
                               rtol=1e-5)


# ---------------------------------------------------------------- learners

SPEC = dict(obs_dim=6, action_dim=3)
CONFIG = {"lr": 1e-3, "num_epochs": 1, "seed": 0, "gamma": 0.97,
          "clip_param": 0.2, "entropy_coeff": 0.01}


def _rows(B, seed):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(B, 6)).astype(np.float32),
            "actions": rng.integers(0, 3, B).astype(np.int32),
            "logp": np.full(B, -1.1, np.float32),
            "advantages": rng.normal(size=B).astype(np.float32),
            "value_targets": rng.normal(size=B).astype(np.float32)}


def _fragments(B, Tf, seed):
    """A batch-major (B, T) batch as IMPALA's ``_to_batch`` builds it, with
    episode ends, autoreset rows and behaviour logps off the policy."""
    rng = np.random.default_rng(seed)
    valid = rng.random((B, Tf)) > 0.1
    return {"obs": rng.normal(size=(B, Tf, 6)).astype(np.float32),
            "actions": rng.integers(0, 3, (B, Tf)).astype(np.int32),
            "logp": rng.uniform(-2.5, -0.2, (B, Tf)).astype(np.float32),
            "rewards": rng.normal(size=(B, Tf)).astype(np.float32),
            "dones": (rng.random((B, Tf)) < 0.1).astype(np.float32),
            "valid": valid.astype(np.float32),
            "bootstrap": rng.normal(size=B).astype(np.float32)}


LEARNERS = {
    "a2c": (JA2C, A2CLearner, lambda: _rows(48, 1)),
    "impala": (JImpala, ImpalaLearner, lambda: _fragments(4, 16, 2)),
    "appo": (JAPPO, APPOLearner, lambda: _fragments(4, 16, 3)),
}


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_learner_matches_jax(name):
    jcls, tcls, make = LEARNERS[name]
    jl = jcls(jrm.RLModuleSpec(**SPEC), dict(CONFIG), use_mesh=False)
    tl = tcls(trm.RLModuleSpec(**SPEC), dict(CONFIG), device="cpu")
    tl.set_weights(trm.rl_params_from_jax(jax.device_get(jl.params)))
    batch = make()
    jb = jax.tree.map(jnp.asarray, batch)
    (loss, metrics), grads = jax.value_and_grad(jl.loss, has_aux=True)(
        jl.params, jb)
    tloss, tmetrics = tl.loss(tl.params, tl._batch(batch))
    assert abs(tloss.item() - float(loss)) <= TOL * abs(float(loss))
    assert tmetrics.keys() == metrics.keys()
    for k, v in metrics.items():
        assert _close(tmetrics[k].item(), float(v)), k
    tl.compute_grads(tl._batch(batch))
    _assert_tree_close(tree_map(lambda p: p.grad, tl.params),
                       jax.device_get(grads))
    init = jax.device_get(jl.params)
    want, got = jl.update(batch), tl.update(batch)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert _close(got[k], v), k
    _update_close(tl.get_weights(), jax.device_get(jl.params), init)


def _samples(seed):
    rng = np.random.default_rng(seed)
    out = []
    for Tf, Ef in ((16, 3), (8, 2)):
        valid = rng.random((Tf, Ef)) > 0.2
        out.append({"obs": rng.normal(size=(Tf, Ef, 5)).astype(np.float32),
                    "actions": rng.integers(0, 2, (Tf, Ef)),
                    "logp": rng.normal(size=(Tf, Ef)).astype(np.float32),
                    "vf": rng.normal(size=(Tf, Ef)).astype(np.float32),
                    "rewards": rng.normal(size=(Tf, Ef)).astype(np.float32),
                    "dones": (rng.random((Tf, Ef)) < 0.2).astype(
                        np.float32),
                    "valid": valid,
                    "last_vf": rng.normal(size=Ef).astype(np.float32)})
    return out


def test_ppo_postprocess_matches_jax():
    samples = _samples(7)
    tcfg = PPOConfig().training(gamma=0.95, lambda_=0.9)
    jcfg = JPPOConfig().training(gamma=0.95, lambda_=0.9)
    got = PPO._postprocess(types.SimpleNamespace(config=tcfg), samples)
    want = JPPO._postprocess(types.SimpleNamespace(config=jcfg), samples)
    assert got.keys() == want.keys()
    n = sum(int(s["valid"].sum()) for s in samples)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and len(got[k]) == n, k
        assert np.array_equal(got[k], v), k
