"""The port's off-policy learners (DQN, SAC, DDPG, TD3 and CQL) against the
JAX package's, on the CPU, and the reference's mechanics cases of DQN, SAC
and DDPG/TD3 on the port's runtime.

Weights go from JAX to the port through ``rl_params_from_jax``, target
networks too (perturbed first, so that a target differs from the online
net); batches are drawn with numpy from a seed. A loss's random draws are
JAX's: the test splits the JAX learner's key as its update does, draws the
standard-normal and uniform arrays JAX's loss draws from those keys, and
feeds them to the port's loss as ``draws``. Tolerances are
``tests/test_torch_rllib_core.py``'s: losses and metrics 1e-5 relative (to
the value, or to 0.1 where it is smaller), grads 1e-5 of each leaf's
largest entry (or of 1e-2), and after an update each leaf's distance from
JAX's within 1e-3 of its update's norm.

DDPG's losses are closures of the JAX learner's jitted update; the test
reads them from the jitted function's closure to take their grads.

``tests/test_rllib.py``'s DQN mechanics and checkpoint case keeps the
reference's config and checks, with the learner on ``device="cpu"``, on
one port cluster, ``init(num_cpus=4)``; the SAC and DDPG/TD3 mechanics are
in ``tests/test_torch_rllib_offpolicy_learning.py``."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.algorithms.cql.cql import CQLLearner as JCQL  # noqa: E402
from ray_tpu.rllib.algorithms.ddpg import ddpg as jddpg  # noqa: E402
from ray_tpu.rllib.algorithms.dqn import dqn as jdqn  # noqa: E402
from ray_tpu.rllib.algorithms.sac import sac as jsac  # noqa: E402
from ray_tpu_torch._private.tree import tree_leaves, tree_map  # noqa: E402
from ray_tpu_torch.rllib.algorithms.cql.cql import CQLLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.ddpg import ddpg as tddpg  # noqa: E402
from ray_tpu_torch.rllib.algorithms.dqn import dqn as tdqn  # noqa: E402
from ray_tpu_torch.rllib.algorithms.sac import sac as tsac  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import rl_params_from_jax  # noqa: E402
from tests.test_torch_rllib_core import (  # noqa: E402
    TOL, _assert_tree_close, _close, _named, _rel_max, _update_close)
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402

B = 32
OBS, ACT = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- helpers

def to_port(tree):
    """A JAX tree as the port's CPU tensors."""
    return rl_params_from_jax(jax.device_get(tree))


def perturbed(tree, seed):
    """A JAX tree with every leaf moved by 0.05 standard normals."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda t: t + jnp.asarray(
        0.05 * rng.normal(size=np.shape(t)), jnp.float32), tree)


def port_grads(params):
    """The port's grads as {name: numpy} (zeros where a leaf has none)."""
    return _named(tree_map(lambda p: p.grad if p.grad is not None
                           else torch.zeros_like(p), params))


def _grads_close(got, want):
    want = _named(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert _rel_max(got[name], w, 1e-2) <= TOL, name


def _metrics_close(got, want):
    for k, w in want.items():
        g = got[k].item() if isinstance(got[k], torch.Tensor) else got[k]
        assert _close(g, float(w)), (k, g, w)


def _transitions(seed, discrete):
    rng = np.random.default_rng(seed)
    if discrete:
        actions = rng.integers(0, ACT, B).astype(np.int64)
    else:
        actions = rng.uniform(-0.9, 0.9, (B, ACT)).astype(np.float32)
    return {
        "obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "actions": actions,
        "rewards": rng.normal(size=B).astype(np.float32),
        "next_obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "dones": (rng.random(B) < 0.2).astype(np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _closure(jitted, name):
    fn = jitted.__wrapped__
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))[name]


# ------------------------------------------------------------------ DQN

def _dqn_pair(config, seed=0):
    spec = dict(obs_dim=OBS, action_dim=ACT, hiddens=(16, 16))
    jl = jdqn.DQNLearner(jdqn.DQNModuleSpec(**spec), dict(config))
    jl.params["epsilon"] = jnp.asarray(0.3, jnp.float32)
    jl.target_params = perturbed(jl.params, seed + 1)
    tl = tdqn.DQNLearner(tdqn.DQNModuleSpec(**spec), dict(config),
                         device="cpu")
    tl.set_weights(to_port(jl.params))
    tdqn.load_tree(tl.target_params, to_port(jl.target_params))
    return jl, tl


@pytest.mark.parametrize("dueling", [True, False])
def test_dqn_module_matches_jax(dueling):
    spec = dict(obs_dim=OBS, action_dim=4, hiddens=(16, 16),
                dueling=dueling)
    jm, tm = jdqn.DQNModuleSpec(**spec).build(), \
        tdqn.DQNModuleSpec(**spec).build()
    jp = jm.init(jax.random.key(3))
    tp = to_port(jp)
    obs = np.random.default_rng(0).normal(size=(B, OBS)).astype(np.float32)
    want, got = jm.forward(jp, obs), tm.forward(tp, torch.from_numpy(obs))
    for k in ("logits", "vf"):
        assert _rel_max(got[k], want[k]) < TOL, k
    assert float(tp["epsilon"]) == 1.0
    # epsilon 0: the exploring action is the greedy one
    tp["epsilon"] = torch.tensor(0.0)
    a, logp, vf = tm.explore_action(tp, torch.from_numpy(obs),
                                    torch.Generator().manual_seed(0))
    assert np.array_equal(a.numpy(), np.argmax(np.asarray(want["logits"]),
                                               -1))
    assert not logp.any() and not vf.any()
    # epsilon 1: uniform over the actions, from the generator
    tp["epsilon"] = torch.tensor(1.0)
    big = torch.from_numpy(np.repeat(obs, 64, axis=0))
    a1, _, _ = tm.explore_action(tp, big, torch.Generator().manual_seed(5))
    a2, _, _ = tm.explore_action(tp, big, torch.Generator().manual_seed(5))
    assert torch.equal(a1, a2)
    assert set(np.bincount(a1.numpy(), minlength=4) > 300) == {True}


@pytest.mark.parametrize("weighted", [False, True])
def test_dqn_learner_matches_jax(weighted):
    config = {"lr": 1e-3, "seed": 0, "gamma": 0.97}
    jl, tl = _dqn_pair(config)
    batch = _transitions(1, discrete=True)
    if weighted:
        batch["weights"] = np.random.default_rng(2).uniform(
            0.2, 1.0, B).astype(np.float32)
    jbatch = dict(batch, target_params=jl.target_params)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jl.loss, has_aux=True))(jl.params, jbatch)
    loss, metrics = tl.loss(tl.params, tl._batch(batch))
    loss.backward()
    assert _close(loss.item(), float(jloss))
    for k in ("td_error_mean", "qf_mean"):
        assert _close(metrics[k].item(), float(jm[k])), k
    assert _rel_max(metrics["td_error"].detach(), jm["td_error"]) < TOL
    grads = port_grads(tl.params)
    _grads_close(grads, jgrads)
    assert not grads["epsilon"].any()

    init = jax.device_get(jl.params)
    want = jl.update(dict(batch, batch_indexes=np.arange(B)))
    got = tl.update(dict(batch, batch_indexes=np.arange(B)))
    assert np.array_equal(got["_batch_indexes"], np.arange(B))
    assert _rel_max(got.pop("_td_error"), want.pop("_td_error")) < TOL
    for k in ("td_error_mean", "qf_mean", "total_loss"):
        assert _close(got[k], want[k]), k
    _update_close(tl.get_weights(), jax.device_get(jl.params), init)
    assert tl.params["epsilon"].item() == pytest.approx(0.3)


def test_dqn_target_sync_epsilon_and_state_match_jax():
    jl, tl = _dqn_pair({"lr": 1e-3, "seed": 0})
    for tau in (0.3, 1.0):
        jl.sync_target(tau)
        tl.sync_target(tau)
        _assert_tree_close(tl.target_params, jax.device_get(
            jl.target_params), floor=1e-30)
    jl.set_epsilon(0.125)
    tl.set_epsilon(0.125)
    assert float(tl.get_weights()["epsilon"]) == 0.125
    # the state round trip carries the target net and Adam's moments
    tl.update(_transitions(4, discrete=True))
    state = tl.get_state()
    other = tdqn.DQNLearner(tl.module.spec, dict(tl.config), device="cpu")
    other.set_state(state)
    for a, b in zip(tree_leaves(other.get_state()["target_params"]),
                    tree_leaves(state["target_params"])):
        assert torch.equal(a, b)
    batch = _transitions(5, discrete=True)
    assert tl.update(batch)["total_loss"] == other.update(batch)[
        "total_loss"]
    for a, b in zip(tree_leaves(tl.params), tree_leaves(other.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------- SAC and CQL

SAC_SPEC = dict(obs_dim=OBS, action_dim=ACT, hiddens=(16, 16))


def _sac_pair(jcls, tcls, config):
    jl = jcls(jsac.SACModuleSpec(**SAC_SPEC), dict(config))
    jl.params["log_alpha"] = jnp.asarray(-0.4, jnp.float32)
    jl.target_params = perturbed(jl.target_params, 7)
    tl = tcls(tsac.SACModuleSpec(**SAC_SPEC), dict(config), device="cpu")
    tl.set_weights(to_port(jl.params))
    tdqn.load_tree(tl.target_params, to_port(jl.target_params))
    return jl, tl


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape))


def _sac_draws(k1, k2):
    return {"next": _normal(k1, (B, ACT)), "pi": _normal(k2, (B, ACT))}


def _cql_draws(k1, k2, n):
    """JAX's CQL draws from the update's (k1, k2): SAC's from (k_sac, k2),
    the uniform proposals from kr, the policy's from kp and kn split n
    ways."""
    k_sac, kr, kp, kn = jax.random.split(k1, 4)
    return dict(_sac_draws(k_sac, k2),
                rand=np.array(jax.random.uniform(
                    kr, (n, B, ACT), minval=-1.0, maxval=1.0)),
                pi_n=np.stack([_normal(k, (B, ACT))
                               for k in jax.random.split(kp, n)]),
                next_n=np.stack([_normal(k, (B, ACT))
                                 for k in jax.random.split(kn, n)]))


def test_sac_module_matches_jax():
    jm = jsac.SACModuleSpec(**SAC_SPEC).build()
    tm = tsac.SACModuleSpec(**SAC_SPEC).build()
    jp = perturbed(jm.init(jax.random.key(2)), 3)
    tp = to_port(jp)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(B, OBS)).astype(np.float32)
    actions = rng.uniform(-0.95, 0.95, (B, ACT)).astype(np.float32)
    key = jax.random.key(11)
    want = jm.pi(jp, obs, key)
    got = tm.pi(tp, torch.from_numpy(obs),
                torch.from_numpy(_normal(key, (B, ACT))))
    for g, w in zip(got, want):
        assert _rel_max(g, w) < TOL
    for g, w in zip(tm.q(tp, torch.from_numpy(obs),
                         torch.from_numpy(actions)),
                    jm.q(jp, obs, actions)):
        assert _rel_max(g, w) < TOL
    assert _rel_max(tm.logp(tp, torch.from_numpy(obs),
                            torch.from_numpy(actions)),
                    jm.logp(jp, obs, actions)) < TOL
    for k in ("logits", "vf"):
        assert _rel_max(tm.forward(tp, torch.from_numpy(obs))[k],
                        jm.forward(jp, obs)[k]) < TOL
    for g, w in zip(tm.greedy_action(tp, torch.from_numpy(obs)),
                    jm.greedy_action(jp, obs)):
        assert _rel_max(g, w, 1e-2) < TOL


@pytest.mark.parametrize("algo", ["sac", "cql"])
def test_sac_and_cql_learners_match_jax(algo):
    config = {"lr": 3e-3, "seed": 0, "gamma": 0.95, "tau": 0.05,
              "cql_alpha": 0.5, "cql_n_actions": 3}
    jcls, tcls = ((jsac.SACLearner, tsac.SACLearner) if algo == "sac"
                  else (JCQL, CQLLearner))
    jl, tl = _sac_pair(jcls, tcls, config)
    batch = _transitions(3, discrete=False)
    # the keys JAX's update splits from its state
    _, k1, k2 = jax.random.split(jl._rng, 3)
    draws = (_sac_draws(k1, k2) if algo == "sac"
             else _cql_draws(k1, k2, config["cql_n_actions"]))
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jl._losses, has_aux=True))(
        jl.params, jl.target_params, batch, k1, k2)
    loss, metrics = tl._losses(tl.params, tl.target_params, _t(batch),
                               _t(draws))
    loss.backward()
    assert _close(loss.item(), float(jloss))
    _metrics_close(metrics, jm)
    _grads_close(port_grads(tl.params), jgrads)

    init = jax.device_get(jl.params)
    init_target = jax.device_get(jl.target_params)
    want = jl.update(batch)
    got = tl.update(batch, draws=draws)
    assert got.keys() == want.keys()
    _metrics_close(got, want)
    _update_close(tl.get_weights(), jax.device_get(jl.params), init)
    _update_close(tl.get_state()["target_params"],
                  jax.device_get(jl.target_params), init_target)
    # the generator's draws have the layout of JAX's
    assert {k: tuple(v.shape) for k, v in tl._draws(B).items()} == {
        k: v.shape for k, v in draws.items()}


def test_sac_learner_state_round_trip():
    _, tl = _sac_pair(jsac.SACLearner, tsac.SACLearner, {"seed": 0})
    tl.update(_transitions(4, discrete=False))
    other = tsac.SACLearner(tsac.SACModuleSpec(**SAC_SPEC), {"seed": 0},
                            device="cpu")
    other.set_state(tl.get_state())
    batch, draws = _transitions(5, discrete=False), tl._draws(B)
    assert tl.update(batch, draws=draws) == other.update(batch, draws=draws)
    for a, b in zip(tree_leaves(tl.get_state()["target_params"]),
                    tree_leaves(other.get_state()["target_params"])):
        assert torch.equal(a, b)


# ------------------------------------------------------------ DDPG/TD3

DDPG_SPEC = dict(obs_dim=OBS, action_dim=ACT, hiddens=(16, 16))


def test_ddpg_module_matches_jax():
    jm = jddpg.DDPGModuleSpec(**DDPG_SPEC).build()
    tm = tddpg.DDPGModuleSpec(**DDPG_SPEC).build()
    jp = jm.init(jax.random.key(4))
    tp = to_port(jp)
    obs = np.random.default_rng(1).normal(size=(B, OBS)).astype(np.float32)
    assert _rel_max(tm.pi(tp, torch.from_numpy(obs)), jm.pi(jp, obs)) < TOL
    for k in ("logits", "vf"):
        assert _rel_max(tm.forward(tp, torch.from_numpy(obs))[k],
                        jm.forward(jp, obs)[k]) < TOL
    for g, w in zip(tm.greedy_action(tp, torch.from_numpy(obs)),
                    jm.greedy_action(jp, obs)):
        assert _rel_max(g, w, 1e-2) < TOL
    a, _, _ = tm.explore_action(tp, torch.from_numpy(obs),
                                torch.Generator().manual_seed(0))
    assert a.abs().max() <= 1.0
    assert 0 < (a - tm.pi(tp, torch.from_numpy(obs))).abs().max() < 1.0


@pytest.mark.parametrize("algo", ["ddpg", "td3"])
def test_ddpg_and_td3_learners_match_jax(algo):
    """Two updates: TD3's first leaves the actor's grads at zero (policy
    delay 2), its second steps the actor; the smoothing noise from JAX's
    keys."""
    config = {"lr": 3e-3, "seed": 0, "gamma": 0.95, "tau": 0.05}
    if algo == "td3":
        config.update(twin_q=True, policy_delay=2, target_noise=0.2,
                      noise_clip=0.5)
    jl = jddpg.DDPGLearner(jddpg.DDPGModuleSpec(**DDPG_SPEC), dict(config))
    jl.target_params = perturbed(jl.target_params, 5)
    tl = tddpg.DDPGLearner(tddpg.DDPGModuleSpec(**DDPG_SPEC), dict(config),
                           device="cpu")
    tl.set_weights(to_port(jl.params))
    tdqn.load_tree(tl.target_params, to_port(jl.target_params))

    batch = _transitions(6, discrete=False)
    _, key = jax.random.split(jl._rng)
    draws = {"target_noise": _normal(key, (B, ACT))}
    critic, actor = (_closure(jl._update, n)
                     for n in ("critic_loss", "actor_loss"))
    (jc, jm), jcg = jax.value_and_grad(critic, has_aux=True)(
        jl.params, jl.target_params, batch, key)
    ja, jag = jax.value_and_grad(actor)(jl.params, batch)
    c, a, metrics = tl._losses(tl.params, tl.target_params, _t(batch),
                               _t(draws))
    (c + a).backward()
    assert _close(float(c), float(jc)) and _close(float(a), float(ja))
    _metrics_close(metrics, jm)
    got = port_grads(tl.params)
    _grads_close({k: v for k, v in got.items() if not
                  k.startswith("actor")}, {"q1": jcg["q1"],
                                           "q2": jcg["q2"]})
    _grads_close({k: v for k, v in got.items() if k.startswith("actor")},
                 {"actor": jag["actor"]})

    for step in range(2):
        _, key = jax.random.split(jl._rng)
        draws = {"target_noise": _normal(key, (B, ACT))}
        init = jax.device_get(jl.params)
        init_target = jax.device_get(jl.target_params)
        want = jl.update(batch)
        got = tl.update(batch, draws=draws)
        assert got.keys() == want.keys()
        _metrics_close(got, want)
        _update_close(tl.get_weights(), jax.device_get(jl.params), init)
        _update_close(tl.get_state()["target_params"],
                      jax.device_get(jl.target_params), init_target)
        moved = not np.array_equal(np.asarray(jl.params["actor"][0]["w"]),
                                   init["actor"][0]["w"])
        assert moved == (algo == "ddpg" or step == 1)
    assert tl.get_state()["n_updates"] == 2


def test_learners_default_to_the_card(monkeypatch):
    """With no device asked for, every new learner is on the card, and
    without one it raises (no quiet CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (
            lambda: tdqn.DQNLearner(tdqn.DQNModuleSpec(3, 2), {}),
            lambda: tsac.SACLearner(tsac.SACModuleSpec(3, 1), {}),
            lambda: tddpg.DDPGLearner(tddpg.DDPGModuleSpec(3, 1), {})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


# ------------------------------------------- the reference's mechanics

@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_dqn_mechanics_and_checkpoint(port_cluster, tmp_path):
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                        rollout_fragment_length=16)
           .training(lr=1e-3, train_batch_size=64,
                     num_steps_sampled_before_learning_starts=200,
                     target_network_update_freq=256,
                     training_intensity=1.0, prioritized_replay=True)
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        for _ in range(4):
            result = algo.step()
        assert result["num_env_steps_sampled_lifetime"] >= 512
        assert np.isfinite(result["td_error_mean"])
        assert 0.0 <= result["epsilon"] <= 1.0
        d = str(tmp_path / "dqn_ckpt")
        os.makedirs(d, exist_ok=True)
        algo.save_checkpoint(d)
        learner = algo.learner_group.local_learner()
        w_before = learner.get_weights()["q"][0]["w"].numpy()
        target_before = tree_leaves(learner.target_params)
    finally:
        algo.stop()

    algo2 = cfg.copy().build()
    try:
        algo2.load_checkpoint(d)
        learner2 = algo2.learner_group.local_learner()
        w_after = learner2.get_weights()["q"][0]["w"].numpy()
        np.testing.assert_allclose(w_before, w_after)
        # target params restored too
        assert learner2.target_params is not None
        for a, b in zip(tree_leaves(learner2.target_params), target_before):
            assert torch.equal(a, b)
    finally:
        algo2.stop()
