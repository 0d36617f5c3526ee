"""The port's offline learners (BC, MARWIL and CRR) against the JAX
package's, on the CPU, and the reference's offline cases on the port:
``tests/test_rllib.py``'s BC imitates a scripted policy,
``tests/test_rllib_algos.py``'s MARWIL beats BC on mixed-quality data and
CQL's offline mechanics, ``tests/test_rllib_breadth.py``'s CRR recovers a
policy from uniform behavior — their datasets, configs and thresholds, the
learners on ``device="cpu"``. (CQL's learner is held against JAX's in
``tests/test_torch_rllib_offpolicy.py``, beside SAC's.)

Weights go from JAX to the port through ``rl_params_from_jax``; CRR's
target critics are perturbed first. CRR's draws are JAX's: the test splits
the JAX learner's key as its update does and feeds the standard-normal
arrays JAX's loss draws to the port's as ``draws``. Tolerances are
``tests/test_torch_rllib_core.py``'s.

The algorithms read JSONL datasets and start no env runner; they run on one
port cluster, ``init(num_cpus=4)``."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.algorithms.bc.bc import BCLearner as JBC  # noqa: E402
from ray_tpu.rllib.algorithms.crr.crr import CRRLearner as JCRR  # noqa: E402
from ray_tpu.rllib.algorithms.marwil import marwil as jmarwil  # noqa: E402
from ray_tpu.rllib.algorithms.sac import sac as jsac  # noqa: E402
from ray_tpu.rllib.core.rl_module import RLModuleSpec as JRLSpec  # noqa: E402
from ray_tpu_torch.rllib.algorithms.bc.bc import BCLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.crr.crr import CRRLearner  # noqa: E402
from ray_tpu_torch.rllib.algorithms.dqn.dqn import load_tree  # noqa: E402
from ray_tpu_torch.rllib.algorithms.marwil import (  # noqa: E402
    marwil as tmarwil)
from ray_tpu_torch.rllib.algorithms.sac.sac import SACModuleSpec  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec  # noqa: E402
from ray_tpu_torch.rllib.offline import JsonWriter  # noqa: E402
from tests.test_torch_rllib_core import _close, _update_close  # noqa: E402
from tests.test_torch_rllib_offpolicy import (  # noqa: E402
    _grads_close, _metrics_close, _normal, _t, perturbed, port_grads,
    to_port)
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

B = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- the learners

@pytest.mark.parametrize("algo,discrete", [("bc", True), ("bc", False),
                                           ("marwil", True),
                                           ("marwil", False)])
def test_bc_and_marwil_learners_match_jax(algo, discrete):
    spec = dict(obs_dim=4, action_dim=2, discrete=discrete)
    config = {"lr": 3e-3, "seed": 0, "num_epochs": 1,
              "minibatch_size": None, "beta": 2.0, "vf_coeff": 0.5}
    jcls, tcls = ((JBC, BCLearner) if algo == "bc" else
                  (jmarwil.MARWILLearner, tmarwil.MARWILLearner))
    jl = jcls(JRLSpec(**spec), dict(config), use_mesh=False)
    jl.params = perturbed(jl.params, 1)
    tl = tcls(RLModuleSpec(**spec), dict(config), device="cpu")
    tl.set_weights(to_port(jl.params))
    rng = np.random.default_rng(2)
    batch = {"obs": rng.normal(size=(B, 4)).astype(np.float32),
             "actions": (rng.integers(0, 2, B) if discrete else
                         rng.normal(size=(B, 2)).astype(np.float32))}
    if algo == "marwil":
        batch["returns"] = jmarwil.monte_carlo_returns(
            rng.normal(size=B).astype(np.float32),
            rng.random(B) < 0.2, 0.99)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jl.loss, has_aux=True))(jl.params, batch)
    loss, metrics = tl.loss(tl.params, tl._batch(batch))
    loss.backward()
    assert _close(loss.item(), float(jloss))
    _metrics_close(metrics, jm)
    _grads_close(port_grads(tl.params), jgrads)

    init = jax.device_get(jl.params)
    want = jl.update(batch)
    got = tl.update(batch)
    for k in want:
        assert _close(got[k], want[k]), k
    _update_close(tl.get_weights(), jax.device_get(jl.params), init)


def test_monte_carlo_returns_match_jax():
    rng = np.random.default_rng(3)
    rewards = rng.normal(size=200).astype(np.float32)
    dones = rng.random(200) < 0.1
    np.testing.assert_array_equal(
        tmarwil.monte_carlo_returns(rewards, dones, 0.97),
        jmarwil.monte_carlo_returns(rewards, dones, 0.97))


@pytest.mark.parametrize("weight_type", ["exp", "binary"])
def test_crr_learner_matches_jax(weight_type):
    config = {"lr": 1e-3, "seed": 0, "gamma": 0.9, "tau": 0.05,
              "crr_weight_type": weight_type, "crr_beta": 0.5,
              "crr_n_actions": 3, "crr_w_max": 20.0}
    spec = dict(obs_dim=3, action_dim=2, hiddens=(16, 16))
    jl = JCRR(jsac.SACModuleSpec(**spec), dict(config))
    jl.target_params = perturbed(jl.target_params, 7)
    tl = CRRLearner(SACModuleSpec(**spec), dict(config), device="cpu")
    tl.set_weights(to_port(jl.params))
    load_tree(tl.target_params, to_port(jl.target_params))
    rng = np.random.default_rng(4)
    batch = {"obs": rng.normal(size=(B, 3)).astype(np.float32),
             "actions": rng.uniform(-0.95, 0.95, (B, 2)).astype(np.float32),
             "rewards": rng.normal(size=B).astype(np.float32),
             "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
             "dones": (rng.random(B) < 0.3).astype(np.float32)}
    _, k1, k2 = jax.random.split(jl._rng, 3)
    draws = {"next": _normal(k1, (B, 2)),
             "pi_m": np.stack([_normal(k, (B, 2)) for k in
                               jax.random.split(k2, 3)])}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jl._losses, has_aux=True))(jl.params, jl.target_params, batch, k1,
                                   k2)
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
    assert {k: tuple(v.shape) for k, v in tl._draws(B).items()} == {
        k: v.shape for k, v in draws.items()}


# ------------------------------------------- the reference's offline cases

@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_bc_imitates_scripted_policy(port_cluster, tmp_path):
    """BC on a dataset from a deterministic scripted policy must reproduce
    that policy (reference: BC learning tests in rllib/algorithms/bc)."""
    from ray_tpu_torch.rllib import BCConfig

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(2000, 4)).astype(np.float32)
    actions = (obs[:, 0] + obs[:, 2] > 0).astype(np.int64)  # scripted rule
    w = JsonWriter(str(tmp_path))
    for s in range(0, 2000, 500):
        w.write({"obs": obs[s:s + 500], "actions": actions[s:s + 500]})
    w.close()

    cfg = (BCConfig()
           .training(lr=3e-3, train_batch_size=256, num_epochs=2,
                     obs_dim=4, action_dim=2, discrete=True,
                     dataset_epochs_per_iter=2)
           .offline(offline_data=str(tmp_path))
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        for _ in range(8):
            result = algo.step()
        assert np.isfinite(result["bc_loss"])
        # imitation accuracy on held-out states
        test_obs = rng.normal(size=(500, 4)).astype(np.float32)
        want = (test_obs[:, 0] + test_obs[:, 2] > 0).astype(np.int64)
        module = algo._module_spec.build()
        out = module.forward(algo.get_weights(), torch.from_numpy(test_obs))
        got = torch.argmax(out["logits"], dim=-1).numpy()
        acc = (got == want).mean()
        assert acc > 0.9, f"BC accuracy {acc}"
    finally:
        algo.stop()


def _write_bandit_dataset(tmp_path, n=3000, seed=0):
    """Logged 1-step episodes from a UNIFORM behavior policy; reward 1 when
    the action matches the scripted rule, else 0. BC clones the uniform
    junk; MARWIL's advantage weighting must recover the rule."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(n, 4)).astype(np.float32)
    optimal = (obs[:, 0] + obs[:, 2] > 0).astype(np.int64)
    actions = rng.integers(0, 2, n)
    rewards = (actions == optimal).astype(np.float32)
    w = JsonWriter(str(tmp_path))
    for s in range(0, n, 500):
        sl = slice(s, s + 500)
        w.write({"obs": obs[sl], "actions": actions[sl],
                 "rewards": rewards[sl],
                 "dones": np.ones(500, np.float32)})
    w.close()
    return obs, optimal


def test_marwil_beats_bc_on_mixed_quality_data(port_cluster, tmp_path):
    from ray_tpu_torch.rllib import MARWILConfig

    obs, optimal = _write_bandit_dataset(tmp_path)
    cfg = (MARWILConfig()
           .training(lr=3e-3, train_batch_size=256, beta=2.0,
                     dataset_epochs_per_iter=2,
                     obs_dim=4, action_dim=2, discrete=True)
           .offline(offline_data=str(tmp_path))
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        for _ in range(4):
            r = algo.step()
        weights = algo.learner_group.get_weights()
        module = algo._module_spec.build()
        out = module.forward(weights, torch.from_numpy(obs[:500]))
        pred = out["logits"].argmax(-1).numpy()
        acc = (pred == optimal[:500]).mean()
        # uniform behavior policy is 50% — advantage weighting must beat it
        assert acc > 0.8, f"MARWIL accuracy {acc}"
        assert np.isfinite(r["mean_weight"])
    finally:
        algo.stop()


def test_cql_offline_mechanics(port_cluster, tmp_path):
    from ray_tpu_torch.rllib import CQLConfig

    rng = np.random.default_rng(0)
    n = 1000
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    actions = rng.uniform(-1, 1, size=(n, 1)).astype(np.float32)
    rewards = -np.abs(actions[:, 0] - np.tanh(obs[:, 0])).astype(np.float32)
    next_obs = rng.normal(size=(n, 3)).astype(np.float32)
    dones = (rng.random(n) < 0.1).astype(np.float32)
    w = JsonWriter(str(tmp_path))
    w.write({"obs": obs, "actions": actions, "rewards": rewards,
             "next_obs": next_obs, "dones": dones})
    w.close()

    cfg = (CQLConfig()
           .training(lr=3e-4, train_batch_size=128, cql_alpha=1.0,
                     cql_n_actions=2, obs_dim=3, action_dim=1)
           .offline(offline_data=str(tmp_path))
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        for _ in range(2):
            r = algo.step()
        assert np.isfinite(r["critic_loss"])
        assert np.isfinite(r["cql_loss"])
        # the conservative gap logsumexp_a Q - Q(data) must be finite and
        # being minimized
        assert np.isfinite(r["cql_gap"])
    finally:
        algo.stop()


def test_crr_recovers_policy_from_uniform_behavior(port_cluster, tmp_path):
    """Offline dataset from a UNIFORM behavior policy on a 1-step task
    with reward -(a - tanh(obs0))^2. Plain BC clones uniform noise; CRR's
    advantage weighting must land near the reward-maximizing action."""
    from ray_tpu_torch.rllib import CRRConfig

    rng = np.random.default_rng(0)
    n = 4000
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    actions = rng.uniform(-1, 1, size=(n, 1)).astype(np.float32)
    target = np.tanh(obs[:, 0])
    rewards = -np.abs(actions[:, 0] - target).astype(np.float32)
    next_obs = rng.normal(size=(n, 3)).astype(np.float32)
    dones = np.ones(n, np.float32)  # 1-step episodes
    w = JsonWriter(str(tmp_path))
    w.write({"obs": obs, "actions": actions, "rewards": rewards,
             "next_obs": next_obs, "dones": dones})
    w.close()

    cfg = (CRRConfig()
           .training(lr=1e-3, train_batch_size=256,
                     dataset_epochs_per_iter=2, crr_beta=0.25,
                     obs_dim=3, action_dim=1)
           .offline(offline_data=str(tmp_path))
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        for _ in range(6):
            r = algo.step()
        assert np.isfinite(r["critic_loss"])
        assert r["weight_mean"] > 0
        learner = algo.learner_group.local_learner()
        module = learner.module
        test_obs = rng.normal(size=(256, 3)).astype(np.float32)
        with torch.no_grad():
            _, _, greedy = module.pi(learner.params,
                                     torch.from_numpy(test_obs),
                                     torch.zeros((256, 1)))
        err = float(np.mean(np.abs(
            greedy.numpy()[:, 0] - np.tanh(test_obs[:, 0]))))
        # uniform behavior has mean abs error ~0.6 against the target
        assert err < 0.25, f"CRR greedy action error {err}"
    finally:
        algo.stop()
