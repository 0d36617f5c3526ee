"""The port's algorithms on the port's runtime, on the CPU: the reference's
cases of ``tests/test_rllib.py`` (the fluent config and build, the
checkpoint restore, the env-runner fault tolerance, IMPALA's async
mechanics) and ``tests/test_rllib_connectors.py``'s end-to-end case, to
the same expectations, with the learners on ``device="cpu"``; the
learners' default device; and the package's import boundary and its names
still to port. ``tests/test_torch_rllib_multi.py`` holds the multi-agent,
multi-learner and multi-trial cases.

One port cluster per module, ``init(num_cpus=4)``. Envs are gymnasium's, so
that no worker imports this module."""

import ast
import os
import pathlib
import subprocess
import sys

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import rllib  # noqa: E402
from ray_tpu_torch._private.tree import tree_leaves  # noqa: E402
from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig  # noqa: E402
from ray_tpu_torch.rllib.connectors import (  # noqa: E402
    ConnectorPipeline, FrameStack, NormalizeObs)
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def _small_ppo(**runners):
    return (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(**dict(dict(num_env_runners=1,
                                     num_envs_per_env_runner=2,
                                     rollout_fragment_length=16), **runners))
            .learners(device="cpu"))


# ------------------------------------------------- tests/test_rllib.py's

def test_config_fluent_and_build(port_cluster):
    cfg = (PPOConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                        rollout_fragment_length=16)
           .training(lr=1e-3, train_batch_size=64, minibatch_size=32,
                     num_epochs=1, clip_param=0.3)
           .learners(device="cpu")
           .debugging(seed=7))
    assert cfg.clip_param == 0.3 and cfg.learner_device == "cpu"
    algo = cfg.build()
    try:
        result = algo.train()
        assert result["env_steps_this_iter"] >= 64
        assert "total_loss" in result
        assert result["training_iteration"] == 1
        learner = algo.learner_group.local_learner()
        assert {p.device.type for p in tree_leaves(learner.params)} == {
            "cpu"}
    finally:
        algo.stop()

    with pytest.raises(ValueError):
        PPOConfig().framework("jax")
    assert PPOConfig().framework("torch").framework_str == "torch"
    assert PPOConfig().learner_device is None  # the card by default


def test_learner_device_defaults_to_the_card(monkeypatch):
    """With no device asked for, the learners are on the card, and without
    one the build raises (no quiet CPU fallback); remote learners ask the
    runtime for a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _small_ppo(num_env_runners=0)
    cfg.learner_device = None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cfg.build()
    assert cfg.resources_for_learners() == {"CPU": 1, "GPU": 1}
    assert cfg.learners(device="cpu").resources_for_learners() == {"CPU": 1}


def test_checkpoint_restore(port_cluster, tmp_path):
    cfg = _small_ppo().training(train_batch_size=32, minibatch_size=32,
                                num_epochs=1)
    algo = cfg.build()
    try:
        algo.train()
        d = str(tmp_path / "ckpt")
        os.makedirs(d, exist_ok=True)
        algo.save_checkpoint(d)
        w0 = algo.get_weights()
        steps = algo._total_env_steps
    finally:
        algo.stop()

    algo2 = cfg.copy().build()
    try:
        algo2.load_checkpoint(d)
        w1 = algo2.get_weights()
        np.testing.assert_allclose(w0["pi"][0]["w"].numpy(),
                                   w1["pi"][0]["w"].numpy())
        for a, b in zip(tree_leaves(w0), tree_leaves(w1)):
            assert torch.equal(a, b)
        assert algo2._total_env_steps == steps
    finally:
        algo2.stop()


def test_env_runner_fault_tolerance(port_cluster):
    cfg = _small_ppo(num_env_runners=2).training(
        train_batch_size=64, minibatch_size=32, num_epochs=1)
    algo = cfg.build()
    try:
        algo.train()
        # kill one runner; the next step must replace it and continue
        ray_tpu_torch.kill(algo.env_runners[0])
        result = algo.train()
        assert result["env_steps_this_iter"] >= 32
        result = algo.train()
        assert result["env_steps_this_iter"] >= 64
    finally:
        algo.stop()


def test_impala_async_mechanics(port_cluster):
    cfg = (IMPALAConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=16)
           .training(lr=5e-4, num_fragments_per_step=4,
                     broadcast_interval=2)
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        r1 = algo.step()
        assert r1["num_fragments_consumed"] == 4
        assert r1["env_steps_this_iter"] == 4 * 16 * 4
        r2 = algo.step()
        assert np.isfinite(r2["policy_loss"])
        assert np.isfinite(r2["entropy"])
    finally:
        algo.stop()


def test_compute_single_action(port_cluster):
    algo = _small_ppo(num_env_runners=0).build()
    try:
        obs = np.array([0.01, -0.02, 0.03, 0.01], np.float32)
        greedy = algo.compute_single_action(obs)
        assert greedy in (0, 1)
        assert algo.compute_single_action(obs, explore=True) == \
            algo.compute_single_action(obs, explore=True)
    finally:
        algo.stop()


# ------------------------------------- tests/test_rllib_connectors.py's

def test_ppo_with_connector_pipeline_e2e(port_cluster):
    """PPO trains through a NormalizeObs+FrameStack pipeline; the module's
    obs_dim accounts for the stacking multiplier."""
    pipe = ConnectorPipeline([NormalizeObs(), FrameStack(k=2)])
    cfg = (PPOConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=32, connector=pipe)
           .training(lr=1e-3, train_batch_size=128, minibatch_size=64,
                     num_epochs=2)
           .learners(device="cpu"))
    spec = cfg.module_spec()
    assert spec.obs_dim == 8  # 4 features x 2 stacked frames
    algo = cfg.build()
    try:
        r = algo.step()
        assert np.isfinite(r["policy_loss"])
        assert r["env_steps_this_iter"] >= 128
    finally:
        algo.stop()


# ----------------------------------------------------------- the package

RLLIB_MODULES = [
    "ray_tpu_torch.rllib.algorithms.algorithm",
    "ray_tpu_torch.rllib.algorithms.algorithm_config",
    "ray_tpu_torch.rllib.algorithms.a2c.a2c",
    "ray_tpu_torch.rllib.algorithms.alpha_zero.alpha_zero",
    "ray_tpu_torch.rllib.algorithms.apex.apex",
    "ray_tpu_torch.rllib.algorithms.appo.appo",
    "ray_tpu_torch.rllib.algorithms.ars.ars",
    "ray_tpu_torch.rllib.algorithms.bandit.bandit",
    "ray_tpu_torch.rllib.algorithms.bc.bc",
    "ray_tpu_torch.rllib.algorithms.cql.cql",
    "ray_tpu_torch.rllib.algorithms.crr.crr",
    "ray_tpu_torch.rllib.algorithms.ddpg.ddpg",
    "ray_tpu_torch.rllib.algorithms.ddppo.ddppo",
    "ray_tpu_torch.rllib.algorithms.dqn.dqn",
    "ray_tpu_torch.rllib.algorithms.dreamerv3.dreamerv3",
    "ray_tpu_torch.rllib.algorithms.es.es",
    "ray_tpu_torch.rllib.algorithms.impala.impala",
    "ray_tpu_torch.rllib.algorithms.maddpg.maddpg",
    "ray_tpu_torch.rllib.algorithms.marwil.marwil",
    "ray_tpu_torch.rllib.algorithms.ppo.multi_agent",
    "ray_tpu_torch.rllib.algorithms.ppo.ppo",
    "ray_tpu_torch.rllib.algorithms.qmix.qmix",
    "ray_tpu_torch.rllib.algorithms.r2d2.r2d2",
    "ray_tpu_torch.rllib.algorithms.sac.sac",
    "ray_tpu_torch.rllib.connectors.connector",
    "ray_tpu_torch.rllib.env.env_runner",
    "ray_tpu_torch.rllib.env.multi_agent_env",
    "ray_tpu_torch.rllib.env.policy_client",
    "ray_tpu_torch.rllib.env.policy_server_input",
    "ray_tpu_torch.rllib.env.vector",
    "ray_tpu_torch.rllib.offline.estimators",
    "ray_tpu_torch.rllib.offline.json_io",
    "ray_tpu_torch.rllib.utils.gae",
    "ray_tpu_torch.rllib.utils.replay_buffer",
    "ray_tpu_torch.rllib.utils.schedules",
    "ray_tpu_torch.rllib.utils.vtrace",
]


def test_rllib_imports_no_jax_no_ray_tpu_no_gymnasium():
    """Every module of ``ray_tpu_torch.rllib`` loads neither jax, the JAX
    package nor gymnasium (which only a string env id reaches)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch.rllib as r\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    r.__path__, 'ray_tpu_torch.rllib.')]\n"
        f"missing = set({RLLIB_MODULES!r}) - set(names)\n"
        "assert not missing, missing\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu', 'gymnasium')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_every_reference_algorithm_is_exported():
    """The port's ``__all__`` is the reference's ``ray_tpu.rllib.__all__``,
    name for name; every name resolves to the port's own object (none
    raises), and an unknown name raises ``AttributeError``."""
    tree = ast.parse((REPO / "ray_tpu" / "rllib" / "__init__.py")
                     .read_text())
    ref_all = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and n.targets[0].id == "__all__")
    assert sorted(rllib.__all__) == sorted(ref_all)
    assert len(set(rllib.__all__)) == len(rllib.__all__)
    for name in rllib.__all__:
        obj = getattr(rllib, name)
        assert obj.__module__.startswith("ray_tpu_torch."), name
    # the seven families of the last slice among them
    for name in ("ES", "ARS", "BanditLinUCB", "BanditLinTS", "QMIX",
                 "MADDPG", "AlphaZero", "DreamerV3"):
        cfg = getattr(rllib, name + "Config")()
        assert cfg.algo_class is getattr(rllib, name)
    assert not hasattr(rllib, "NOT_PORTED")
    with pytest.raises(AttributeError):
        rllib.NoSuchAlgorithm
