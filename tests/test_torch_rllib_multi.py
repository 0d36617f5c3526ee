"""The port's multi-agent, multi-learner and multi-trial algorithms on the
port's runtime, on the CPU: ``tests/test_rllib_multi_agent.py``'s three
cases to the same expectations, with the learners on ``device="cpu"``;
DD-PPO's two remote CPU learners, whose params stay bit-identical; and
``Tuner(PPO, param_space=...)`` with two trials.

One port cluster per module, ``init(num_cpus=4)``. The multi-agent env is a
class made inside a function, so that it travels to the runners by value
and no worker imports this module."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch._private.tree import tree_leaves  # noqa: E402
from ray_tpu_torch.rllib import (  # noqa: E402
    DDPPOConfig, MultiAgentEnv, MultiAgentPPOConfig, PPO)
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


# ------------------------------------ tests/test_rllib_multi_agent.py's

def _sign_game():
    """``tests/test_rllib_multi_agent.py``'s SignGame, made here so that it
    travels by value: each agent sees a 2-dim obs; action 1 is rewarded
    iff obs[0] > 0."""

    class SignGame(MultiAgentEnv):
        possible_agents = ["a0", "a1"]

        def __init__(self, episode_len=10, seed=0):
            import gymnasium as gym

            self._spaces = {a: gym.spaces.Box(-1, 1, (2,), np.float32)
                            for a in self.possible_agents}
            self._aspaces = {a: gym.spaces.Discrete(2)
                             for a in self.possible_agents}
            self._rng = np.random.default_rng(seed)
            self._len = episode_len
            self._t = 0

        @property
        def observation_spaces(self):
            return self._spaces

        @property
        def action_spaces(self):
            return self._aspaces

        def _obs(self):
            return {a: self._rng.uniform(-1, 1, 2).astype(np.float32)
                    for a in self.possible_agents}

        def reset(self, *, seed=None):
            self._t = 0
            self._cur = self._obs()
            return dict(self._cur), {}

        def step(self, action_dict):
            rewards = {}
            for a, act in action_dict.items():
                correct = int(self._cur[a][0] > 0)
                rewards[a] = 1.0 if int(act) == correct else 0.0
            self._t += 1
            done = self._t >= self._len
            self._cur = self._obs()
            terms = {a: done for a in action_dict}
            terms["__all__"] = done
            return dict(self._cur), rewards, terms, {"__all__": False}, {}

    return SignGame


def test_multi_agent_ppo_learns_per_policy(port_cluster):
    SignGame = _sign_game()
    cfg = (MultiAgentPPOConfig()
           .environment(lambda cfg=None: SignGame())
           .multi_agent(policies=["p0", "p1"],
                        policy_mapping_fn=lambda aid: "p" + aid[-1])
           .env_runners(num_env_runners=2, rollout_fragment_length=64)
           .training(lr=5e-3, train_batch_size=256, minibatch_size=128,
                     num_epochs=6, entropy_coeff=0.0)
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        for i in range(7):
            r = algo.step()
        # both policies must act correctly on held-out observations
        for pid in ("p0", "p1"):
            correct = 0
            rng = np.random.default_rng(7)
            for _ in range(40):
                obs = rng.uniform(-1, 1, 2).astype(np.float32)
                act = algo.compute_single_action(obs, policy_id=pid)
                correct += int(act == int(obs[0] > 0))
            assert correct >= 30, f"{pid}: {correct}/40"
        assert any(k.startswith("p0/") for k in r)
        assert any(k.startswith("p1/") for k in r)
    finally:
        algo.stop()


def test_shared_policy_self_play(port_cluster):
    SignGame = _sign_game()
    cfg = (MultiAgentPPOConfig()
           .environment(lambda cfg=None: SignGame())
           .multi_agent(policies=["shared"],
                        policy_mapping_fn=lambda aid: "shared")
           .env_runners(num_env_runners=1, rollout_fragment_length=64)
           .training(lr=3e-3, train_batch_size=128, minibatch_size=128,
                     num_epochs=4)
           .learners(device="cpu"))
    algo = cfg.build()
    try:
        r = algo.step()
        assert r["env_steps_this_iter"] >= 128
        assert any(k.startswith("shared/") for k in r)
        assert np.isfinite(r["shared/total_loss"])
    finally:
        algo.stop()


def test_policy_mapping_validation(port_cluster):
    SignGame = _sign_game()
    cfg = (MultiAgentPPOConfig()
           .environment(lambda cfg=None: SignGame())
           .multi_agent(policies=["p0", "orphan"],
                        policy_mapping_fn=lambda aid: "p0")
           .learners(device="cpu"))
    with pytest.raises(ValueError, match="orphan"):
        cfg.build()


# ------------------------------------------------------- DD-PPO, Tune

def test_ddppo_learners_stay_bit_identical(port_cluster):
    """Two remote CPU learners, each on half of every train batch, all-reduce
    their grads through the host collective group: after two iterations of
    2 epochs x 2 minibatches their params are bit-identical and moved."""
    cfg = (DDPPOConfig()
           .environment("CartPole-v1")
           .env_runners(num_env_runners=1, num_envs_per_env_runner=2,
                        rollout_fragment_length=64)
           .training(train_batch_size=128, minibatch_size=32, num_epochs=2)
           .learners(device="cpu"))
    assert cfg.num_learners == 2
    algo = cfg.build()
    try:
        assert not algo.learner_group.is_local
        w0 = algo.get_weights()
        for _ in range(2):
            r = algo.train()
            assert r["env_steps_this_iter"] >= 128
            assert np.isfinite(r["total_loss"])
        ws = ray_tpu_torch.get([w.get_weights.remote()
                                for w in algo.learner_group._workers],
                               timeout=60)
        for a, b in zip(tree_leaves(ws[0]), tree_leaves(ws[1])):
            assert torch.equal(a, b)
        assert not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(ws[0]), tree_leaves(w0)))
    finally:
        algo.stop()


def test_tuner_sweeps_ppo(port_cluster, tmp_path):
    """``Tuner(PPO, param_space=...)``: each trial's config dict sets the
    ``AlgorithmConfig``'s fields; two trials of two iterations."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.air.config import RunConfig

    results = tune.Tuner(
        PPO,
        param_space={"env": "CartPole-v1", "num_env_runners": 1,
                     "num_envs_per_env_runner": 2,
                     "rollout_fragment_length": 16, "train_batch_size": 64,
                     "minibatch_size": 32, "num_epochs": 1,
                     "learner_device": "cpu",
                     "lr": tune.grid_search([1e-3, 1e-4])},
        tune_config=tune.TuneConfig(metric="total_loss", mode="min",
                                    max_concurrent_trials=2),
        run_config=RunConfig(name="ppo", storage_path=str(tmp_path),
                             stop={"training_iteration": 2}),
    ).fit()
    assert results.num_errors == 0, results.errors
    assert len(results) == 2
    assert sorted(r.config["lr"] for r in results) == [1e-4, 1e-3]
    for r in results:
        assert r.metrics["training_iteration"] == 2
        assert r.metrics["num_env_steps_sampled_lifetime"] == 128
        assert np.isfinite(r.metrics["total_loss"])
