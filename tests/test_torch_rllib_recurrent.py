"""The port's R2D2 (recurrent replay DQN) against the JAX package's, on the
CPU, and the reference's cases of ``tests/test_rllib_r2d2.py`` on the port:
the module's recurrence, h and its inverse, R2D2 learning the memory task
(its config and threshold), and the policy server's transitions training a
DQN learner (the external-process case is in
``tests/test_torch_rllib_utils.py``).

Weights (the LSTM's included) go from JAX to the port through
``rl_params_from_jax``; the target net is perturbed first, so that it
differs from the online one; sequences are drawn with numpy from a seed,
with episode ends inside them and invalid (autoreset) rows. Tolerances are
``tests/test_torch_rllib_core.py``'s (1e-5 on losses, metrics, Q values
and grads; 1e-3 of the update on params).

The learning case runs on one port cluster, ``init(num_cpus=4)``;
``MemoryEnv`` is made inside a function, so that it travels to the runner
by value."""

import os
import threading

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.algorithms.r2d2 import r2d2 as jr2d2  # noqa: E402
from ray_tpu_torch.rllib.algorithms.dqn import dqn as tdqn  # noqa: E402
from ray_tpu_torch.rllib.algorithms.r2d2 import r2d2 as tr2d2  # noqa: E402
from tests.test_torch_rllib_core import (  # noqa: E402
    TOL, _assert_tree_close, _close, _rel_max, _update_close)
from tests.test_torch_rllib_offpolicy import (  # noqa: E402
    _grads_close, perturbed, port_grads, to_port)
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402

SPEC = dict(obs_dim=3, action_dim=3, hiddens=(16,), lstm_cell_size=8)
Bq, T = 6, 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequences(seed):
    """[B, T] sequences as the sequence buffer samples them: episode ends
    inside them, an invalid autoreset row after each end, and the stored
    (h, c) at their start."""
    rng = np.random.default_rng(seed)
    dones = (rng.random((Bq, T)) < 0.15).astype(np.float32)
    valid = np.ones((Bq, T), np.float32)
    valid[:, 1:][dones[:, :-1] > 0] = 0.0
    H = SPEC["lstm_cell_size"]
    return {
        "obs": rng.normal(size=(Bq, T, SPEC["obs_dim"])).astype(np.float32),
        "actions": rng.integers(0, SPEC["action_dim"], (Bq, T)),
        "rewards": rng.normal(size=(Bq, T)).astype(np.float32),
        "dones": dones,
        "valid": valid,
        "state_in": (rng.normal(size=(Bq, H)).astype(np.float32) * 0.5,
                     rng.normal(size=(Bq, H)).astype(np.float32) * 0.5),
    }


def test_h_rescale_and_inverse_match_jax():
    x = np.linspace(-50, 50, 101).astype(np.float32)
    for j, t in ((jr2d2.h_rescale, tr2d2.h_rescale),
                 (jr2d2.h_inverse, tr2d2.h_inverse)):
        assert _rel_max(t(torch.from_numpy(x)), j(x)) < TOL


def test_h_rescale_inverse():
    """``tests/test_rllib_r2d2.py``'s case."""
    x = np.linspace(-50, 50, 101).astype(np.float32)
    np.testing.assert_allclose(
        tr2d2.h_inverse(tr2d2.h_rescale(torch.from_numpy(x))).numpy(), x,
        rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dueling", [True, False])
def test_r2d2_module_matches_jax(dueling):
    spec = dict(SPEC, dueling=dueling)
    jm, tm = jr2d2.R2D2ModuleSpec(**spec).build(), \
        tr2d2.R2D2ModuleSpec(**spec).build()
    jp = perturbed(jm.init(jax.random.key(1)), 2)
    tp = to_port(jp)
    seq = _sequences(0)
    obs = np.swapaxes(seq["obs"], 0, 1)
    resets = np.swapaxes(seq["dones"], 0, 1)
    state = seq["state_in"]
    for mask in (None, resets):
        jq, (jh, jc) = jm.q_seq(jp, obs, state, mask)
        tq, (th, tc) = tm.q_seq(
            tp, torch.from_numpy(obs), tuple(map(torch.from_numpy, state)),
            None if mask is None else torch.from_numpy(mask))
        for g, w in ((tq, jq), (th, jh), (tc, jc)):
            assert _rel_max(g, w) < TOL
    for k in ("logits", "vf"):
        assert _rel_max(tm.forward(tp, torch.from_numpy(obs[0]))[k],
                        jm.forward(jp, obs[0])[k]) < TOL
    # epsilon 0: the recurrent step's action is greedy over Q(h)
    tp["epsilon"] = torch.tensor(0.0)
    a, _, vf, (h, c) = tm.explore_action_recurrent(
        tp, torch.from_numpy(obs[0]), tuple(map(torch.from_numpy, state)),
        torch.Generator().manual_seed(0))
    jq0, (jh0, _) = jm.q_seq(jp, obs[:1], state)
    assert np.array_equal(a.numpy(), np.argmax(np.asarray(jq0[0]), -1))
    assert _rel_max(vf, np.max(np.asarray(jq0[0]), -1)) < TOL
    assert _rel_max(h, jh0) < TOL


@pytest.mark.parametrize("burn_in,use_h", [(0, True), (3, True),
                                            (3, False)])
def test_r2d2_learner_matches_jax(burn_in, use_h):
    config = {"lr": 1e-3, "seed": 0, "gamma": 0.97, "burn_in": burn_in,
              "use_h_function": use_h}
    jl = jr2d2.R2D2Learner(jr2d2.R2D2ModuleSpec(**SPEC), dict(config),
                           use_mesh=False)
    jl.target_params = perturbed(jl.params, 4)
    tl = tr2d2.R2D2Learner(tr2d2.R2D2ModuleSpec(**SPEC), dict(config),
                           device="cpu")
    tl.set_weights(to_port(jl.params))
    tdqn.load_tree(tl.target_params, to_port(jl.target_params))
    batch = _sequences(1)

    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jl.loss, has_aux=True))(
        jl.params, dict(batch, target_params=jl.target_params))
    loss, metrics = tl.loss(tl.params, tl._batch(batch))
    loss.backward()
    assert _close(loss.item(), float(jloss))
    for k in ("td_error_mean", "qf_mean"):
        assert _close(metrics[k].item(), float(jm[k])), k
    # JAX stops the gradient at the burn-in's end: equal grads say the
    # port's detached carry does the same
    grads = port_grads(tl.params)
    _grads_close(grads, jgrads)
    assert not grads["epsilon"].any()
    init = jax.device_get(jl.params)
    want = jl.update(batch)
    got = tl.update(batch)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert _close(got[k], w), k
    _update_close(tl.get_weights(), jax.device_get(jl.params), init)
    jl.sync_target(0.5)
    tl.sync_target(0.5)
    _assert_tree_close(tl.target_params, jax.device_get(jl.target_params),
                       floor=1e-30)


def test_module_recurrence_carries_information():
    """q_seq from stored state differs from zero state — the stored-state
    replay mechanic is live (``tests/test_rllib_r2d2.py``'s case)."""
    spec = tr2d2.R2D2ModuleSpec(obs_dim=2, action_dim=2)
    m = spec.build()
    params = m.init(torch.Generator().manual_seed(0))
    obs_seq = torch.zeros((4, 3, 2))
    zero_state = m.initial_state(3)
    warm_state = tuple(s + 0.7 for s in zero_state)
    q0, _ = m.q_seq(params, obs_seq, zero_state)
    q1, _ = m.q_seq(params, obs_seq, warm_state)
    assert not np.allclose(q0.numpy(), q1.numpy())


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def _memory_env():
    """``tests/test_rllib_r2d2.py``'s MemoryEnv: a cue of +-1 shown only at
    t=0, the right final action (0 for -1, 1 for +1) gives +1, the wrong
    one -1. A memoryless policy is blind at decision time (expected return
    0); recurrent state is the only path to the +1."""
    import gymnasium as gym

    class MemoryEnv(gym.Env):
        HORIZON = 3

        def __init__(self, config=None):
            self.observation_space = gym.spaces.Box(-1.0, 1.0, (2,),
                                                    np.float32)
            self.action_space = gym.spaces.Discrete(2)
            self._rng = np.random.default_rng(0)
            self._cue = 1
            self._t = 0

        def _obs(self):
            cue = float(self._cue) if self._t == 0 else 0.0
            go = 1.0 if self._t == self.HORIZON - 1 else 0.0
            return np.array([cue, go], np.float32)

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._rng = np.random.default_rng(seed)
            self._cue = 1 if self._rng.random() < 0.5 else -1
            self._t = 0
            return self._obs(), {}

        def step(self, action):
            done = self._t == self.HORIZON - 1
            reward = 0.0
            if done:
                want = 1 if self._cue > 0 else 0
                reward = 1.0 if int(action) == want else -1.0
            self._t += 1
            return self._obs(), reward, done, False, {}

    return MemoryEnv


def test_r2d2_learns_memory_task(port_cluster):
    from ray_tpu_torch.rllib import R2D2Config

    config = (R2D2Config()
              .environment(env=_memory_env())
              .env_runners(num_env_runners=1, num_envs_per_env_runner=8,
                           rollout_fragment_length=12)
              .training(lr=1e-3, train_batch_size=16, gamma=0.97,
                        burn_in=3)
              .learners(device="cpu"))
    config.epsilon = [(0, 1.0), (3000, 0.05)]
    config.target_network_update_freq = 200
    config.num_steps_sampled_before_learning_starts = 200
    algo = config.build()
    try:
        best = -np.inf
        for _ in range(60):
            result = algo.train()
            value = result.get("episode_return_mean")
            if value is not None and np.isfinite(value):
                best = max(best, value)
            if best >= 0.5:
                break
        # memoryless ceiling is 0.0; only recurrence clears 0.5
        assert best >= 0.5, best
    finally:
        algo.stop()


def test_server_feeds_dqn_learner():
    """Transitions from external clients train a DQN learner with no
    adapter — the off-policy batch layouts match
    (``tests/test_rllib_r2d2.py``'s case)."""
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import (
        DQNLearner, DQNModuleSpec)
    from ray_tpu_torch.rllib.env.policy_client import PolicyClient
    from ray_tpu_torch.rllib.env.policy_server_input import (
        PolicyServerInput)

    spec = DQNModuleSpec(obs_dim=2, action_dim=2)
    server = PolicyServerInput(spec, seed=1)
    learner = DQNLearner(spec, {"lr": 1e-3, "seed": 0}, use_mesh=False,
                         device="cpu")
    try:
        server.set_weights(learner.get_weights())

        def drive():
            client = PolicyClient(server.address)
            rng = np.random.default_rng(0)
            for _ in range(4):
                eid = client.start_episode()
                obs = rng.normal(size=2).astype(np.float32)
                for t in range(5):
                    client.get_action(eid, obs)
                    client.log_returns(eid, float(rng.random()))
                    obs = rng.normal(size=2).astype(np.float32)
                client.end_episode(eid, obs)

        t = threading.Thread(target=drive)
        t.start()
        batch = server.sample(learner.get_weights(),
                              min_transitions=20, timeout=60)
        t.join(timeout=30)
        flat = lambda a: np.asarray(a).reshape(
            (-1,) + np.asarray(a).shape[2:])
        out = learner.update({
            "obs": flat(batch["obs"]),
            "actions": flat(batch["actions"]).astype(np.int64),
            "rewards": flat(batch["rewards"]),
            "next_obs": flat(batch["next_obs"]),
            "dones": flat(batch["dones"]),
        })
        assert np.isfinite(out["total_loss"])
    finally:
        server.stop()
