"""The port's RLlib utilities against the JAX package's, with no runtime:
V-trace, GAE, the replay buffers, the connectors, offline JSON IO and the
off-policy estimators, the port's vector env against gymnasium's
``SyncVectorEnv``, ``chip_smoke.py``'s numpy CartPole against gymnasium's
``CartPole-v1``, and the policy server driven by a ``PolicyClient`` over
HTTP on 127.0.0.1 (``tests/test_rllib_r2d2.py``'s external-process case).

``vtrace`` is ported (tensors, a reverse loop over T): it is held against
JAX's ``lax.scan`` on the same random inputs at 1e-6 of the largest entry,
and on the reference's two cases. The rest are copies of numpy modules:
the reference's unit cases re-run on the port, and the estimators give
JAX's numbers on the same episodes. The vector env and the CartPole must
be bit-equal to gymnasium's over a fixed action sequence that crosses
several autoresets."""

import os
import subprocess
import sys
import textwrap
import threading

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import gymnasium as gym  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from ray_tpu.rllib import offline as joffline  # noqa: E402
from ray_tpu.rllib.utils.vtrace import vtrace as jvtrace  # noqa: E402
from ray_tpu_torch.rllib import offline  # noqa: E402
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec  # noqa: E402
from ray_tpu_torch.rllib.connectors import (  # noqa: E402
    ActionClip, ConnectorPipeline, FlattenObs, FrameStack, NormalizeObs)
from ray_tpu_torch.rllib.env.policy_client import PolicyClient  # noqa: E402
from ray_tpu_torch.rllib.env.policy_server_input import (  # noqa: E402
    PolicyServerInput)
from ray_tpu_torch.rllib.env.vector import SyncVectorEnv  # noqa: E402
from ray_tpu_torch.rllib.utils.gae import compute_gae  # noqa: E402
from ray_tpu_torch.rllib.utils.replay_buffer import (  # noqa: E402
    PrioritizedReplayBuffer, ReplayBuffer)
from ray_tpu_torch.rllib.utils.schedules import (  # noqa: E402
    piecewise_linear)
from ray_tpu_torch.rllib.utils.vtrace import vtrace  # noqa: E402

TOL_VTRACE = 1e-6


def _rel_max(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------------------ vtrace

@pytest.mark.parametrize("clip", [(1.0, 1.0), (0.5, 2.0)],
                         ids=["rho1_c1", "rho0.5_c2"])
def test_vtrace_matches_jax(clip):
    """Random (T, B) inputs with episode ends inside, and ratios above both
    clips (log-ratios up to +-2)."""
    T, B = 24, 5
    rng = np.random.default_rng(0)
    behavior = rng.normal(size=(T, B)).astype(np.float32)
    target = (behavior + rng.uniform(-2, 2, (T, B))).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    dones = (rng.random((T, B)) < 0.15).astype(np.float32)
    bootstrap = rng.normal(size=B).astype(np.float32)
    args = (behavior, target, rewards, values, dones, bootstrap)
    ratio = np.exp(target - behavior)
    assert (ratio > max(clip)).any() and dones.any()
    kw = dict(gamma=0.97, clip_rho=clip[0], clip_c=clip[1])
    want = jvtrace(*(jnp.asarray(a) for a in args), **kw)
    got = vtrace(*(torch.from_numpy(a) for a in args), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel_max(g, w) < TOL_VTRACE


def test_vtrace_cuts_the_gradient():
    values = torch.randn(4, 2, requires_grad=True)
    zeros = torch.zeros(4, 2)
    vs, adv = vtrace(zeros, zeros, torch.ones(4, 2), values, zeros,
                     torch.zeros(2))
    assert not vs.requires_grad and not adv.requires_grad


def test_vtrace_on_policy_reduces_to_td_lambda_targets():
    """``tests/test_rllib.py``'s case on the port: with target == behavior
    (rho = c = 1), vs equals the lambda=1 TD targets."""
    T, B = 4, 2
    rng = np.random.default_rng(0)
    logp = torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32))
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32))
    dones = torch.zeros((T, B))
    bootstrap = rng.normal(size=(B,)).astype(np.float32)
    vs, _ = vtrace(logp, logp, torch.from_numpy(rewards), values, dones,
                   torch.from_numpy(bootstrap), gamma=0.9)
    expect = np.zeros((T + 1, B), np.float32)
    expect[T] = bootstrap
    for t in reversed(range(T)):
        expect[t] = rewards[t] + 0.9 * expect[t + 1]
    np.testing.assert_allclose(vs.numpy(), expect[:T], rtol=1e-5)


def test_vtrace_clips_large_ratios():
    """``tests/test_rllib.py``'s case on the port."""
    T, B = 3, 1
    behavior = torch.zeros((T, B))
    target = torch.full((T, B), 5.0)  # huge ratio, must clip to 1
    rewards = torch.ones((T, B))
    values = torch.zeros((T, B))
    dones = torch.zeros((T, B))
    vs_clipped, _ = vtrace(behavior, target, rewards, values, dones,
                           torch.zeros(B), gamma=0.9, clip_rho=1.0,
                           clip_c=1.0)
    vs_unit, _ = vtrace(behavior, behavior, rewards, values, dones,
                        torch.zeros(B), gamma=0.9)
    np.testing.assert_allclose(vs_clipped.numpy(), vs_unit.numpy(),
                               rtol=1e-5)


# ---------------------------------------------- GAE, replay, schedules

def test_gae_matches_manual():
    """``tests/test_rllib.py``'s case on the port."""
    rewards = np.array([[1.0], [1.0], [1.0]], np.float32)
    values = np.array([[0.5], [0.5], [0.5]], np.float32)
    dones = np.zeros((3, 1), np.float32)
    last_v = np.array([0.5], np.float32)
    adv, vt = compute_gae(rewards, values, dones, last_v,
                          gamma=0.9, lam=1.0)
    # delta_t = 1 + 0.9*0.5 - 0.5 = 0.95; lam=1 => discounted sums
    assert adv[2, 0] == pytest.approx(0.95)
    assert adv[1, 0] == pytest.approx(0.95 + 0.9 * 0.95)
    assert vt[0, 0] == pytest.approx(adv[0, 0] + 0.5)


def test_gae_cuts_at_done():
    """``tests/test_rllib.py``'s case on the port."""
    rewards = np.ones((4, 1), np.float32)
    values = np.zeros((4, 1), np.float32)
    dones = np.array([[0.0], [1.0], [0.0], [0.0]], np.float32)
    adv, _ = compute_gae(rewards, values, dones, np.zeros(1, np.float32),
                         gamma=0.9, lam=1.0)
    assert adv[1, 0] == pytest.approx(1.0)
    assert adv[0, 0] == pytest.approx(1.0 + 0.9 * 1.0)


def test_replay_buffer_wraps_and_samples():
    """``tests/test_rllib.py``'s case on the port."""
    buf = ReplayBuffer(capacity=10, seed=0)
    for start in range(0, 25, 5):
        buf.add_batch({"x": np.arange(start, start + 5, dtype=np.int64)})
    assert len(buf) == 10
    sample = buf.sample(32)
    assert sample["x"].min() >= 15  # oldest entries overwritten


def test_prioritized_replay_prefers_high_priority():
    """``tests/test_rllib.py``'s case on the port."""
    buf = PrioritizedReplayBuffer(capacity=100, alpha=1.0, seed=0)
    buf.add_batch({"x": np.arange(100, dtype=np.int64)})
    prios = np.full(100, 1e-6)
    prios[7] = 1000.0
    buf.update_priorities(np.arange(100), prios)
    sample = buf.sample(64)
    assert (sample["x"] == 7).mean() > 0.9
    assert "weights" in sample and "batch_indexes" in sample


def test_piecewise_schedule_honours_midpoints():
    schedule = [(0, 1.0), (1000, 0.1), (10000, 0.05)]
    assert piecewise_linear(schedule, 500) == pytest.approx(0.55)
    assert piecewise_linear(schedule, 5500) == pytest.approx(0.075)
    assert piecewise_linear(schedule, 20000) == 0.05


# --------------------------------------------------------------- connectors

def test_normalize_obs_converges_to_unit_scale():
    """``tests/test_rllib_connectors.py``'s case on the port."""
    c = NormalizeObs()
    rng = np.random.default_rng(0)
    out = None
    for _ in range(50):
        out = c.on_obs(rng.normal(5.0, 3.0, size=(32, 4)))
    assert abs(float(out.mean())) < 0.5
    assert 0.5 < float(out.std()) < 2.0
    c2 = NormalizeObs()
    c2.set_state(c.state())
    x = rng.normal(5.0, 3.0, size=(8, 4))
    np.testing.assert_allclose(c.on_obs(x), c2.on_obs(x), rtol=1e-3)


def test_frame_stack_widens_features():
    """``tests/test_rllib_connectors.py``'s case on the port."""
    c = FrameStack(k=3)
    c.on_episode_start()
    o1 = c.on_obs(np.ones((2, 4)))
    assert o1.shape == (2, 12)
    assert (o1[:, :8] == 0).all()  # zero-padded history
    c.on_obs(2 * np.ones((2, 4)))
    o3 = c.on_obs(3 * np.ones((2, 4)))
    assert (o3[:, :4] == 1).all() and (o3[:, 8:] == 3).all()


def test_pipeline_order_and_action_reverse():
    """``tests/test_rllib_connectors.py``'s case on the port."""
    calls = []

    class A(ActionClip):
        def on_action(self, action):
            calls.append("A")
            return super().on_action(action)

    class B(ActionClip):
        def on_action(self, action):
            calls.append("B")
            return super().on_action(action)

    pipe = ConnectorPipeline([A(), B()])
    pipe.on_action(np.asarray([2.5]))
    assert calls == ["B", "A"]  # reverse order on the action path
    assert pipe.obs_multiplier == 1
    assert ConnectorPipeline([FrameStack(4)]).obs_multiplier == 4
    flat = FlattenObs().on_obs(np.ones((2, 3, 5)))
    assert flat.shape == (2, 15)


# ------------------------------------------------------------------ offline

def test_json_offline_io_roundtrip(tmp_path):
    """``tests/test_rllib.py``'s case on the port."""
    w = offline.JsonWriter(str(tmp_path))
    for i in range(3):
        w.write({"obs": np.random.rand(10, 4).astype(np.float32),
                 "actions": np.full(10, i, np.int64)})
    w.close()
    r = offline.JsonReader(str(tmp_path))
    full = r.concat_all()
    assert full["obs"].shape == (30, 4)
    assert sorted(set(full["actions"])) == [0, 1, 2]
    sample = r.sample(16)
    assert sample["obs"].shape == (16, 4)


def test_json_files_read_by_the_jax_package(tmp_path):
    """What the port writes, the JAX package reads row for row."""
    rng = np.random.default_rng(3)
    rows = [{"obs": rng.normal(size=(6, 3)).astype(np.float32),
             "actions": rng.integers(0, 4, 6).astype(np.int64)}
            for _ in range(2)]
    w = offline.JsonWriter(str(tmp_path))
    for r in rows:
        w.write(r)
    w.close()
    got = joffline.JsonReader(str(tmp_path)).concat_all()
    for k in ("obs", "actions"):
        np.testing.assert_array_equal(
            got[k], np.concatenate([r[k] for r in rows]))
        assert got[k].dtype == rows[0][k].dtype


def _episodes(seed, boost):
    rng = np.random.default_rng(seed)
    eps = []
    for _ in range(12):
        T = int(rng.integers(3, 9))
        rewards = rng.random(T)
        logp = np.log(rng.uniform(0.2, 0.9, T))
        eps.append({"rewards": rewards, "logp": logp,
                    "target_logp": logp + boost * (rewards - 0.5),
                    "v0": float(rng.normal()),
                    "values": rng.normal(size=T),
                    "q_values": rng.normal(size=T)})
    return eps


@pytest.mark.parametrize("name", ["ImportanceSampling",
                                  "WeightedImportanceSampling",
                                  "DirectMethod", "DoublyRobust"])
def test_estimators_match_jax(name):
    """The port's estimators give the JAX package's numbers on the same
    episodes, on-policy and off-policy."""
    for boost in (0.0, 0.8):
        eps = _episodes(4, boost)
        kw = {} if name == "DirectMethod" else {"gamma": 0.95}
        got = getattr(offline, name)(**kw).estimate(eps)
        want = getattr(joffline, name)(**kw).estimate(eps)
        assert got == want


# --------------------------------------------------------------- vector env

def _actions(space, n_envs, steps, seed):
    rng = np.random.default_rng(seed)
    if hasattr(space, "n"):
        return rng.integers(0, space.n, (steps, n_envs)).astype(np.int64)
    return rng.uniform(space.low, space.high,
                       (steps, n_envs) + space.shape).astype(space.dtype)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1"])
def test_vector_env_matches_gymnasium(env_id):
    """4 envs, 600 fixed actions: obs, rewards, terminated and truncated
    bit-equal to ``gymnasium.vector.SyncVectorEnv``, through several
    autoresets (CartPole's episodes end by falling, Pendulum's by its
    200-step limit)."""
    n, steps = 4, 600
    ours = SyncVectorEnv([lambda: gym.make(env_id) for _ in range(n)])
    ref = gym.vector.SyncVectorEnv([lambda: gym.make(env_id)
                                    for _ in range(n)])
    try:
        assert ours.num_envs == n
        assert ours.single_action_space == ref.single_action_space
        o1, _ = ours.reset(seed=11)
        o2, _ = ref.reset(seed=11)
        assert o1.dtype == o2.dtype and np.array_equal(o1, o2)
        ends = 0
        for a in _actions(ref.single_action_space, n, steps, 5):
            got, want = ours.step(a), ref.step(a)
            for g, w in zip(got[:4], want[:4]):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert np.array_equal(g, w)
            ends += int(np.logical_or(want[2], want[3]).sum())
        assert ends >= 8
    finally:
        ours.close()
        ref.close()


def test_numpy_cartpole_matches_gymnasium():
    """``chip_smoke.py``'s ``_CartPole`` (the card's env, no gymnasium)
    against ``gymnasium.make("CartPole-v1")`` step for step: 3000 steps of
    one fixed action sequence, reset after every end, then one episode
    that balances until the 500-step truncation; obs, rewards, terminated
    and truncated equal, the spaces' ``n``, ``shape``, ``low`` and
    ``high`` equal."""
    ours, ref = chip_smoke._CartPole(), gym.make("CartPole-v1")
    assert ours.action_space.n == ref.action_space.n
    assert ours.observation_space.shape == ref.observation_space.shape
    for k in ("low", "high"):
        assert np.array_equal(getattr(ours.observation_space, k),
                              getattr(ref.observation_space, k))
    o1, _ = ours.reset(seed=3)
    o2, _ = ref.reset(seed=3)
    assert np.array_equal(o1, o2)
    rng = np.random.default_rng(9)
    ends = 0
    for a in rng.integers(0, 2, 3000):
        got, want = ours.step(int(a)), ref.step(int(a))
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.float32
        assert got[1:4] == want[1:4]
        if want[2] or want[3]:
            ends += 1
            o1, _ = ours.reset()
            o2, _ = ref.reset()
            assert np.array_equal(o1, o2)
    assert ends > 50
    # a pole held up by a controller on theta and its rate: truncation at
    # 500, never terminated
    o1, _ = ours.reset(seed=4)
    ref.reset(seed=4)
    for t in range(500):
        a = int(o1[2] + 0.5 * o1[3] > 0)
        (o1, r1, te1, tr1, _), (o2, r2, te2, tr2, _) = \
            ours.step(a), ref.step(a)
        assert np.array_equal(o1, o2) and (r1, te1, tr1) == (r2, te2, tr2)
    assert (te1, tr1) == (False, True)


def test_numpy_pendulum_matches_gymnasium():
    """``chip_smoke.py``'s ``_Pendulum`` (the card's continuous env, no
    gymnasium) against ``gymnasium.make("Pendulum-v1")`` step for step:
    1000 steps of one fixed torque sequence, some beyond the torque limit,
    reset after every 200-step truncation; obs, rewards (their type too),
    terminated and truncated equal; the spaces' ``shape``, ``low`` and
    ``high`` equal."""
    ours, ref = chip_smoke._Pendulum(), gym.make("Pendulum-v1")
    for space in ("observation_space", "action_space"):
        assert getattr(ours, space).shape == getattr(ref, space).shape
        for k in ("low", "high"):
            assert np.array_equal(getattr(getattr(ours, space), k),
                                  getattr(getattr(ref, space), k))
    o1, _ = ours.reset(seed=3)
    o2, _ = ref.reset(seed=3)
    assert np.array_equal(o1, o2)
    rng = np.random.default_rng(9)
    ends = 0
    for a in rng.uniform(-2.5, 2.5, (1000, 1)).astype(np.float32):
        got, want = ours.step(a), ref.step(a)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.float32
        assert got[1] == want[1] and type(got[1]) is type(want[1])
        assert got[2:4] == want[2:4]
        if want[2] or want[3]:
            assert (want[2], want[3]) == (False, True)
            ends += 1
            o1, _ = ours.reset()
            o2, _ = ref.reset()
            assert np.array_equal(o1, o2)
    assert ends == 5


# ------------------------------------------------------------ policy server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_external_process_drives_env():
    """``tests/test_rllib_r2d2.py``'s case on the port: a separate python
    process owns the env loop and talks to the server only over HTTP; the
    server's ``sample`` gives the transitions in the runners' layout."""
    spec = RLModuleSpec(obs_dim=2, action_dim=2, discrete=True)
    server = PolicyServerInput(spec, seed=0)
    try:
        weights = spec.build().init(torch.Generator().manual_seed(0))
        server.set_weights(weights)
        script = textwrap.dedent(f"""
            import numpy as np
            from ray_tpu_torch.rllib.env.policy_client import PolicyClient

            client = PolicyClient("{server.address}")
            for ep in range(3):
                eid = client.start_episode()
                obs = np.array([1.0, 0.0], np.float32)
                for t in range(4):
                    action = client.get_action(eid, obs)
                    assert action in (0, 1), action
                    client.log_returns(eid, 0.25)
                    obs = np.array([0.0, float(t == 2)], np.float32)
                client.end_episode(eid, obs)
            print("CLIENT_OK")
        """)
        proc = subprocess.run(
            [sys.executable, "-c", script], capture_output=True, text=True,
            timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stderr
        assert "CLIENT_OK" in proc.stdout
        batch = server.sample(weights, min_transitions=12, timeout=10)
        assert batch["env_steps"] == 12       # 3 eps x 4 transitions
        assert batch["obs"].shape == (1, 12, 2)
        assert batch["next_obs"].shape == (1, 12, 2)
        assert batch["dones"].sum() == 3
        np.testing.assert_allclose(batch["rewards"], np.full((1, 12), 0.25))
        assert len(batch["episodes"]) == 3
        assert batch["episodes"][0]["episode_return"] == pytest.approx(1.0)
    finally:
        server.stop()


def test_policy_server_draws_from_its_seeded_generator():
    """Two servers with the same seed and weights answer the same obs
    sequence with the same actions (one generator stream a server)."""
    spec = RLModuleSpec(obs_dim=2, action_dim=3, discrete=True)
    weights = spec.build().init(torch.Generator().manual_seed(1))
    obs = np.random.default_rng(2).normal(size=(40, 2)).astype(np.float32)
    answers = []
    for _ in range(2):
        server = PolicyServerInput(spec, seed=5)
        server.set_weights(weights)
        got = []

        def drive():
            client = PolicyClient(server.address)
            eid = client.start_episode()
            for o in obs:
                got.append(client.get_action(eid, o))
                client.log_returns(eid, 1.0)
            client.end_episode(eid, obs[-1])

        try:
            t = threading.Thread(target=drive)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
            batch = server.sample(weights, min_transitions=40, timeout=10)
            np.testing.assert_array_equal(batch["actions"][0], got)
        finally:
            server.stop()
        answers.append(got)
    assert answers[0] == answers[1] and len(set(answers[0])) > 1
