"""The port's DreamerV3 against the JAX package's, on the CPU: the symlog,
twohot and ``dist_mean`` helpers, the module's recurrent exploration step
with fed Gumbel draws, one full learner update (the RSSM over the
sequence, the imagination rollout, the λ-returns, the percentile scale,
the clipped Adam step and the slow critic's EMA) with JAX's own draws,
and the learner's state round trip; and the reference's
``test_dreamer_symlog_twohot_roundtrip`` (``tests/test_rllib_breadth.py``).
Its ``test_dreamerv3_learns_chain`` is in
``tests/test_torch_rllib_dreamer_learning.py``.

Weights go from JAX to the port through ``rl_params_from_jax``. A
categorical sample is ``argmax(logits + gumbel)`` in both packages; the
test draws the Gumbel arrays from the JAX learner's key, split as its
update splits it, and feeds them to the port's update as ``draws``.
Tolerances: the helpers and one exploration step 1e-5 relative; one
update's metrics 1e-4 relative (to the value, or to 0.1 where it is
smaller; a chain of 26 fp32 steps), the slow critic and the return scale
1e-4, and each param leaf's distance from JAX's within 1e-3 of its
update's norm."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.rllib.algorithms.dreamerv3 import dreamerv3 as jdv  # noqa: E402
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (  # noqa: E402
    dreamerv3 as tdv)
from ray_tpu_torch.rllib.core.rl_module import rl_params_from_jax  # noqa: E402
from tests.test_torch_rllib_core import (  # noqa: E402
    _named, _rel_max, _update_close)

TOL, TOL_UPDATE = 1e-5, 1e-4
SPEC = dict(obs_dim=6, action_dim=3, deter=32, stoch=4, classes=4,
            hidden=32, num_bins=41)
CONFIG = {"lr": 4e-4, "seed": 0, "gamma": 0.997, "lambda_": 0.95,
          "imagine_horizon": 5, "free_bits": 1.0, "dyn_scale": 0.5,
          "rep_scale": 0.1, "entropy_scale": 3e-3, "slow_critic_tau": 0.02}
B, L = 3, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_port(tree):
    return rl_params_from_jax(jax.device_get(tree))


def _close(got, want, tol):
    return abs(got - want) <= tol * max(abs(want), 0.1)


# --------------------------------------------------------------- helpers

def test_helpers_match_jax():
    x = np.random.default_rng(0).normal(scale=30.0, size=(5, 7)).astype(
        np.float32)
    x[0, :3] = [0.0, -250.0, 1e4]   # zero, and past the last bin
    tx = torch.from_numpy(x)
    assert _rel_max(tdv.symlog(tx), jdv.symlog(x)) < TOL
    assert _rel_max(tdv.symexp(tdv.symlog(tx)),
                    jdv.symexp(jdv.symlog(x))) < TOL
    jbins, tbins = jdv.make_bins(41), tdv.make_bins(41)
    assert _rel_max(tbins, jbins) < TOL
    got = tdv.twohot(tdv.symlog(tx), tbins)
    want = jdv.twohot(jdv.symlog(x), jbins)
    assert got.shape == want.shape == (5, 7, 41)
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
    logits = np.random.default_rng(1).normal(size=(4, 41)).astype(
        np.float32)
    assert _rel_max(tdv.dist_mean(torch.from_numpy(logits), tbins),
                    jdv.dist_mean(logits, jbins)) < TOL


def test_dreamer_symlog_twohot_roundtrip():
    """Distributional plumbing invariants: symexp(symlog(x)) == x and
    twohot projection preserves the scalar under the bin expectation."""
    from ray_tpu_torch.rllib.algorithms.dreamerv3.dreamerv3 import (
        dist_mean, make_bins, symexp, symlog, twohot)

    x = torch.tensor([-100.0, -1.5, 0.0, 0.3, 7.0, 250.0])
    np.testing.assert_allclose(symexp(symlog(x)), x, rtol=1e-5, atol=1e-5)
    bins = make_bins(41)
    probs = twohot(symlog(x), bins)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    # expectation under the twohot distribution recovers the input
    recovered = symexp(torch.sum(probs * bins, -1))
    np.testing.assert_allclose(recovered.numpy(), x.numpy(),
                               rtol=1e-2, atol=1e-2)
    # a delta distribution's mean is its bin's value
    delta_logits = torch.where(torch.arange(41) == 20, 50.0, -50.0)
    assert abs(float(dist_mean(delta_logits, bins))
               - float(bins[20])) < 1e-4


# ---------------------------------------------------------------- module

def _modules(seed=0):
    jm = jdv.DreamerModuleSpec(**SPEC).build()
    tm = tdv.DreamerModuleSpec(**SPEC).build()
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, to_port(jp)


def test_module_forward_and_explore_step_match_jax():
    jm, tm, jp, tp = _modules()
    assert _named(tp).keys() == _named(jax.device_get(jp)).keys()
    rng = np.random.default_rng(2)
    n = 5
    obs = rng.normal(size=(n, SPEC["obs_dim"])).astype(np.float32)
    want, got = jm.forward(jp, obs), tm.forward(tp, torch.from_numpy(obs))
    for k in ("logits", "vf"):
        assert _rel_max(got[k], want[k]) < TOL, k
    # a carried state: h, a straight-through z, the previous action
    state = (rng.normal(size=(n, SPEC["deter"])).astype(np.float32),
             np.eye(SPEC["classes"], dtype=np.float32)[rng.integers(
                 0, SPEC["classes"], (n, SPEC["stoch"]))].reshape(n, -1),
             np.eye(SPEC["action_dim"], dtype=np.float32)[rng.integers(
                 0, SPEC["action_dim"], n)])
    key = jax.random.key(7)
    a, logp, vf, (h, z, onehot) = jm.explore_action_recurrent(
        jp, obs, state, key)
    k1, k2 = jax.random.split(key)
    draws = {"z": torch.from_numpy(np.array(jax.random.gumbel(
                 k1, (n, SPEC["stoch"], SPEC["classes"])))),
             "a": torch.from_numpy(np.array(jax.random.gumbel(
                 k2, (n, SPEC["action_dim"]))))}
    ta, tlogp, tvf, (th, tz, tone) = tm.explore_action_recurrent(
        tp, torch.from_numpy(obs), tuple(map(torch.from_numpy, state)),
        None, draws=draws)
    assert np.array_equal(ta.numpy(), np.asarray(a))
    assert np.array_equal(tone.numpy(), np.asarray(onehot))
    for g, w in ((tlogp, logp), (tvf, vf), (th, h), (tz, z)):
        assert _rel_max(g, w) < TOL
    # the runner's path: the draws come from its generator, the same twice
    gen_a = torch.Generator().manual_seed(3)
    gen_b = torch.Generator().manual_seed(3)
    st = tuple(map(torch.from_numpy, state))
    out_a = tm.explore_action_recurrent(tp, torch.from_numpy(obs), st, gen_a)
    out_b = tm.explore_action_recurrent(tp, torch.from_numpy(obs), st, gen_b)
    assert torch.equal(out_a[0], out_b[0])
    assert [s.shape for s in tm.initial_state(n)] == \
        [s.shape for s in jm.initial_state(n)]


# --------------------------------------------------------------- learner

def _sequence_batch(seed):
    rng = np.random.default_rng(seed)
    dones = (rng.random((B, L)) < 0.15).astype(np.float32)
    is_first = np.zeros((B, L), np.float32)
    is_first[:, 0] = 1.0
    is_first[:, 1:] = dones[:, :-1]
    return {
        "obs": rng.normal(size=(B, L, SPEC["obs_dim"])).astype(np.float32),
        "actions": rng.integers(0, SPEC["action_dim"], (B, L)).astype(
            np.int64),
        "rewards": rng.normal(scale=2.0, size=(B, L)).astype(np.float32),
        "dones": dones, "is_first": is_first}


def jax_draws(jl, batch_size, length):
    """The Gumbel draws JAX's update takes from ``jl._rng``: its key split
    in ``update``, then in ``_wm_and_img`` for the RSSM scan's step keys
    and the imagination scan's (each split into the action's key and the
    latent's)."""
    s, H = jl.module.spec, jl.config["imagine_horizon"]
    n = batch_size * length
    _, key = jax.random.split(jl._rng)
    rng, scan_key = jax.random.split(key)
    post = [jax.random.gumbel(k, (batch_size, s.stoch, s.classes))
            for k in jax.random.split(scan_key, length)]
    _, img_key = jax.random.split(rng)
    img_a, img_z = [], []
    for k in jax.random.split(img_key, H):
        ka, kz = jax.random.split(k)
        img_a.append(jax.random.gumbel(ka, (n, s.action_dim)))
        img_z.append(jax.random.gumbel(kz, (n, s.stoch, s.classes)))
    return {"post": np.stack(post), "img_a": np.stack(img_a),
            "img_z": np.stack(img_z)}


def _learner_pair():
    jl = jdv.DreamerLearner(jdv.DreamerModuleSpec(**SPEC), dict(CONFIG))
    # a slow critic that differs from the critic, and a return scale off 1
    rng = np.random.default_rng(5)
    jl.slow_critic = jax.tree.map(lambda t: t + jnp.asarray(
        0.05 * rng.normal(size=np.shape(t)), jnp.float32), jl.slow_critic)
    jl.ret_scale = jnp.asarray(1.7, jnp.float32)
    tl = tdv.DreamerLearner(tdv.DreamerModuleSpec(**SPEC), dict(CONFIG),
                            device="cpu")
    tl.set_weights(to_port(jl.params))
    tdv.load_tree(tl.slow_critic, to_port(jl.slow_critic))
    tl.ret_scale = torch.tensor(1.7)
    return jl, tl


def test_learner_update_matches_jax():
    jl, tl = _learner_pair()
    for step, seed in enumerate((11, 12)):
        batch = _sequence_batch(seed)
        draws = jax_draws(jl, B, L)
        init = jax.device_get(jl.params)
        want = jl.update(batch)
        got = tl.update(batch, draws=draws)
        assert got.keys() == want.keys()
        for k, w in want.items():
            assert _close(got[k], w, TOL_UPDATE), (step, k, got[k], w)
        _update_close(tl.get_weights(), jax.device_get(jl.params), init)
        assert _rel_max(tl.ret_scale, jl.ret_scale) < TOL_UPDATE
        for name, w in _named(jax.device_get(jl.slow_critic)).items():
            assert _rel_max(_named(tl.slow_critic)[name], w, 1e-2) < \
                TOL_UPDATE, name
    # the return scale moved by its EMA, and the metrics say so
    assert got["return_scale"] == pytest.approx(tl.ret_scale.item())


def test_learner_draws_layout_and_state_round_trip():
    tl = tdv.DreamerLearner(tdv.DreamerModuleSpec(**SPEC), dict(CONFIG),
                            device="cpu")
    d = tl.draws(B, L)
    H, n = CONFIG["imagine_horizon"], B * L
    assert d["post"].shape == (L, B, SPEC["stoch"], SPEC["classes"])
    assert d["img_a"].shape == (H, n, SPEC["action_dim"])
    assert d["img_z"].shape == (H, n, SPEC["stoch"], SPEC["classes"])
    batch = _sequence_batch(3)
    tl.update(batch)
    state = tl.get_state()
    twin = tdv.DreamerLearner(tdv.DreamerModuleSpec(**SPEC),
                              dict(CONFIG, seed=9), device="cpu")
    twin.set_state(state)
    assert twin.ret_scale.item() == tl.ret_scale.item() != 1.0
    draws = tl.draws(B, L)
    got = twin.update(batch, draws=draws)
    want = tl.update(batch, draws=draws)
    assert got == want
    for a, b in zip(_named(twin.get_state()).values(),
                    _named(tl.get_state()).values()):
        assert np.array_equal(a, b)


def test_imagined_returns_are_in_bin_units():
    """The reference's fault, kept by the port: the twohot bins are
    symexp-spaced (up to e^20) while the reward and value targets are
    symlog values, so an untrained head's ``dist_mean`` is dominated by
    the outer bins and the imagined returns are orders of magnitude
    outside any return the batch can give; both packages agree on them."""
    jl, tl = _learner_pair()
    batch = _sequence_batch(21)
    draws = jax_draws(jl, B, L)
    want, got = jl.update(batch), tl.update(batch, draws=draws)
    bound = np.abs(batch["rewards"]).max() * CONFIG["imagine_horizon"]
    assert abs(want["imagined_return_mean"]) > 1e3 * bound
    assert _close(got["imagined_return_mean"],
                  want["imagined_return_mean"], TOL_UPDATE)
