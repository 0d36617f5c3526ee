"""The port's RL core (RL modules, the catalog, PPOLearner, clip_adam, the
learner group) against the JAX package's, on the CPU.

Weights go from JAX to the port through ``rl_params_from_jax`` (the
learners' ``set_weights``), batches are drawn with numpy from a seed, and
both packages get the same ones. Tolerances (fp32 on both sides, the same
formulas summed in other orders): distributions, module outputs, the loss
and its metrics 1e-5 (relative to the largest entry, or to the value);
grads 1e-5 of each leaf's largest entry, or of 1e-2 where that is
smaller, and a scalar 1e-5 of its size, or of 0.1: the policy loss is the
mean of terms of the advantages' size (~1) that nearly cancel (to ~3e-4),
and the value head's bias grad the mean of (vf - target) terms of size ~1
that cancel to ~8e-4, so their rounding error is that of their terms, not
of their sum. After an update the params are
compared by each leaf's distance from JAX's against the norm of its update
(1e-3): Adam's first step is lr · m̂ / (√v̂ + eps), about lr · sign(g) for
every entry, so an entry whose gradient is near 0 turns the two sides'
last-digit differences into steps of other sizes or signs; what is held is
that the update as a whole is JAX's.

The data mesh: the port's learner on 4 gloo ranks (``use_mesh=True`` with a
process group of 4), JAX's on the conftest's 8 virtual devices; the
advantages are standardised over the whole minibatch on both, so the two
agree though their meshes differ. The learner group: 2 remote learners on
the port's runtime, each on half of a batch whose halves have the same
advantages (so that each half's standardisation is the whole batch's),
equal one local learner on the whole."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib.core import rl_module as jrm  # noqa: E402
from ray_tpu.rllib.core.learner import PPOLearner as JPPO  # noqa: E402
from ray_tpu.rllib.models import catalog as jcat  # noqa: E402
from ray_tpu_torch.parallel.optim import clip_adam  # noqa: E402
from ray_tpu_torch.rllib.core import rl_module as trm  # noqa: E402
from ray_tpu_torch.rllib.core.learner import PPOLearner  # noqa: E402
from ray_tpu_torch.rllib.core.learner_group import LearnerGroup  # noqa: E402
from ray_tpu_torch.rllib.models import catalog as tcat  # noqa: E402
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

TOL, UPDATE_REL = 1e-5, 1e-3
SPEC = dict(obs_dim=8, action_dim=4)
CONFIG = {"lr": 3e-4, "num_epochs": 1, "seed": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _named(tree, prefix=""):
    """{'pi.0.w': array} of nested dicts and lists (tensors as numpy)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().numpy()
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}{k}."))
    return out


def _rel_max(got, want, floor=1e-30):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), floor)


def _assert_tree_close(got, want, tol=TOL, floor=1e-2):
    got, want = _named(got), _named(want)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert _rel_max(got[name], w, floor) <= tol, name


def _close(got, want):
    return abs(got - want) <= TOL * max(abs(want), 0.1)


def _update_close(got, want, init):
    got, want, init = _named(got), _named(want), _named(init)
    for name, w in want.items():
        assert np.linalg.norm(got[name] - w) <= \
            UPDATE_REL * np.linalg.norm(w - init[name]), name


def _batch(B, seed=0, action_dim=4, obs_dim=8):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, action_dim, B).astype(np.int32),
        "logp": np.full(B, -1.3, np.float32),
        "advantages": rng.normal(size=B).astype(np.float32),
        "value_targets": rng.normal(size=B).astype(np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _pair(config=CONFIG, spec=SPEC):
    """(JAX learner without a mesh, the port's with JAX's params)."""
    jl = JPPO(jrm.RLModuleSpec(**spec), dict(config), use_mesh=False)
    tl = PPOLearner(trm.RLModuleSpec(**spec), dict(config), device="cpu")
    tl.set_weights(trm.rl_params_from_jax(jax.device_get(jl.params)))
    return jl, tl


# ------------------------------------------------------------ distributions

def test_categorical_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(32, 5)).astype(np.float32) * 3
    actions = rng.integers(0, 5, 32).astype(np.int32)
    assert _rel_max(trm.Categorical.logp(torch.from_numpy(logits),
                                         torch.from_numpy(actions)),
                    jrm.Categorical.logp(logits, actions)) < TOL
    assert _rel_max(trm.Categorical.entropy(torch.from_numpy(logits)),
                    jrm.Categorical.entropy(logits)) < TOL


def test_diag_gaussian_matches_jax():
    """log_std both inside and outside the [-20, 2] clip."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(32, 6)).astype(np.float32)
    logits[:4, 3:] = [[-25.0], [3.0], [2.5], [-21.0]]
    actions = rng.normal(size=(32, 3)).astype(np.float32)
    t = torch.from_numpy(logits)
    assert _rel_max(trm.DiagGaussian.logp(t, torch.from_numpy(actions)),
                    jrm.DiagGaussian.logp(logits, actions)) < TOL
    assert _rel_max(trm.DiagGaussian.entropy(t),
                    jrm.DiagGaussian.entropy(logits)) < TOL


def test_sampling_follows_the_generator_and_the_probabilities():
    logits = torch.tensor([[0.0, 1.0, -1.0, 2.0]]).expand(20000, 4)
    draw = [trm.Categorical.sample(torch.Generator().manual_seed(3), logits)
            for _ in range(2)]
    assert torch.equal(draw[0], draw[1]) and draw[0].shape == (20000,)
    freq = np.bincount(draw[0].numpy(), minlength=4) / 20000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(),
                               atol=0.02)
    g = torch.Generator().manual_seed(4)
    mean_logstd = torch.tensor([[1.0, -2.0, 0.0, -1.0]]).expand(20000, 4)
    a = trm.DiagGaussian.sample(g, mean_logstd)
    assert a.shape == (20000, 2)
    np.testing.assert_allclose(a.mean(0).numpy(), [1.0, -2.0], atol=0.05)
    np.testing.assert_allclose(a.std(0).numpy(), [1.0, np.exp(-1.0)],
                               atol=0.05)


# ------------------------------------------------------- modules, catalog

CATALOG = {
    "mlp": dict(obs_dim=8, action_dim=4),
    "mlp_continuous_relu": dict(obs_dim=5, action_dim=3, discrete=False,
                                activation="relu", hiddens=(32,)),
    "conv": dict(obs_dim=0, action_dim=3, obs_shape=(12, 12, 3)),
    "lstm": dict(obs_dim=6, action_dim=2, use_lstm=True, lstm_cell_size=16,
                 hiddens=(32,)),
}


@pytest.mark.parametrize("name", sorted(CATALOG))
def test_module_forward_matches_jax(name):
    spec = CATALOG[name]
    jmod = jrm.RLModuleSpec(**spec).build()
    tmod = trm.RLModuleSpec(**spec).build()
    assert type(tmod).__name__ == type(jmod).__name__
    params = jax.device_get(jmod.init(jax.random.key(5)))
    tparams = trm.rl_params_from_jax(params)
    rng = np.random.default_rng(6)
    shape = spec.get("obs_shape") or (spec["obs_dim"],)
    obs = rng.normal(size=(7,) + tuple(shape)).astype(np.float32)
    want = jmod.forward(params, obs)
    got = tmod.forward(tparams, torch.from_numpy(obs))
    for k in ("logits", "vf"):
        assert _rel_max(got[k].detach(), want[k]) < TOL, k
    one = tmod.forward(tparams, torch.from_numpy(obs[0]))
    assert one["logits"].shape == want["logits"].shape[1:]
    if name == "lstm":
        seq = rng.normal(size=(5, 3, spec["obs_dim"])).astype(np.float32)
        w_out, (wh, wc) = jmod.forward_recurrent(params, seq,
                                                 jmod.initial_state(3))
        g_out, (gh, gc) = tmod.forward_recurrent(
            tparams, torch.from_numpy(seq), tmod.initial_state(3))
        for k in ("logits", "vf"):
            assert _rel_max(g_out[k], w_out[k]) < TOL, k
        assert _rel_max(gh, wh) < TOL and _rel_max(gc, wc) < TOL


def test_catalog_dispatch_and_errors():
    build = lambda **kw: tcat.get_module_for_space(  # noqa: E731
        trm.RLModuleSpec(**kw))
    assert isinstance(build(obs_dim=3, action_dim=2), trm.MLPModule)
    assert isinstance(build(obs_dim=0, action_dim=2, obs_shape=(40, 40, 1)),
                      tcat.ConvModule)
    assert tcat.default_filters_for((40, 40, 1)) == \
        jcat.default_filters_for((40, 40, 1))
    assert tcat.default_filters_for((6, 6, 1)) == \
        jcat.default_filters_for((6, 6, 1))
    with pytest.raises(ValueError, match="conv\\+lstm"):
        build(obs_dim=0, action_dim=2, obs_shape=(8, 8, 1), use_lstm=True)
    with pytest.raises(ValueError, match="requires obs_shape"):
        build(obs_dim=4, action_dim=2, conv_filters=((4, 2, 1),))
    with pytest.raises(ValueError, match="zero spatial extent"):
        build(obs_dim=0, action_dim=2, obs_shape=(4, 4, 1),
              conv_filters=((8, 5, 1),))


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("max_norm", [0.05, 100.0],
                         ids=["clipped", "unclipped"])
def test_clip_adam_matches_optax(max_norm):
    rng = np.random.default_rng(7)
    params = {"a": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(max_norm), optax.adam(1e-2))
    jp, state = jax.tree.map(jnp.asarray, params), None
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in params.items()}
    opt = clip_adam(1e-2, max_norm)(tp)
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6)


# ---------------------------------------------------------------- learner

def test_ppo_loss_and_metrics_match_jax():
    jl, tl = _pair({**CONFIG, "entropy_coeff": 0.01})
    batch = _batch(32, seed=8)
    loss, metrics = jl.loss(jl.params, jax.tree.map(jnp.asarray, batch))
    tloss, tmetrics = tl.loss(tl.params, tl._batch(batch))
    assert abs(tloss.item() - float(loss)) <= TOL * abs(float(loss))
    assert tmetrics.keys() == metrics.keys()
    for k, v in metrics.items():
        assert _close(tmetrics[k].item(), float(v)), k


@pytest.mark.parametrize("grad_clip", [0.5, 0.01], ids=["clip0.5",
                                                         "clip0.01"])
def test_update_matches_jax(grad_clip):
    """The first minibatch's grads, then one ``update`` (1 epoch, the whole
    batch as one minibatch: one clip + Adam step) from the same params;
    with grad_clip 0.01 the clip scales the grads."""
    cfg = {**CONFIG, "grad_clip": grad_clip}
    jl, tl = _pair(cfg)
    batch = _batch(64, seed=9)
    (_, _), jgrads = jax.value_and_grad(jl.loss, has_aux=True)(
        jl.params, jax.tree.map(jnp.asarray, batch))
    tmetrics = tl.compute_grads(tl._batch(batch))
    from ray_tpu_torch._private.tree import tree_map
    _assert_tree_close(tree_map(lambda p: p.grad, tl.params),
                       jax.device_get(jgrads))
    init = jax.device_get(jl.params)
    want = jl.update(batch)
    got = tl.update(batch)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert _close(got[k], v), k
    assert abs(tmetrics["grad_norm"].item() - want["grad_norm"]) <= \
        TOL * want["grad_norm"]
    if grad_clip == 0.01:
        assert want["grad_norm"] > grad_clip
    _update_close(tl.get_weights(), jax.device_get(jl.params), init)


def test_ppo_learner_moves_policy_toward_advantage():
    """``tests/test_rllib.py::test_ppo_learner_moves_policy_toward_advantage``
    on the port."""
    spec = trm.RLModuleSpec(obs_dim=3, action_dim=2)
    lrn = PPOLearner(spec, {"lr": 0.01, "num_epochs": 10,
                            "minibatch_size": 128}, device="cpu")
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(128, 3)).astype(np.float32)
    # action 0 has positive advantage, action 1 negative (advantages are
    # standardized per minibatch, so they must vary to carry signal)
    actions = (np.arange(128) % 2).astype(np.int64)
    adv = np.where(actions == 0, 1.0, -1.0).astype(np.float32)
    with torch.no_grad():
        out0 = lrn.module.forward(lrn.params, torch.from_numpy(obs))
        logp0 = lrn.module.dist.logp(out0["logits"],
                                     torch.from_numpy(actions))
    batch = {"obs": obs, "actions": actions, "logp": logp0.numpy(),
             "advantages": adv,
             "value_targets": np.zeros(128, np.float32)}
    zeros = torch.zeros(128, dtype=torch.long)
    p0 = float(torch.exp(lrn.module.dist.logp(out0["logits"], zeros)).mean())
    lrn.update(batch)
    with torch.no_grad():
        out1 = lrn.module.forward(lrn.params, torch.from_numpy(obs))
    p1 = float(torch.exp(lrn.module.dist.logp(out1["logits"], zeros)).mean())
    assert p1 > p0, f"policy did not move toward advantage: {p0} -> {p1}"


def test_learner_state_round_trip():
    _, tl = _pair()
    batch = _batch(16, seed=10)
    tl.update(batch)
    state = tl.get_state()
    _, other = _pair()
    other.set_state(state)
    _assert_tree_close(other.get_weights(), tl.get_weights(), tol=0)
    a, b = tl.update(batch), other.update(batch)
    assert a == b


def test_ddppo_data_mesh_matches_jax():
    """The port's learner on 4 gloo ranks' data mesh against JAX's on 8
    virtual devices: the first minibatch's metrics and grads, one update
    and the params after it."""
    spec, cfg = SPEC, CONFIG
    jl = JPPO(jrm.RLModuleSpec(**spec), dict(cfg), use_mesh=True)
    assert jl._mesh is not None and jl._mesh.devices.size == 8
    batch = _batch(64, seed=11)
    init = jax.device_get(jl.params)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jl.loss, has_aux=True)(
        jl.params, jax.tree.map(jnp.asarray, batch))
    want = jl.update(batch)
    port = run_ranks("ppo_mesh", 4, {"spec": spec, "config": cfg,
                                     "params": init, "batch": batch})
    assert port["mesh"] == {"data": 4}
    assert abs(port["metrics"]["total_loss"] - float(jloss)) <= \
        TOL * abs(float(jloss))
    for k, v in jmetrics.items():
        assert _close(port["metrics"][k], float(v)), k
    _assert_tree_close(port["grads"], _named(jax.device_get(jgrads)))
    for k, v in want.items():
        assert _close(port["update"][k], v), k
    _update_close(port["params"], _named(jax.device_get(jl.params)),
                  _named(init))


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_learner_group_remote_equals_local(port_cluster):
    """2 remote learners (actors on the port's runtime, grads all-reduced
    through the host collective group), each on half of the batch, against
    one local learner on the whole batch; the halves hold the same rows
    (the second reversed), so each half's advantage standardisation is the
    whole batch's."""
    half = _batch(32, seed=12)
    joined = {k: np.concatenate([v, v[::-1]]) for k, v in half.items()}
    spec = trm.RLModuleSpec(**SPEC)
    local = LearnerGroup(PPOLearner, spec, dict(CONFIG), device="cpu")
    group = LearnerGroup(PPOLearner, spec, dict(CONFIG), num_learners=2,
                         device="cpu")
    try:
        assert local.is_local and not group.is_local
        w0 = group.get_weights()
        _assert_tree_close(w0, local.get_weights(), tol=0)
        got, want = group.update(joined), local.update(joined)
        assert set(got) == set(want) - {"grad_norm"}
        for k, v in got.items():
            assert _close(v, want[k]), k
        _update_close(group.get_weights(), local.get_weights(), w0)
        with pytest.raises(RuntimeError, match="num_learners=0"):
            group.local_learner()
    finally:
        group.shutdown()
