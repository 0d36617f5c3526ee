"""ray_tpu_torch's Mixtral-style MoE against the JAX package, on the CPU.

Both packages run ``MoEConfig.tiny`` widths on the same params (the JAX
package's ``init_moe``, carried across with ``moe_params_from_jax``) and the
same tokens and activations, drawn with numpy from a seed. Each comparison
first asserts that the routing (each token's top-k experts, in order, and
which (token, k) pairs the capacity drops) is the same on both sides, so that
a tie broken the other way shows as a routing failure and not as a value
outside its tolerance.

Tolerances. fp32 activations: both sides compute in fp32 and differ in
summation order only (logits and grads agreed to 2e-6 of their largest
entry when this was written), so 1e-5 of max|.|. bf16 activations: XLA and
PyTorch round the bf16 products and casts at other places (2**-9 relative
per rounding); through 2 layers the logits differed by 0.8e-2 of max|logit|
and the grads by up to 1.7e-2 of a leaf's largest entry (0.6e-2 of its
norm), so 2e-2 of max|.| for values and of the norm for grads.
"""

import dataclasses
import functools
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import moe as jm  # noqa: E402
from ray_tpu_torch._private.tree import tree_map  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import moe as tm  # noqa: E402
from ray_tpu_torch.parallel import optim as topt  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
DTYPES = [pytest.param(jnp.float32, id="fp32"),
          pytest.param(jnp.bfloat16, id="bf16")]
# relative to max|want| (values) or to |want|'s norm (grads); see above
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 2e-2}
# the aux loss is computed in fp32 from the fp32 router on both sides; in
# bf16 the router's input differs at bf16 rounding level (4.09295 against
# 4.09300, 1.3e-5 relative, when this was written)
TOL_AUX = {jnp.float32: 1e-6, jnp.bfloat16: 1e-4}
# the loss (relative): fp32 agreed to the last digit; bf16 differed by
# 2.3e-4 when this was written
TOL_LOSS = {jnp.float32: 1e-6, jnp.bfloat16: 2e-3}
# the loss after AdamW steps: Adam divides each gradient by its own running
# size, so an entry whose gradient is near the two sides' difference moves
# differently and the losses drift apart (2.9e-6 in fp32 when this was
# written, where test_train_step_matches_jax saw 1.3e-5; 4.4e-4 in bf16)
TOL_STEPS = {jnp.float32: 1e-4, jnp.bfloat16: 2e-3}
# and each leaf's update after 3 steps, against its norm: up to 1.7e-4 in
# fp32 (wo), as test_train_step_matches_jax's 1e-3; in bf16, where the
# grads differ by up to 2e-2 of their norm, up to 0.11 (final_norm)
TOL_UPDATE = {jnp.float32: 1e-3, jnp.bfloat16: 0.25}
B, S = 2, 16
MOE_LAYERS, MOE_VOCAB = 2, 256  # MoEConfig.tiny()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(dtype=jnp.float32, **kw):
    """MoEConfig.tiny with the same fields for both packages."""
    return (dataclasses.replace(jm.MoEConfig.tiny(), dtype=dtype, **kw),
            dataclasses.replace(tm.MoEConfig.tiny(),
                                dtype=_TORCH_DTYPE[dtype], **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    """The JAX package's init_moe at tiny, as numpy (it does not depend on
    the activation type or the capacity factor)."""
    return _np(jax.jit(functools.partial(jm.init_moe, jm.MoEConfig.tiny()))(
        jax.random.PRNGKey(seed)))


def _params(seed=0):
    """(JAX params, the same as the port's CPU tensors)."""
    params = _jax_params(seed)
    return (jax.tree.map(jnp.asarray, params),
            tm.moe_params_from_jax(params))


def _batch(jc, seed=1):
    tok = np.random.RandomState(seed).randint(
        0, jc.vocab_size, (B, S + 1)).astype(np.int32)
    return ({"inputs": tok[:, :-1], "targets": tok[:, 1:]},
            {"inputs": torch.from_numpy(tok[:, :-1]).long(),
             "targets": torch.from_numpy(tok[:, 1:]).long()})


@functools.partial(jax.jit, static_argnums=0)
def _jax_routing(jc, x, router):
    """The reference's routing (ray_tpu/models/moe.py:124-142): (top-k
    expert ids, keep mask) as numpy."""
    Bx, Sx, _ = x.shape
    E, K = jc.num_experts, jc.experts_per_token
    C = max(1, int(jc.capacity_factor * Sx * K / E))
    probs = jax.nn.softmax(jnp.einsum(
        "bsh,he->bse", x.astype(jnp.float32), router.astype(jnp.float32)),
        axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    flat = onehot.reshape(Bx, Sx * K, E)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(Bx, Sx, K, E)
    return idx, (pos < C) & (onehot > 0)


def _rel_max(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _named(tree, prefix=""):
    """{'a.b': leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# ------------------------------------------------------------ config, init

def test_config_matches_jax():
    for name in ("tiny", "mixtral_8x7b_proxy"):
        jc, tc = getattr(jm.MoEConfig, name)(), getattr(tm.MoEConfig, name)()
        want = {f.name: getattr(jc, f.name)
                for f in dataclasses.fields(jc)}
        got = {f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)}
        assert got.pop("dtype") == _TORCH_DTYPE[want.pop("dtype")]
        assert got.pop("param_dtype") == _TORCH_DTYPE[want.pop("param_dtype")]
        assert got == want, name
        assert tc.head_dim == jc.head_dim
    assert [f.name for f in dataclasses.fields(tm.MoEConfig)] == [
        f.name for f in dataclasses.fields(jm.MoEConfig)]


@pytest.mark.parametrize("family", ["moe", "llama"])
@pytest.mark.parametrize("param_dtype", DTYPES)
def test_init_leaves_match_jax(family, param_dtype):
    """Every leaf's shape and dtype equal to the JAX initialiser's, the
    norms too (they are stored in param_dtype, not in fp32)."""
    jmod, tmod, init = ((jm, tm, "init_moe") if family == "moe"
                        else (jl, tl, "init_llama"))
    cfg_cls = "MoEConfig" if family == "moe" else "LlamaConfig"
    jc = dataclasses.replace(getattr(jmod, cfg_cls).tiny(),
                             param_dtype=param_dtype)
    tc = dataclasses.replace(getattr(tmod, cfg_cls).tiny(),
                             param_dtype=_TORCH_DTYPE[param_dtype])
    want = jax.eval_shape(lambda k: getattr(jmod, init)(jc, k),
                          jax.random.PRNGKey(0))
    got = getattr(tmod, init)(tc, torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    want, got = _named(want), _named(got)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == _TORCH_DTYPE[w.dtype.type], name
    if family == "moe":
        # truncated normal on [-2, 2] times fan_in**-0.5; norms are ones
        w = got["layers.we_down"].float()
        bound = 2 * tc.mlp_hidden ** -0.5
        assert w.abs().max() <= bound * 1.01
        assert 0.7 < w.std().item() * tc.mlp_hidden ** 0.5 < 1.0
        assert bool((got["layers.mlp_norm"] == 1).all())


def test_params_from_jax_keeps_values_and_checks_keys():
    params, tp = _params()
    for name, w in _named(_np(params)).items():
        np.testing.assert_array_equal(_named(tp)[name].numpy(), w)
    with pytest.raises(ValueError, match="MoE param tree"):
        tm.moe_params_from_jax({"layers": {}})
    bad = _np(params)
    del bad["layers"]["router"]
    with pytest.raises(ValueError, match="MoE param tree"):
        tm.moe_params_from_jax(bad)


# ------------------------------------------------------------- the FFN

def _ffn_pair(jc, tc, seed=2):
    """JAX and port _moe_ffn on layer 0's weights and one x [B, S, H]:
    (routing on each side, (y, aux) on each side)."""
    params, tp = _params()
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    x = jnp.asarray(np.random.RandomState(seed).standard_normal(
        (B, S, jc.hidden)).astype(np.float32)).astype(jc.dtype)
    tx = torch.tensor(np.asarray(x.astype(jnp.float32))).to(tc.dtype)
    r = tm.route(tc, tx, tlp["router"])
    y, aux = jax.jit(jm._moe_ffn, static_argnums=0)(jc, x, lp)
    ty, taux = tm._moe_ffn(tc, tx, tlp)
    return (_np(_jax_routing(jc, x, lp["router"])),
            (r.expert_idx.numpy(), r.keep.numpy()),
            (np.asarray(y.astype(jnp.float32)), float(aux)),
            (ty.float().numpy(), taux.item()))


@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_ffn_matches_jax(dtype):
    (widx, wkeep), (gidx, gkeep), (y, aux), (ty, taux) = _ffn_pair(
        *_cfgs(dtype))
    np.testing.assert_array_equal(gidx, widx)
    np.testing.assert_array_equal(gkeep, wkeep)
    assert ty.shape == y.shape
    assert _rel_max(ty, y) < TOL[dtype]
    assert abs(taux - aux) <= TOL_AUX[dtype] * abs(aux)


@pytest.mark.parametrize("factor", [0.5, 1e-9])
def test_capacity_drops_match_jax(factor):
    """With capacity 4 (factor 0.5) some but not all (token, k) pairs
    drop, and with the reference's 1e-9 capacity is 1 slot; the same pairs
    drop on both sides, and the dropped pairs add nothing to y."""
    jc, tc = _cfgs(capacity_factor=factor)
    assert tm.capacity(tc, S) == (4 if factor == 0.5 else 1)
    (widx, wkeep), (gidx, gkeep), (y, aux), (ty, taux) = _ffn_pair(jc, tc)
    np.testing.assert_array_equal(gidx, widx)
    np.testing.assert_array_equal(gkeep, wkeep)
    kept = int(gkeep.sum())
    assert 0 < kept < B * S * jc.experts_per_token
    assert _rel_max(ty, y) < TOL[jnp.float32]
    assert abs(taux - aux) <= TOL_AUX[jnp.float32] * abs(aux)
    # a token with no kept pair passes through with y = 0
    none_kept = ~gkeep.any(axis=(2, 3))
    assert none_kept.any()
    assert np.abs(ty[none_kept]).max() == 0


# ------------------------------------------------------- the whole model

@functools.lru_cache(maxsize=None)
def _forward_pair(dtype):
    """Both packages' moe_forward on the same params and tokens: (JAX
    logits, aux, each layer's top-k expert ids; the port's the same). The
    routing is recorded through a debug callback in a wrapper of the JAX
    package's _moe_ffn (which its scan calls per layer) and by wrapping the
    port's route."""
    jc, tc = _cfgs(dtype)
    params, tp = _params()
    jb, tb = _batch(jc)
    want_idx, got_idx = [], []
    j_ffn, t_route = jm._moe_ffn, tm.route

    def j_spy(cfg, x, lp):
        probs = jax.nn.softmax(jnp.einsum(
            "bsh,he->bse", x.astype(jnp.float32),
            lp["router"].astype(jnp.float32)), axis=-1)
        jax.debug.callback(lambda i: want_idx.append(np.asarray(i)),
                           jax.lax.top_k(probs, cfg.experts_per_token)[1])
        return j_ffn(cfg, x, lp)

    def t_spy(cfg, x, router):
        r = t_route(cfg, x, router)
        got_idx.append(r.expert_idx.numpy())
        return r

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "_moe_ffn", j_spy)
        mp.setattr(tm, "route", t_spy)
        logits, aux = jax.jit(jm.moe_forward, static_argnums=2)(
            params, jnp.asarray(jb["inputs"]), jc)
        jax.effects_barrier()
        tlogits, taux = tm.moe_forward(tp, tb["inputs"], tc)
    return ((np.asarray(logits), float(aux), want_idx),
            (tlogits, taux, got_idx))


def _assert_same_routing(dtype):
    (_, _, want_idx), (_, _, got_idx) = _forward_pair(dtype)
    assert len(want_idx) == len(got_idx) == MOE_LAYERS
    for w, g in zip(want_idx, got_idx):
        np.testing.assert_array_equal(g, w)


@functools.lru_cache(maxsize=None)
def _jax_steps(dtype):
    """3 steps of jax.value_and_grad(moe_loss) and optax.adamw(1e-3) on the
    test's params and batch: (losses, the first step's grads, the final
    params), as numpy."""
    jc, _ = _cfgs(dtype)
    params, _ = _params()
    jb = jax.tree.map(jnp.asarray, _batch(jc)[0])
    tx = optax.adamw(1e-3)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(jm.moe_loss)(params, jb, jc)
        upd, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss, grads

    opt_state = tx.init(params)
    losses, grads0 = [], None
    for _ in range(3):
        params, opt_state, loss, grads = jstep(params, opt_state)
        losses.append(float(loss))
        grads0 = _np(grads) if grads0 is None else grads0
    return losses, grads0, _np(params)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype):
    _assert_same_routing(dtype)
    (logits, aux, _), (tlogits, taux, _) = _forward_pair(dtype)
    assert tlogits.dtype == torch.float32 and taux.dtype == torch.float32
    assert tlogits.shape == (B, S, MOE_VOCAB)
    assert _rel_max(tlogits.numpy(), logits) < TOL[dtype]
    assert abs(taux.item() - aux) <= TOL_AUX[dtype] * aux
    assert taux.item() > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_jax(dtype):
    _assert_same_routing(dtype)
    jc, tc = _cfgs(dtype)
    losses, grads, _ = _jax_steps(dtype)
    tp = tree_map(lambda t: t.requires_grad_(True), _params()[1])
    tloss = tm.moe_loss(tp, _batch(jc)[1], tc)
    tloss.backward()
    assert abs(tloss.item() - losses[0]) <= TOL_LOSS[dtype] * losses[0]
    want = _named(grads)
    got = _named(tree_map(lambda t: t.grad.numpy(), tp))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype == np.float32, name
        if dtype == jnp.float32:
            assert _rel_max(g, w) < TOL[dtype], name
        else:
            assert np.linalg.norm(g - w) < TOL[dtype] * np.linalg.norm(w), \
                name


@pytest.mark.parametrize("dtype", DTYPES)
def test_adamw_steps_match_optax(dtype):
    """3 steps of the port's train step with adamw(1e-3) against
    jax.value_and_grad and optax.adamw(1e-3) on the same params and batch;
    the loss falls, as the reference's MoE training test asserts."""
    _assert_same_routing(dtype)
    jc, tc = _cfgs(dtype)
    want, _, final = _jax_steps(dtype)
    state = tts.create_train_state(lambda g: _params()[1], topt.adamw(1e-3),
                                   device="cpu")
    step = tts.make_train_step(lambda p, b: tm.moe_loss(p, b, tc),
                               topt.adamw(1e-3))
    got = []
    for _ in range(3):
        state, m = step(state, _batch(jc)[1])
        got.append(m["loss"].item())
    assert state.step == 3
    np.testing.assert_allclose(got, want, rtol=TOL_STEPS[dtype])
    assert got[-1] < got[0]
    w_init = _named(_jax_params(0))
    g_final = _named(tree_map(lambda t: t.detach().numpy(), state.params))
    for name, w in _named(final).items():
        upd = np.linalg.norm(w - w_init[name])
        assert np.linalg.norm(g_final[name] - w) <= TOL_UPDATE[dtype] * upd, \
            name
