"""ray_tpu_torch's training path against the JAX reference, on the CPU: the
loss (``_nll_from_logits``, ``_chunked_ce``, ``llama_loss``,
``llama_lora_loss``), remat, ``adamw`` and the train step.

Both packages run ``LlamaConfig.tiny`` in fp32 on the same params (carried
across with ``params_from_jax`` / ``lora_from_jax``) and the same tokens,
drawn with numpy from a seed. Where the JAX side runs flash attention, the
Pallas kernels run in interpret mode.
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
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch._private.tree import tree_leaves, tree_map  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from ray_tpu_torch.parallel import optim as topt  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

ALL_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


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


def _cfgs(**kw):
    """tiny in fp32 for both packages (remat off unless kw says so)."""
    return (dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                                **kw),
            dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                                **kw))


def _batch(seed, B, S, vocab, mask=False):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, vocab, (B, S + 1)).astype(np.int32)
    b = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    if mask:
        b["mask"] = (rng.uniform(size=(B, S)) < 0.7).astype(np.float32)
    return b


def _tb(batch):
    """The batch as torch tensors (token ids as int64)."""
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _jax_lora(jc, lcfg, seed):
    """JAX adapters with a nonzero B, so that dA is not 0."""
    lora = jl.init_lora(jc, lcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    for ab in lora["layers"].values():
        ab["b"] = jnp.asarray(
            rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.05)
    return lora


def _grads(loss_fn, tree):
    """Torch loss and grads of loss_fn(tree) w.r.t. every leaf of tree."""
    tree = tree_map(lambda t: t.clone().requires_grad_(True), tree)
    loss = loss_fn(tree)
    loss.backward()
    return loss.item(), tree_map(lambda t: t.grad, tree)


def _assert_trees_close(got, want, atol, rtol=0.0):
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        tree_map(lambda t: t.detach().numpy(), got))[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        np.testing.assert_allclose(flat_g[path], np.asarray(w), atol=atol,
                                   rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_updates_close(got, want, init, rel=1e-3):
    """Params after some AdamW steps: Adam divides each gradient by its own
    running magnitude, so an entry whose gradient is near the summation
    difference of the two runs can move differently (a few entries of 90k
    did, by up to 3e-4); each leaf's update is held to ``rel`` of its norm
    (1.2e-4 at most was seen) instead of entry by entry."""
    flat = [dict(jax.tree_util.tree_flatten_with_path(t)[0]) for t in (
        tree_map(lambda t: t.detach().numpy(), got), want, init)]
    assert flat[0].keys() == flat[1].keys() == flat[2].keys()
    for path, w in flat[1].items():
        g, w, w0 = flat[0][path], np.asarray(w), np.asarray(flat[2][path])
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w - w0), \
            jax.tree_util.keystr(path)


def test_config_training_fields_default_like_jax():
    for name in ("llama2_7b", "tiny", "debug_1l"):
        jc, tc = getattr(jl.LlamaConfig, name)(), \
            getattr(tl.LlamaConfig, name)()
        assert (tc.remat, tc.remat_policy, tc.loss_chunk) == \
            (jc.remat, jc.remat_policy, jc.loss_chunk), name
    assert tl.LlamaConfig().remat and not tl.LlamaConfig.tiny().remat


@pytest.mark.parametrize("masked", [False, True])
def test_nll_and_chunked_ce_match_jax(masked):
    rng = np.random.RandomState(0)
    B, S, H, V = 2, 16, 32, 64
    x = rng.standard_normal((B, S, H)).astype(np.float32)
    w = (rng.standard_normal((H, V)) * H ** -0.5).astype(np.float32)
    b = _batch(1, B, S, V, mask=masked)
    t, m = b["targets"], b.get("mask")
    logits = x @ w
    np.testing.assert_allclose(
        tl._nll_from_logits(torch.from_numpy(logits),
                            torch.from_numpy(t)).numpy(),
        np.asarray(jl._nll_from_logits(jnp.asarray(logits), jnp.asarray(t))),
        atol=1e-5, rtol=1e-5)

    want, want_g = jax.value_and_grad(
        lambda w_: jl._chunked_ce(jnp.asarray(x), w_, jnp.asarray(t),
                                  None if m is None else jnp.asarray(m), 8,
                                  jnp.float32))(jnp.asarray(w))
    tm = None if m is None else torch.from_numpy(m)
    got, got_g = _grads(
        lambda w_: tl._chunked_ce(torch.from_numpy(x), w_,
                                  torch.from_numpy(t).long(), tm, 8,
                                  torch.float32), torch.from_numpy(w))
    # tests/test_models_parallel.py test_chunked_loss_matches_dense
    assert abs(got - float(want)) < 1e-3, (got, float(want))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=2e-2,
                               atol=2e-4)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(attn_impl):
    """JAX llama_loss value and grads at tiny, S=128, without remat (the JAX
    package's own test_mixed_remat_matches_full holds its policies equal)."""
    jc, _ = _cfgs(attn_impl=attn_impl)
    params = jl.init_llama(jc, jax.random.PRNGKey(0))
    b = _batch(2, 1, 128, jc.vocab_size)
    loss, grads = jax.value_and_grad(
        lambda p: jl.llama_loss(p, jax.tree.map(jnp.asarray, b), jc))(params)
    return _np(params), b, float(loss), _np(grads)


@pytest.mark.parametrize("remat", ["off", "full", "dots", "mixed:1"])
@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
def test_llama_loss_and_grads_match_jax(attn_impl, remat):
    params, b, want, want_g = _jax_loss_and_grads(attn_impl)
    _, tc = _cfgs(attn_impl=attn_impl, remat=remat != "off",
                  remat_policy="dots" if remat == "off" else remat)
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    got, got_g = _grads(lambda p: tl.llama_loss(p, _tb(b), tc),
                        tl.params_from_jax(params))
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == before
    # tests/test_models_parallel.py test_mixed_remat_matches_full
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    _assert_trees_close(got_g, want_g, atol=1e-4)


def test_dots_remat_saves_only_unbatched_products():
    """The "dots" policy keeps the projections' products (bmm with a batch
    of 1) and recomputes the reference attention's batched ones."""
    h = torch.randn(2, 5, 8)
    op = torch.ops.aten.bmm.default
    proj = torch.einsum("bsh,hr->bsr", h, torch.randn(8, 3))
    assert proj.shape == (2, 5, 3)
    assert tl._dots_policy(None, op, torch.zeros(1, 10, 8),
                           torch.zeros(1, 8, 3)).name == "MUST_SAVE"
    assert tl._dots_policy(None, op, torch.zeros(8, 5, 4),
                           torch.zeros(8, 4, 5)).name == "PREFER_RECOMPUTE"
    assert tl._dots_policy(None, torch.ops.aten.mul.Tensor, h,
                           h).name == "PREFER_RECOMPUTE"
    _, tc = _cfgs(remat=True, remat_policy="mixed:1")
    assert tl._layer_policies(tc) == ["dots", "full"]
    with torch.no_grad():
        assert tl._layer_policies(tc) == [None, None]
    with pytest.raises(ValueError, match="remat_policy"):
        tl._layer_policies(dataclasses.replace(tc, remat_policy="some"))


def test_llama_loss_batch_forms_and_mask_match_jax():
    jc, tc = _cfgs()
    params = jl.init_llama(jc, jax.random.PRNGKey(3))
    tparams = tl.params_from_jax(_np(params))
    b = _batch(4, 2, 16, jc.vocab_size, mask=True)
    tokens = np.concatenate([b["inputs"], b["targets"][:, -1:]], axis=1)
    cases = [({"tokens": tokens}, jc, tc),
             (b, jc, tc),
             (b, dataclasses.replace(jc, loss_chunk=8),
              dataclasses.replace(tc, loss_chunk=8))]
    for batch, jcfg, tcfg in cases:
        want = jl.llama_loss(params, jax.tree.map(jnp.asarray, batch), jcfg)
        with torch.no_grad():
            got = tl.llama_loss(tparams, _tb(batch), tcfg)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want)), \
            (sorted(batch), tcfg.loss_chunk)


def test_lora_loss_adapter_grads_match_jax():
    jc, tc = _cfgs()
    jlcfg = jl.LoraConfig(rank=4, targets=ALL_TARGETS)
    tlcfg = tl.LoraConfig(rank=4, targets=ALL_TARGETS)
    base = jl.init_llama(jc, jax.random.PRNGKey(5))
    lora = _jax_lora(jc, jlcfg, 6)
    b = _batch(7, 2, 16, jc.vocab_size)
    want, want_g = jax.value_and_grad(
        lambda lo: jl.llama_lora_loss(base, lo, jax.tree.map(jnp.asarray, b),
                                      jc, jlcfg))(lora)
    tbase = tl.params_from_jax(_np(base))
    got, got_g = _grads(
        lambda lo: tl.llama_lora_loss(tbase, lo, _tb(b), tc, tlcfg),
        tl.lora_from_jax(_np(lora)))
    assert abs(got - float(want)) <= 1e-5 * abs(float(want))
    assert set(got_g["layers"]) == set(ALL_TARGETS)
    assert all(float(np.abs(np.asarray(ab["a"])).max()) > 0
               for ab in want_g["layers"].values())
    _assert_trees_close(got_g, _np(want_g), atol=1e-4)
    # no grad reached the frozen base
    assert all(t.grad is None for t in tree_leaves(tbase))


def _run_jax_steps(kind, jc, batch, n):
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    tx = optax.adamw(3e-3)
    base = jl.init_llama(jc, jax.random.PRNGKey(0))
    with jax.set_mesh(mesh):
        if kind == "lora":
            lcfg = jl.LoraConfig(rank=4, targets=ALL_TARGETS)
            state, sh = jts.create_train_state(
                lambda k: jl.init_lora(jc, lcfg, k), tx, mesh,
                jl.lora_logical_axes(jc, lcfg), seed=1)
            step = jts.make_train_step(
                lambda lo, bb, fz: jl.llama_lora_loss(fz, lo, bb, jc, lcfg),
                tx, mesh, sh, batch_logical_axes=("batch", "seq"),
                frozen=base, frozen_logical_axes=jl.llama_logical_axes(jc),
                donate=False)
        else:
            state, sh = jts.create_train_state(
                lambda k: jl.init_llama(jc, k), tx, mesh,
                jl.llama_logical_axes(jc))
            step = jts.make_train_step(
                lambda p, bb: jl.llama_loss(p, bb, jc), tx, mesh, sh,
                batch_logical_axes=("batch", "seq"), donate=False)
        init = _np(state.params)
        metrics = []
        for _ in range(n):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
    return _np(base), init, metrics, _np(state.params)


@pytest.mark.parametrize("kind", ["lora", "dense"])
def test_train_step_matches_jax(kind):
    """3 AdamW steps of the LoRA frozen-base path and of the dense path."""
    jc, tc = _cfgs()
    b = _batch(8, 4, 16, jc.vocab_size)
    base, init, want, want_params = _run_jax_steps(kind, jc, b, 3)
    tbase = tl.params_from_jax(base)
    if kind == "lora":
        tlcfg = tl.LoraConfig(rank=4, targets=ALL_TARGETS)
        state = tts.create_train_state(lambda g: tl.lora_from_jax(init),
                                       topt.adamw(3e-3), device="cpu")
        step = tts.make_train_step(
            lambda lo, bb, fz: tl.llama_lora_loss(fz, lo, bb, tc, tlcfg),
            topt.adamw(3e-3), frozen=tbase)
    else:
        state = tts.create_train_state(lambda g: tl.params_from_jax(init),
                                       topt.adamw(3e-3), device="cpu")
        step = tts.make_train_step(lambda p, bb: tl.llama_loss(p, bb, tc),
                                   topt.adamw(3e-3))
    got = []
    for _ in range(3):
        state, m = step(state, _tb(b))
        got.append((m["loss"].item(), m["grad_norm"].item(), m["step"]))
    assert state.step == 3
    for (gl, gn, gs), (wl, wn, ws) in zip(got, want):
        # step 1 agrees to 1e-7; after an update the few entries that
        # _assert_updates_close describes move the loss by up to 1.3e-5
        assert abs(gl - wl) <= 1e-4 * abs(wl), (got, want)
        assert abs(gn - wn) <= 1e-4 * abs(wn), (got, want)
        assert gs == ws
    _assert_updates_close(state.params, want_params, init)
    # the base stayed frozen
    for t, w in zip(tree_leaves(tbase), jax.tree.leaves(base)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_grad_accum_matches():
    """grad_accum=2 over 8 rows == grad_accum=1 over the same 8 rows."""
    _, tc = _cfgs()
    b = _tb(_batch(9, 8, 16, tc.vocab_size))
    runs = []
    for accum in (1, 2):
        state = tts.create_train_state(
            lambda g: tl.init_llama(tc, g, g.device), topt.adamw(3e-3),
            device="cpu", seed=4)
        init = tree_map(lambda t: t.detach().numpy().copy(),
                             state.params)
        step = tts.make_train_step(lambda p, bb: tl.llama_loss(p, bb, tc),
                                   topt.adamw(3e-3), grad_accum=accum)
        state, m = step(state, b)
        runs.append((m, state.params))
    (m1, p1), (m2, p2) = runs
    np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m1["grad_norm"].item(),
                               m2["grad_norm"].item(), rtol=1e-5)
    _assert_updates_close(p2, tree_map(lambda t: t.detach().numpy(),
                                            p1), init)
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_train_step(lambda p, bb: tl.llama_loss(p, bb, tc),
                            topt.adamw(3e-3), grad_accum=3)(state, b)


def test_eval_step_is_the_loss_without_grad():
    _, tc = _cfgs()
    state = tts.create_train_state(lambda g: tl.init_llama(tc, g, g.device),
                                   topt.adamw(1e-3), device="cpu")
    b = _tb(_batch(10, 2, 16, tc.vocab_size))
    loss = tts.make_eval_step(lambda p, bb: tl.llama_loss(p, bb, tc))(
        state.params, b)
    assert not loss.requires_grad
    with torch.no_grad():
        assert loss.item() == tl.llama_loss(state.params, b, tc).item()


def test_adamw_matches_optax():
    """One update on hand-made arrays, params near 10 and lr 0.1: the weight
    decay term is lr * wd * 10 = 1e-4 here, so a wrong default (torch's
    1e-2) would be off by 1e-2, far outside 1e-6 relative."""
    rng = np.random.RandomState(11)
    p = {"w": (10 + rng.standard_normal((64, 32))).astype(np.float32),
         "b": (10 + rng.standard_normal((32,))).astype(np.float32)}
    g = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}
    tx = optax.adamw(0.1)
    upd, _ = tx.update(jax.tree.map(jnp.asarray, g),
                       tx.init(jax.tree.map(jnp.asarray, p)),
                       jax.tree.map(jnp.asarray, p))
    want = optax.apply_updates(jax.tree.map(jnp.asarray, p), upd)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    opt = topt.adamw(0.1)(tp)
    for k in tp:
        tp[k].grad = torch.from_numpy(g[k])
    opt.step()
    for k in p:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-6, atol=0)
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (0.1, (0.9, 0.999), 1e-8, 1e-4)


def test_create_train_state_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tts.create_train_state(lambda g: {"w": torch.zeros(2)},
                               topt.adamw(1e-3))
