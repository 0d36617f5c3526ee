"""ray_tpu_torch's kv-cache decode, ``merge_lora``, blockwise attention and
the MLP family against the JAX package, on the CPU.

Params come from the JAX package's initialisers and are carried across with
the port's converters; tokens, activations and gradients are drawn with
numpy from a seed and given to both packages.
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
from ray_tpu.models import mlp as jm  # noqa: E402
from ray_tpu.ops.blockwise_attention import (  # noqa: E402
    blockwise_attention as jax_blockwise)
from ray_tpu_torch._private.tree import tree_map  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import mlp as tm  # noqa: E402
from ray_tpu_torch.ops.blockwise_attention import (  # noqa: E402
    blockwise_attention)
from ray_tpu_torch.parallel import optim as topt  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

# fp32 on both sides, sums in other orders: the forward tolerance of
# tests/test_torch_llama.py (test_forward_fp32_matches)
TOL_LOGITS = dict(atol=1e-4, rtol=1e-4)
# blockwise, fp32: the same algorithm on both sides; the flash tests'
# tolerances (the reference's kernel tests, tests/test_ops.py)
TOL_FWD = dict(atol=2e-5, rtol=2e-5)
TOL_GRAD = 5e-5


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


def _tiny():
    return (dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32),
            dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32))


# ------------------------------------------------------------------ decode

DECODE_B, DECODE_MAX_S, DECODE_PRE, DECODE_STEPS = 2, 16, 5, 3


@functools.lru_cache(maxsize=None)
def _jax_decode():
    """JAX llama_decode at tiny: prefill DECODE_PRE tokens into a
    DECODE_MAX_S cache, then DECODE_STEPS single-token calls → (params,
    tokens, [(start, cols, logits)], final caches)."""
    jc, _ = _tiny()
    params = jl.init_llama(jc, jax.random.PRNGKey(20))
    tokens = np.random.RandomState(21).randint(
        0, jc.vocab_size,
        (DECODE_B, DECODE_PRE + DECODE_STEPS)).astype(np.int32)
    shape = (DECODE_B, DECODE_MAX_S, jc.num_kv_heads, jc.head_dim)
    caches = [(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))
              for _ in range(jc.num_layers)]
    decode = jax.jit(jl.llama_decode, static_argnums=2)
    calls = []
    for start, cols in _decode_calls():
        logits, caches = decode(params, jnp.asarray(tokens[:, cols]), jc,
                                caches, jnp.int32(start))
        calls.append((start, cols, np.asarray(logits)))
    return _np(params), tokens, calls, _np(caches)


def _decode_calls():
    pre = DECODE_PRE
    return [(0, slice(0, pre))] + [(t, slice(t, t + 1)) for t in
                                   range(pre, pre + DECODE_STEPS)]


@pytest.mark.parametrize("index", ["int", "tensor"])
def test_llama_decode_matches_jax(index):
    """Prefill 5 tokens into a max_S=16 cache, then 3 single-token steps:
    the logits of every call and the caches at the end."""
    _, tc = _tiny()
    params, tokens, calls, jcaches = _jax_decode()
    tparams = tl.params_from_jax(params)
    shape = (DECODE_B, DECODE_MAX_S, tc.num_kv_heads, tc.head_dim)
    tcaches = [(torch.zeros(shape), torch.zeros(shape))
               for _ in range(tc.num_layers)]
    with torch.no_grad():
        full = tl.llama_forward(tparams, torch.from_numpy(tokens).long(), tc)
        for start, cols, want in calls:
            ci = start if index == "int" else torch.tensor(start)
            got, tcaches = tl.llama_decode(
                tparams, torch.from_numpy(tokens[:, cols]).long(), tc,
                tcaches, ci)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, **TOL_LOGITS)
            # teacher-forced decode is the full forward at the same
            # positions
            np.testing.assert_allclose(got.numpy(), full[:, cols].numpy(),
                                       **TOL_LOGITS)
    end = DECODE_PRE + DECODE_STEPS
    for (jk, jv), (tk, tv) in zip(jcaches, tcaches):
        np.testing.assert_allclose(tk.numpy(), jk, **TOL_LOGITS)
        np.testing.assert_allclose(tv.numpy(), jv, **TOL_LOGITS)
        # the slots past the last write stay empty
        assert not tk[:, end:].any() and not tv[:, end:].any()


def test_cache_slots_clamp_like_dynamic_update_slice():
    for start, n, want in ((3, 2, [3, 4]), (15, 2, [14, 15]),
                           (-3, 2, [13, 14]), (-20, 2, [0, 1])):
        got = tl._cache_slots(start, n, 16, torch.device("cpu"))
        assert got.tolist() == want
        upd = jax.lax.dynamic_update_slice_in_dim(
            jnp.zeros(16), jnp.ones(n), start, axis=0)
        assert np.flatnonzero(np.asarray(upd)).tolist() == want


# -------------------------------------------------------------- merge_lora

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(dtype):
    jc, tc = _tiny()
    lj = jl.LoraConfig(rank=4, targets=("wq", "wv", "w_down"))
    lt = tl.LoraConfig(rank=4, targets=("wq", "wv", "w_down"))
    base = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)),
                        jl.init_llama(jc, jax.random.PRNGKey(22)))
    lora = jl.init_lora(jc, lj, jax.random.PRNGKey(23))
    rng = np.random.RandomState(23)
    for ab in lora["layers"].values():
        ab["b"] = jnp.asarray(
            rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.05)
    want = jl.merge_lora(base, lora, jc, lj)
    tbase = tl.params_from_jax(_np(base))
    tlora = tl.lora_from_jax(_np(lora))
    got = tl.merge_lora(tbase, tlora, tc, lt)
    for name, w in want["layers"].items():
        g = got["layers"][name]
        assert g.dtype == tbase["layers"][name].dtype, name
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=1e-6)
        else:
            # the fp32 sums may differ in their last bit, which can move a
            # rounding to bf16 by one step (2**-8 relative)
            np.testing.assert_allclose(g.float().numpy(), w, atol=0,
                                       rtol=2 ** -8)
    assert got["layers"]["wk"] is tbase["layers"]["wk"]
    if dtype == "float32":
        # the merged model is the adapted one
        tokens = torch.from_numpy(np.random.RandomState(24).randint(
            0, tc.vocab_size, (2, 12)))
        with torch.no_grad():
            merged = tl.llama_forward(got, tokens, tc)
            adapted = tl.llama_forward(tbase, tokens, tc, lora=tlora,
                                       lora_cfg=lt)
        np.testing.assert_allclose(merged.numpy(), adapted.numpy(),
                                   **TOL_LOGITS)


# -------------------------------------------------------------- blockwise

@pytest.mark.parametrize("B,S,H,KVH,D,causal,block_k", [
    (2, 256, 4, 4, 32, True, 64),
    (2, 256, 4, 4, 32, False, 64),
    (1, 128, 8, 2, 32, True, 32),    # GQA
    (1, 96, 4, 2, 16, True, 64),     # 96 % 64: block_k falls back to 32
])
def test_blockwise_matches_jax(B, S, H, KVH, D, causal, block_k):
    rng = np.random.RandomState(25)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, D), (B, S, KVH, D), (B, S, KVH, D), (B, S, H, D)))
    @jax.jit
    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(functools.partial(
            jax_blockwise, causal=causal, block_k=block_k), q, k, v)
        return out, vjp(g)

    jout, jgrads = fwd_bwd(*(jnp.asarray(a) for a in (q, k, v, g)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = blockwise_attention(tq, tk, tv, causal=causal, block_k=block_k)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL_FWD)
    for name, t, w in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.shape == t.shape
        err = np.abs(t.grad.numpy() - np.asarray(w)).max()
        assert err < TOL_GRAD * max(1.0, np.abs(np.asarray(w)).max()), \
            (name, err)


def test_blockwise_bf16_matches_jax():
    """bf16 inputs: both round each block's probabilities to bf16 before
    their product with V, from fp32 statistics summed in other orders."""
    rng = np.random.RandomState(26)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .bfloat16() for s in ((1, 128, 4, 32), (1, 128, 2, 32),
                                     (1, 128, 2, 32)))
    out = blockwise_attention(q, k, v, causal=True, block_k=32)
    want = jax_blockwise(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                           for t in (q, k, v)), causal=True, block_k=32)
    assert out.dtype == torch.bfloat16
    # a few bf16 rounding steps (2**-8 relative each), as
    # test_reference_bf16_casts_probs_before_pv holds the reference path
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def test_blockwise_keeps_no_score_matrix_for_the_backward():
    """Each block runs under checkpoint: what the graph saves for the
    backward holds no [B, H, S, block_k] scores, only the block inputs and
    the fp32 carry."""
    B, S, H, D, bk = 1, 128, 2, 16, 32
    q, k, v = (torch.randn(B, S, H, D, requires_grad=True)
               for _ in range(3))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = blockwise_attention(q, k, v, causal=True, block_k=bk)
    assert saved and (B, H, S, bk) not in saved
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))


# -------------------------------------------------------------------- MLP

@pytest.mark.parametrize("num_layers", [2, 4])
def test_mlp_forward_loss_and_grads_match_jax(num_layers):
    jc = jm.MLPConfig(in_dim=64, hidden=32, out_dim=10,
                      num_layers=num_layers)
    tc = tm.MLPConfig(in_dim=64, hidden=32, out_dim=10,
                      num_layers=num_layers)
    params = jm.init_mlp(jc, jax.random.PRNGKey(27))
    rng = np.random.RandomState(27)
    batch = {"x": rng.standard_normal((8, 64)).astype(np.float32),
             "y": rng.randint(0, 10, (8,)).astype(np.int32)}
    jb = jax.tree.map(jnp.asarray, batch)
    want_logits = jax.jit(jm.mlp_forward, static_argnums=2)(
        params, jb["x"], jc)
    want, want_g = jax.jit(jax.value_and_grad(jm.mlp_loss),
                           static_argnums=2)(params, jb, jc)
    tparams = tree_map(lambda t: t.requires_grad_(True),
                       tm.mlp_params_from_jax(_np(params)))
    tb = {"x": torch.from_numpy(batch["x"]),
          "y": torch.from_numpy(batch["y"]).long()}
    logits = tm.mlp_forward(tparams, tb["x"], tc)
    loss = tm.mlp_loss(tparams, tb, tc)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), atol=1e-5,
                               rtol=1e-5)
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    for name, w in want_g.items():
        g = tparams[name].grad
        if g is None:  # the empty stack of hidden layers at num_layers=2
            assert w.size == 0, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_mlp_init_layout_and_converter():
    jc, tc = jm.MLPConfig(), tm.MLPConfig()
    want = jax.eval_shape(lambda k: jm.init_mlp(jc, k),
                          jax.random.PRNGKey(0))
    got = tm.init_mlp(tc, torch.Generator().manual_seed(0),
                      torch.device("cpu"))
    assert ({k: tuple(a.shape) for k, a in want.items()}
            == {k: tuple(t.shape) for k, t in got.items()})
    assert all(t.dtype == torch.float32 for t in got.values())
    assert got["w_hidden"].shape == (0, 512, 512)
    assert 0.9 < got["w_in"].std().item() * 784 ** 0.5 < 1.1
    assert not got["b_in"].any()
    with pytest.raises(ValueError, match="MLP param tree"):
        tm.mlp_params_from_jax({"w_in": np.zeros(2)})


def test_mlp_adamw_steps_match_optax():
    """3 steps of the port's train step with adamw against jax.grad and
    optax.adamw on the same params and batch."""
    jc = jm.MLPConfig(in_dim=64, hidden=32, out_dim=10, num_layers=3)
    tc = tm.MLPConfig(in_dim=64, hidden=32, out_dim=10, num_layers=3)
    params = jm.init_mlp(jc, jax.random.PRNGKey(28))
    rng = np.random.RandomState(28)
    batch = {"x": rng.standard_normal((16, 64)).astype(np.float32),
             "y": rng.randint(0, 10, (16,)).astype(np.int32)}
    jb = jax.tree.map(jnp.asarray, batch)
    tx = optax.adamw(1e-2)

    @jax.jit
    def jstep(params, opt_state):
        loss, grads = jax.value_and_grad(jm.mlp_loss)(params, jb, jc)
        upd, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    opt_state = tx.init(params)
    want = []
    for _ in range(3):
        params, opt_state, loss = jstep(params, opt_state)
        want.append(float(loss))
    init = tm.mlp_params_from_jax(_np(jm.init_mlp(jc, jax.random.PRNGKey(28))))
    state = tts.create_train_state(lambda g: init, topt.adamw(1e-2),
                                   device="cpu")
    step = tts.make_train_step(lambda p, b: tm.mlp_loss(p, b, tc),
                               topt.adamw(1e-2))
    tb = {"x": torch.from_numpy(batch["x"]),
          "y": torch.from_numpy(batch["y"]).long()}
    got = []
    for _ in range(3):
        state, m = step(state, tb)
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    for name, w in params.items():
        np.testing.assert_allclose(state.params[name].detach().numpy(),
                                   np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
