"""ray_tpu_torch's Llama against the JAX reference, on the CPU.

The JAX model's params and adapters are carried across with
``params_from_jax`` / ``lora_from_jax``; tokens are drawn with numpy from a
seed. Both sides run at ``LlamaConfig.tiny`` widths.
"""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name="tiny", dtype=jnp.float32, attn_impl="auto"):
    """The same configuration for both packages."""
    jc = dataclasses.replace(getattr(jl.LlamaConfig, name)(), dtype=dtype,
                             attn_impl=attn_impl)
    tc = dataclasses.replace(getattr(tl.LlamaConfig, name)(),
                             dtype=_TORCH_DTYPE[dtype], attn_impl=attn_impl)
    return jc, tc


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_lora(jc, lcfg, seed):
    """JAX adapters with a nonzero B (B = 0 would make them a no-op)."""
    lora = jl.init_lora(jc, lcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    for ab in lora["layers"].values():
        ab["b"] = jnp.asarray(
            rng.standard_normal(ab["b"].shape).astype(np.float32) * 0.05)
    return lora


def _forward_pair(jc, tc, S, adapters, seed=0):
    params = jl.init_llama(jc, jax.random.PRNGKey(seed))
    jlcfg = jl.LoraConfig(rank=4, targets=adapters) if adapters else None
    tlcfg = tl.LoraConfig(rank=4, targets=adapters) if adapters else None
    lora = _jax_lora(jc, jlcfg, seed + 1) if adapters else None
    tokens = np.random.RandomState(seed).randint(
        0, jc.vocab_size, (2, S)).astype(np.int32)
    want = jl.llama_forward(params, jnp.asarray(tokens), jc, lora=lora,
                            lora_cfg=jlcfg)
    got = tl.llama_forward(
        tl.params_from_jax(_np(params)), torch.from_numpy(tokens).long(), tc,
        lora=tl.lora_from_jax(_np(lora)) if adapters else None,
        lora_cfg=tlcfg)
    return np.asarray(want), got.numpy()


def test_rms_norm_matches():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    want = jl._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tl._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_rope_matches():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    want = jl._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    # angles up to ~106 rad: fp32 sin/cos of large arguments differ by a few
    # ulp of the angle between libraries
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("adapters", [(), ("wq", "wv")])
def test_forward_fp32_matches(adapters):
    want, got = _forward_pair(*_cfgs(), S=24, adapters=adapters)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("adapters", [(), ("wq", "wv")])
def test_forward_bf16_matches(adapters):
    want, got = _forward_pair(*_cfgs(dtype=jnp.bfloat16), S=24,
                              adapters=adapters)
    # bf16 activations (8-bit mantissa) rounded at different places by XLA
    # and PyTorch, through 2 layers: logits of magnitude up to ~4 differed
    # by at most 0.031 (relative norm 0.0068) when this was written; the
    # limits leave about 3x of room
    assert np.abs(got - want).max() < 0.1
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_forward_through_flash_matches():
    """attn_impl='flash' at S=128 on both sides: the Pallas kernel in
    interpret mode against the port's flash path (its plain version on the
    CPU)."""
    before = tfa.launches
    want, got = _forward_pair(*_cfgs(attn_impl="flash"), S=128,
                              adapters=("wq", "wv"))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert tfa.launches == before


@pytest.mark.parametrize("name", ["llama2_7b", "tiny", "debug_1l"])
def test_config_arithmetic_matches(name):
    jc, tc = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig, name)()
    assert tc.num_params() == jc.num_params()
    assert tc.flops_per_token() == jc.flops_per_token()
    assert tc.flops_per_token(2048) == jc.flops_per_token(2048)
    lj, lt = jl.LoraConfig(), tl.LoraConfig()
    assert lt.num_params(tc) == lj.num_params(jc)
    assert lt.scale == lj.scale
    n = lt.num_params(tc)
    assert (tc.flops_per_token_frozen(n, 512)
            == jc.flops_per_token_frozen(n, 512))


def test_init_layout_matches_reference():
    jc, tc = _cfgs("debug_1l")
    want = jax.eval_shape(lambda k: jl.init_llama(jc, k),
                          jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    got = tl.init_llama(dataclasses.replace(tc, param_dtype=torch.bfloat16),
                        gen, torch.device("cpu"))
    assert (jax.tree.map(lambda a: tuple(a.shape), want)
            == jax.tree.map(lambda t: tuple(t.shape), got))
    assert got["embed"].dtype == torch.bfloat16
    assert got["layers"]["wq"].dtype == torch.bfloat16
    assert got["layers"]["attn_norm"].dtype == torch.float32
    # truncated normal on [-2, 2] times fan_in**-0.5
    w = got["layers"]["w_down"].float()
    bound = 2 * tc.mlp_hidden ** -0.5
    assert w.abs().max() <= bound * 1.01
    assert 0.7 < w.std().item() * tc.mlp_hidden ** 0.5 < 1.0

    lj, lt = jl.LoraConfig(rank=2), tl.LoraConfig(rank=2)
    want = jax.eval_shape(lambda k: jl.init_lora(jc, lj, k),
                          jax.random.PRNGKey(0))
    got = tl.init_lora(tc, lt, gen, torch.device("cpu"))
    assert (jax.tree.map(lambda a: tuple(a.shape), want)
            == jax.tree.map(lambda t: tuple(t.shape), got))
    assert all(bool((ab["b"] == 0).all()) for ab in got["layers"].values())


def test_converters_keep_values_and_bf16():
    jc, _ = _cfgs("debug_1l")
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                          jl.init_llama(jc, jax.random.PRNGKey(3)))
    got = tl.params_from_jax(_np(params))
    assert got["lm_head"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["lm_head"].float().numpy(),
        np.asarray(params["lm_head"].astype(jnp.float32)))
    with pytest.raises(ValueError, match="llama param tree"):
        tl.params_from_jax({"layers": {}})
    with pytest.raises(ValueError, match="LoRA tree"):
        tl.lora_from_jax(_np(params))
