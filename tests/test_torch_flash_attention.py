"""ray_tpu_torch attention against the JAX reference, on the CPU.

The port's plain flash forward (the twin its CUDA kernel is checked against
on the card) is held against the Pallas ``_flash_fwd`` run in interpret
mode, and the attention dispatcher against JAX ``reference_attention``. The
inputs are drawn with numpy from a seed and given to both packages.
"""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops.attention import reference_attention as jax_reference  # noqa: E402
from ray_tpu.ops.pallas.flash_attention import _flash_fwd  # noqa: E402
from ray_tpu_torch.ops.attention import attention, reference_attention  # noqa: E402
from ray_tpu_torch.ops.cuda import _build  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402

# fp32 forward tolerance of the reference's own kernel test (test_ops.py)
TOL32 = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, H, KVH, S, D, layout="bhsd"):
    rng = np.random.RandomState(seed)
    if layout == "bhsd":
        shapes = [(B, H, S, D), (B, KVH, S, D), (B, KVH, S, D)]
    else:
        shapes = [(B, S, H, D), (B, S, KVH, D), (B, S, KVH, D)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _bf16_round(a):
    """Round to bf16 through torch, so both sides see the same bf16 inputs."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KVH,S,D", [(1, 4, 2, 128, 32),
                                         (2, 4, 2, 256, 64)])
def test_plain_flash_fwd_matches_pallas(B, H, KVH, S, D, causal):
    q, k, v = _qkv(0, B, H, KVH, S, D)
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, block_q=512, block_k=512)
    o, lse = tfa.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert o.dtype == torch.float32 and lse.shape == (B, H, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL32)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL32)


def test_plain_flash_fwd_bf16_matches_pallas():
    # both compute in fp32 from the same bf16 inputs; o differs at most by
    # one bf16 rounding step (2**-8 relative), lse is fp32 on both sides
    q, k, v = (_bf16_round(a) for a in _qkv(1, 1, 4, 2, 128, 64))
    jo, jlse = _flash_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                          causal=True, block_q=512, block_k=512)
    o, lse = tfa.flash_attention_fwd_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), True)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL32)


def test_wrapper_on_cpu_uses_plain_version_in_public_layout():
    q, k, v = _qkv(2, 2, 4, 2, 128, 32, layout="bshd")
    before = tfa.launches
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True)
    ref = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True)
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL32)
    assert tfa.launches == before, "no kernel launch for CPU tensors"


@pytest.mark.parametrize("impl", ["reference", "flash", "auto"])
@pytest.mark.parametrize("causal", [True, False])
def test_dispatcher_matches_jax_reference(impl, causal):
    q, k, v = _qkv(3, 2, 4, 2, 128, 32, layout="bshd")
    before = tfa.launches
    out = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                    impl=impl, causal=causal)
    ref = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL32)
    assert tfa.launches == before


def test_reference_q_offset_and_valid_kv_len():
    # decode-shaped: a 4-row query block at offset 9 inside 16 kv slots,
    # with per-row valid lengths
    rng = np.random.RandomState(4)
    q = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    valid = np.array([13, 11], np.int32)
    out = attention(
        *(torch.from_numpy(a) for a in (q, k, v)), impl="auto", causal=True,
        q_offset=9, valid_kv_len=torch.from_numpy(valid))
    ref = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, q_offset=jnp.int32(9),
                        valid_kv_len=jnp.asarray(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL32)


def test_reference_bf16_casts_probs_before_pv():
    q, k, v = (_bf16_round(a) for a in _qkv(5, 1, 4, 2, 128, 32,
                                             layout="bshd"))
    out = reference_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=True)
    ref = jax_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                        causal=True)
    assert out.dtype == torch.bfloat16
    # bf16 products on both sides, summed in different orders: a few bf16
    # rounding steps (2**-8 relative each)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=3e-2, rtol=3e-2)


def test_flash_rejects_what_the_kernel_cannot_take():
    q, k, v = (torch.zeros(1, 2, 96, 32) for _ in range(3))
    with pytest.raises(ValueError, match="divide by 128"):
        tfa.flash_attention_fwd(q, k, v, True)
    q, k, v = (torch.zeros(1, 2, 128, 32, requires_grad=True)
               for _ in range(3))
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa.flash_attention_fwd(q, k, v, True)
    q, k, v = (torch.zeros(1, 2, 128, 32, device="meta") for _ in range(3))
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        tfa.flash_attention_fwd(q, k, v, True)
    with pytest.raises(NotImplementedError, match="blockwise"):
        attention(*(torch.zeros(1, 128, 2, 32) for _ in range(3)),
                  impl="blockwise")
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(*(torch.zeros(1, 128, 2, 32) for _ in range(3)),
                  impl="ring")


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    # no fallback: a missing compiler is an error at the first build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_attention_fwd")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "build").exists()
