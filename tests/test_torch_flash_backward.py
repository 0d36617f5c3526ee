"""ray_tpu_torch's flash-attention backward against the JAX reference, on
the CPU.

The port's plain backward (the twin its CUDA kernels K2 and K3 are checked
against on the card) is held against the Pallas ``_flash_bwd`` run in
interpret mode, and the differentiable ``flash_attention`` against
``jax.grad`` of the JAX ``flash_attention`` and against torch autograd
through the port's reference attention. Inputs are drawn with numpy from a
seed and given to both packages.
"""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops.pallas.flash_attention import (  # noqa: E402
    _flash_bwd, _flash_fwd, flash_attention as jax_flash_attention)
from ray_tpu_torch.ops.attention import reference_attention  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

# the reference's own gradient tolerances (tests/test_ops.py
# TestFlashBackward): fp32 5e-5, and 1e-3 where GQA sums a group's heads
TOL_GRAD = 5e-5
TOL_GRAD_GQA = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _counts():
    return tfa.launches, tfa.dq_launches, tfa.dkv_launches


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KVH,S,D", [(1, 4, 4, 128, 32),
                                         (1, 4, 2, 256, 64)])
def test_plain_bwd_matches_pallas(B, H, KVH, S, D, causal):
    q, k, v, do = _arrays(0, (B, H, S, D), (B, KVH, S, D), (B, KVH, S, D),
                          (B, H, S, D))
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, block_q=512, block_k=512)
    want = _flash_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo,
                      jlse, jnp.asarray(do), causal=causal, block_q=512,
                      block_k=512)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = tfa.flash_attention_fwd_plain(tq, tk, tv, causal)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal)
    tol = TOL_GRAD if H == KVH else TOL_GRAD_GQA
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=name)

    # the kernel wrappers take the twins on CPU tensors and launch nothing
    before = _counts()
    wrapped = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal)
    for g, w in zip(wrapped, got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert _counts() == before


@pytest.mark.parametrize("KVH", [4, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad_and_reference(causal, KVH):
    B, S, H, D = 1, 128, 4, 32
    q, k, v, g = _arrays(1, (B, S, H, D), (B, S, KVH, D), (B, S, KVH, D),
                         (B, S, H, D))
    want = jax.grad(
        lambda *a: (jax_flash_attention(*a, causal) * jnp.asarray(g)).sum(),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def torch_grads(attn):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        (attn(*ts) * torch.from_numpy(g)).sum().backward()
        return [t.grad for t in ts]

    before = _counts()
    got = torch_grads(lambda *a: tfa.flash_attention(*a, causal=causal))
    assert _counts() == before, "no kernel launch for CPU tensors"
    ref = torch_grads(lambda *a: reference_attention(*a, causal=causal))
    tol = TOL_GRAD if H == KVH else TOL_GRAD_GQA
    for name, a, w, r in zip("qkv", got, want, ref):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=f"d{name} vs jax")
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=tol, rtol=tol,
                                   err_msg=f"d{name} vs reference")


def test_backward_checks_its_inputs():
    q, k, v, do = (torch.zeros(1, 2, 128, 32) for _ in range(4))
    lse = delta = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="does not match q"):
        tfa.flash_attention_dq(q, k, v, do.bfloat16(), lse, delta, True)
    with pytest.raises(ValueError, match="lse must be fp32"):
        tfa.flash_attention_dkv(q, k, v, do, lse.double(), delta, True)
    with pytest.raises(ValueError, match="delta must be fp32"):
        tfa.flash_attention_dq(q, k, v, do, lse, delta[..., :64], True)
