"""The bf16 tensor-core kernels' numerics and the wrappers' alignment rule,
on the CPU.

On the card the bf16 forward (K1), dq (K2) and dk/dv (K3) kernels run their
products on the tensor cores, which take bf16 operands: the forward rounds P
to bf16 before the PV product, dq rounds the unscaled dS = P(dP − δ) before
dS K (and scales the fp32 sum once, at the store), and dk/dv rounds Pᵀ and
dSᵀ before its two products. The kernels cannot run here, so a test-only
emulation makes the same roundings, tile by tile where the kernel works
tile by tile, and is held against the Pallas ``_flash_fwd`` / ``_flash_bwd``
(interpret mode) at the tolerances ``chip_smoke.py`` holds the kernels to.
Inputs are drawn with numpy from a seed and given to both packages.

The wrappers' rule: pointers 16-byte aligned and (batch, head, seq) strides
divisible by 16 bytes' worth of elements (8 in bf16, 4 in fp32).
"""

import math
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ray_tpu.ops.pallas.flash_attention import _flash_bwd, _flash_fwd  # noqa: E402
from ray_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

# chip_smoke.py's bf16 tolerances: o absolute, lse absolute, grads as the
# largest error relative to max|reference|
TOL_O = 2e-2
TOL_LSE = 1e-3
TOL_GRAD_REL = 2e-2
BK = 64  # the forward kernel's kv tile


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(seed, *shapes):
    """bf16-exact fp32 arrays, so both packages see the same bf16 inputs."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16().float().numpy() for s in shapes]


def _fwd_emulated(q, k, v, causal):
    """The bf16 forward kernel's arithmetic in fp32 torch: an online softmax
    over 64-row kv tiles in base 2, l summed from the unrounded p, and P
    rounded to bf16 before the PV product."""
    B, H, Sq, D = q.shape
    n_rep = H // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(n_rep, dim=1)
    vf = v.float().repeat_interleave(n_rep, dim=1)
    scale_log2 = D ** -0.5 * math.log2(math.e)
    m = torch.full((B, H, Sq, 1), -1e30)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, D)
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, k.shape[2], BK):
        s = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2) * scale_log2
        if causal:
            s = s.masked_fill(q_pos < k0 + torch.arange(BK)[None, :], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p.bfloat16().float() @ vf[:, :, k0:k0 + BK]
        m = m_new
    lc = l.clamp_min(1e-30)
    return (acc / lc).to(q.dtype), (m * math.log(2) + torch.log(lc))[..., 0]


def _dkv_emulated(q, k, v, do, lse, delta, causal):
    """The bf16 dk/dv kernel's arithmetic in fp32 torch: Pᵀ and dSᵀ from fp32
    scores, rounded to bf16 before dV += Pᵀ dO and dK += dSᵀ Q, summed over
    the kv head's query group."""
    p, ds, _ = tfa._p_ds(q, k, v, do, lse, delta, causal)
    kvh = k.shape[1]
    dv = tfa._group_sum(
        p.bfloat16().float().transpose(-1, -2) @ do.float(), kvh)
    dk = tfa._group_sum(
        ds.bfloat16().float().transpose(-1, -2) @ q.float(), kvh)
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq_emulated(q, k, v, do, lse, delta, causal):
    """The bf16 dq kernel's arithmetic in fp32 torch: P from fp32 scores,
    dS = P(dP − δ) left unscaled and rounded to bf16 before dq += dS K, and
    the fp32 sum scaled once as dq goes out."""
    s, kf, vf = tfa._scores(q, k, v, causal)
    p = torch.exp(s - lse[..., None])
    dp = do.float() @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    return (ds.bfloat16().float() @ kf * q.shape[3] ** -0.5).to(q.dtype)


def _pallas_bwd(q, k, v, do, causal):
    """Pallas ``_flash_fwd`` then ``_flash_bwd`` (interpret mode) on bf16
    copies of the arrays → ((dq, dk, dv) as jax arrays, and o, lse, δ as the
    torch kernels take them)."""
    jq, jk, jv, jdo = _jax_bf16(q, k, v, do)
    jo, jlse = _flash_fwd(jq, jk, jv, causal=causal, block_q=512,
                          block_k=512)
    grads = _flash_bwd(jq, jk, jv, jo, jlse, jdo, causal=causal,
                       block_q=512, block_k=512)
    o = torch.from_numpy(np.array(jo.astype(jnp.float32))).bfloat16()
    lse = torch.from_numpy(np.asarray(jlse)[..., 0].copy())
    return grads, o, lse


def _jax_bf16(*arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def _torch_bf16(*arrays):
    return [torch.from_numpy(a).bfloat16() for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KVH", [(4, 2), (2, 2)])
def test_forward_rounding_fits_the_pallas_kernel(H, KVH, causal):
    B, S, D = 1, 256, 64
    q, k, v = _bf16(0, (B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))
    jo, jlse = _flash_fwd(*_jax_bf16(q, k, v), causal=causal, block_q=512,
                          block_k=512)
    o, lse = _fwd_emulated(*_torch_bf16(q, k, v), causal)
    assert o.dtype == torch.bfloat16 and lse.shape == (B, H, S)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               atol=TOL_O, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               atol=TOL_LSE, rtol=0)
    # the rounding is visible: the emulation is not the fp32 twin
    o_plain, _ = tfa.flash_attention_fwd_plain(*_torch_bf16(q, k, v), causal)
    assert not torch.equal(o, o_plain)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KVH", [(4, 2), (4, 1)])
def test_dkv_rounding_fits_the_pallas_kernel(H, KVH, causal):
    B, S, D = 1, 256, 64
    q, k, v, do = _bf16(1, (B, H, S, D), (B, KVH, S, D), (B, KVH, S, D),
                        (B, H, S, D))
    (_, jdk, jdv), o, lse = _pallas_bwd(q, k, v, do, causal)
    tq, tk, tv, tdo = _torch_bf16(q, k, v, do)
    delta = tfa._delta(o, tdo)
    dk, dv = _dkv_emulated(tq, tk, tv, tdo, lse, delta, causal)
    for name, got, want in (("dk", dk, jdk), ("dv", dv, jdv)):
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == torch.bfloat16 and got.shape == want.shape, name
        rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert rel <= TOL_GRAD_REL, f"{name}: {rel:.3e}"


@pytest.mark.parametrize("H,KVH,D,causal", [
    (4, 2, 64, True), (4, 2, 64, False), (4, 1, 64, True),
    (4, 1, 64, False),
    (2, 2, 128, True),  # scale 128**-0.5 is no power of 2: its place shows
])
def test_dq_rounding_fits_the_pallas_kernel(H, KVH, D, causal):
    B, S = 1, 256
    q, k, v, do = _bf16(2, (B, H, S, D), (B, KVH, S, D), (B, KVH, S, D),
                        (B, H, S, D))
    (jdq, _, _), o, lse = _pallas_bwd(q, k, v, do, causal)
    tq, tk, tv, tdo = _torch_bf16(q, k, v, do)
    delta = tfa._delta(o, tdo)
    dq = _dq_emulated(tq, tk, tv, tdo, lse, delta, causal)
    want = np.asarray(jdq.astype(jnp.float32))
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    rel = np.abs(dq.float().numpy() - want).max() / np.abs(want).max()
    assert rel <= TOL_GRAD_REL, f"dq: {rel:.3e}"
    # the rounding is visible: the emulation is not the fp32 twin
    plain = tfa.flash_attention_dq_plain(tq, tk, tv, tdo, lse, delta, causal)
    assert not torch.equal(dq, plain)


def _strided(dtype, last, offset=0):
    """A [1, 2, 128, 64] view of a [1, 2, 128, last] buffer, ``offset``
    elements in."""
    buf = torch.zeros(2 * 128 * last + offset, dtype=dtype)
    return buf[offset:].view(1, 2, 128, last)[..., :64]


def test_kernel_args_take_the_paths_views():
    # the [B,S,H,D] layout of both paths, read as [B,H,S,D] views
    for dt in (torch.bfloat16, torch.float32):
        q = torch.zeros(2, 128, 4, 64, dtype=dt).transpose(1, 2)
        k = torch.zeros(2, 128, 2, 64, dtype=dt).transpose(1, 2)
        assert tfa._kernel_args(q, q=q, k=k) == [*q.stride()[:3],
                                                 *k.stride()[:3]]


@pytest.mark.parametrize("dtype,last,offset,ok", [
    (torch.bfloat16, 72, 0, True),     # seq stride 72: divisible by 8
    (torch.bfloat16, 68, 0, False),    # 68 is not
    (torch.float32, 68, 0, True),      # fp32 keeps its rule of 4
    (torch.float32, 66, 0, False),
    (torch.bfloat16, 64, 4, False),    # 8 bytes in: not 16-byte aligned
    (torch.bfloat16, 64, 8, True),     # 16 bytes in
    (torch.float32, 64, 2, False),
])
def test_kernel_args_alignment_rule(dtype, last, offset, ok):
    t = _strided(dtype, last, offset)
    if ok:
        assert tfa._kernel_args(t, t=t) == list(t.stride()[:3])
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa._kernel_args(t, t=t)


@pytest.mark.parametrize("dtype,last,offset,in_place", [
    (torch.bfloat16, 72, 0, True),
    (torch.bfloat16, 68, 0, False),
    (torch.bfloat16, 64, 4, False),
    (torch.float32, 68, 0, True),
])
def test_readable_do_reads_in_place_or_copies(dtype, last, offset,
                                              in_place):
    do = _strided(dtype, last, offset)
    do.copy_(torch.arange(do.numel(), dtype=torch.float32).view(do.shape))
    got = tfa._readable_do(do)
    assert (got.data_ptr() == do.data_ptr()) == in_place
    assert got.data_ptr() % 16 == 0 and torch.equal(got, do)
    tfa._kernel_args(got, do=got)  # what the kernels then accept
    # autograd's dO of the paths' [B,S,H,D] output is read in place
    o = torch.zeros(1, 128, 4, 64, dtype=dtype).transpose(1, 2)
    assert tfa._readable_do(o) is o


def test_rows_copies_only_a_misaligned_lse():
    lse = torch.zeros(1, 2, 128)
    assert tfa._rows(lse) is lse
    shifted = torch.zeros(2 * 128 + 1)[1:].view(1, 2, 128)
    got = tfa._rows(shifted)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, shifted)
