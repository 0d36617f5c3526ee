"""The port's ring attention against the JAX package's, on the CPU.

The port runs on spawned gloo ranks (``tests/_torch_ranks.py``), each
holding its chunk of the sequence, the kv chunks rotating over
point-to-point sends, each hop through the kernels' plain twins
(``flash_attention_fwd_plain`` and the dq / dk-dv twins; on the card, K1-K3).
JAX runs ``ring_attention`` under ``shard_map`` on the conftest's virtual
CPU devices, as ``tests/test_ops.py`` does, from the same inputs.

- P=4, causal, MHA and P=2, non-causal, GQA: the output against JAX's ring
  and against the reference at atol = rtol = 2e-5 (``tests/test_ops.py``'s
  tolerance), the grads of sum(out**2) against ``jax.grad`` of the same at
  atol = rtol = 1e-4; every rank's hop schedule run in one process on the
  same chunks equals the gloo run (1e-6: the same hops, the dk/dv sums in
  another order).
- Llama with ``attn_impl="ring_seq"`` on ``MeshConfig(fsdp=2, seq=2)`` (4
  ranks): the loss (1e-5 relative) and every grad (atol = rtol = 1e-4)
  against JAX's on the same mesh; and Llama's ring_seq layer on the 8-rank
  ``(fsdp=2, seq=2, tensor=2)`` mesh of ``__graft_entry__.dryrun_multichip``
  against JAX's. The whole Llama on that three-dim mesh is held in
  ``tests/test_torch_mesh3d.py``."""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.ops.attention import reference_attention  # noqa: E402
from ray_tpu.ops.ring_attention import ring_attention  # noqa: E402
from ray_tpu.parallel import sharding as jsh  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu_torch.ops import ring_attention as tra  # noqa: E402
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_train_step import _batch, _np  # noqa: E402

CASES = {"p4_causal_mha": dict(P=4, B=2, S=64, H=4, KVH=4, D=16,
                               causal=True, seed=3),
         "p2_full_gqa": dict(P=2, B=2, S=32, H=4, KVH=2, D=8, causal=False,
                             seed=4)}


def _qkv(c):
    rng = np.random.RandomState(c["seed"])
    return tuple(rng.standard_normal((c["B"], c["S"], n, c["D"]))
                 .astype(np.float32) for n in (c["H"], c["KVH"], c["KVH"]))


def _jax_ring(c, q, k, v):
    mesh = Mesh(np.array(jax.devices()[:c["P"]]), ("seq",))
    spec = P(None, "seq", None, None)
    fn = jax.shard_map(
        lambda q, k, v: ring_attention(q, k, v, axis_name="seq",
                                       causal=c["causal"]),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False)
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module", params=sorted(CASES))
def ring_case(request):
    c = CASES[request.param]
    q, k, v = _qkv(c)
    port = run_ranks("ring", c["P"], {"q": q, "k": k, "v": v,
                                      "causal": c["causal"]})
    return c, (q, k, v), port


def test_ring_forward_matches_jax_ring_and_reference(ring_case):
    c, (q, k, v), port = ring_case
    want, _ = _jax_ring(c, q, k, v)
    np.testing.assert_allclose(port["o"], want, atol=2e-5, rtol=2e-5)
    ref = reference_attention(q, k, v, causal=c["causal"])
    np.testing.assert_allclose(port["o"], np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_ring_grads_match_jax(ring_case):
    c, (q, k, v), port = ring_case
    _, grads = _jax_ring(c, q, k, v)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(port[name], g, atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_in_process_schedule_equals_the_gloo_ring(ring_case):
    _, _, port = ring_case
    for name in ("o", "dq", "dk", "dv"):
        np.testing.assert_allclose(port["schedule"][name], port[name],
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("world,causal", [(1, True), (2, True), (4, True),
                                          (3, False), (4, False)])
def test_hop_plan(world, causal):
    """P(P+1)/2 hops over the ring under the causal mask (the diagonal
    masked, later ranks' chunks skipped), P**2 without it."""
    plans = [tra.hop_plan(r, world, causal) for r in range(world)]
    n = sum(len(p) for p in plans)
    assert n == (world * (world + 1) // 2 if causal else world * world)
    for r, plan in enumerate(plans):
        assert plan[0] == (0, r, causal)
        assert [src for _, src, _ in plan] == sorted(
            {src for _, src, _ in plan}, key=lambda s: (r - s) % world)
        assert all(not m for _, src, m in plan if src != r)


def test_ring_seq_llama_matches_jax():
    """Tiny Llama, ``attn_impl="ring_seq"``, remat "full", on (fsdp=2,
    seq=2) over 4 ranks: the loss and every grad against JAX's on the same
    mesh. The port's backward runs on another thread than its forward,
    without the ambient mesh, as autograd runs a CUDA backward: the
    layers' recompute must find the mesh from its DTensors."""
    mesh_kw = dict(data=-1, fsdp=2, seq=2)
    jc = dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                             attn_impl="ring_seq", remat=True,
                             remat_policy="full")
    params = _np(jl.init_llama(jc, jax.random.PRNGKey(0)))
    batch = _batch(5, 4, 32, jc.vocab_size)
    port = run_ranks("ring_llama", 4, {"params": params, "batch": batch,
                                       "mesh": mesh_kw})

    mesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:4])
    with jax.set_mesh(mesh):
        jparams = jax.device_put(
            params, jsh.param_shardings(jl.llama_logical_axes(jc), mesh))
        bsh = NamedSharding(mesh, jsh.logical_to_spec(("batch", "seq")))
        jbatch = {k: jax.device_put(v, bsh) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jl.llama_loss(p, b, jc)))(jparams, jbatch)
    assert abs(port["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(_np(grads))[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(port["grads"])[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        np.testing.assert_allclose(flat_g[path], w, atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_ring_seq_layer_on_the_dryrun_mesh_matches_jax():
    """Llama's ring_seq attention layer (``_ring_seq_attention``) on the
    8-rank (fsdp=2, seq=2, tensor=2) mesh of ``dryrun_multichip``: q, k, v
    split over batch, seq and heads, the ring on each (fsdp, tensor)
    position's seq sub-group; the output (2e-5) and the grads of sum(out**2)
    (1e-4) against JAX's layer under the same mesh."""
    mesh_kw = dict(data=-1, fsdp=2, seq=2, tensor=2)
    rng = np.random.RandomState(8)
    q, k, v = (rng.standard_normal((4, 32, n, 16)).astype(np.float32)
               for n in (4, 2, 2))
    port = run_ranks("ring_layer", 8, {"q": q, "k": k, "v": v,
                                       "mesh": mesh_kw})

    mesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:8])
    with jax.set_mesh(mesh):
        put = [jax.device_put(t, NamedSharding(mesh, jsh.logical_to_spec(
            ("batch", "seq", h, "head_dim"))))
            for t, h in ((q, "heads"), (k, "kv_heads"), (v, "kv_heads"))]
        fn = jl._ring_seq_attention
        out = jax.jit(fn)(*put)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) ** 2),
                                 argnums=(0, 1, 2)))(*put)
    np.testing.assert_allclose(port["o"], np.asarray(out), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(
        port["o"], np.asarray(reference_attention(q, k, v, causal=True)),
        atol=2e-5, rtol=2e-5)
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(port[name], np.asarray(g), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
