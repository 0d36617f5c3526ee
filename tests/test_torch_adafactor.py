"""ray_tpu_torch's ``adafactor`` against ``optax.adafactor``, and the dense
Adafactor train step under remat "dots" against the JAX package's, on the
CPU.

Params and gradients are drawn with numpy from a seed and given to both. The
leaves cover every branch of optax's factoring rule: a stacked 4-D leaf
whose two largest dims are not the last two, a factored 2-D leaf, a 3-D leaf
with two equal largest dims, a 2-D leaf whose second-largest dim is under
128 and a 1-D leaf.
"""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from optax._src.factorized import _factored_dims  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu_torch._private.tree import tree_leaves, tree_map  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.parallel import optim as topt  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

LEAVES = {"stacked": (2, 256, 4, 128), "matrix": (256, 192),
          "tied": (130, 130, 3), "small": (64, 100), "vector": (300,)}
# bench.py's dense rung (hidden 2048, mlp 5632, 17 layers, 16 heads of 128)
DENSE = dict(vocab_size=32000, hidden=2048, mlp_hidden=5632, num_layers=17,
             num_heads=16, num_kv_heads=16, head_dim=128, max_seq_len=2048)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_shapes():
    """Leaf shapes of the dense rung's param tree, by name."""
    jc = dataclasses.replace(jl.LlamaConfig(), **DENSE)
    shapes = jax.eval_shape(lambda k: jl.init_llama(jc, k),
                            jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {jax.tree_util.keystr(p): tuple(s.shape) for p, s in flat}


def test_factored_dims_match_optax_at_the_dense_rung():
    shapes = _dense_shapes()
    for name, shape in shapes.items():
        assert topt.factored_dims(shape) == _factored_dims(shape, True, 128), \
            name
    # the two largest dims of the whole stacked leaf, not the last two
    assert topt.factored_dims(shapes["['layers']['wq']"]) == (3, 1)
    assert topt.factored_dims(shapes["['layers']['wo']"]) == (2, 3)
    assert topt.factored_dims(shapes["['layers']['w_gate']"]) == (1, 2)
    assert topt.factored_dims(shapes["['embed']"]) == (1, 0)
    assert topt.factored_dims(shapes["['layers']['attn_norm']"]) is None


@pytest.mark.parametrize("shape", list(LEAVES.values()) + [(17, 2048),
                                                            (128, 128)])
def test_factored_dims_match_optax(shape):
    assert topt.factored_dims(shape) == _factored_dims(shape, True, 128)
    assert topt.factored_dims(shape, factored=False) is None
    assert topt.factored_dims(shape, min_dim_size_to_factor=8) == \
        _factored_dims(shape, True, 8)


@pytest.mark.parametrize("kw", [
    {},
    {"momentum": 0.9, "weight_decay_rate": 1e-2,
     "multiply_by_parameter_scale": False, "clipping_threshold": None},
    {"factored": False, "decay_rate": 0.5},
], ids=["defaults", "momentum-decay-noscale-noclip", "unfactored"])
def test_adafactor_matches_optax(kw):
    """5 updates on identical grads: the params and the second-moment state
    after each. Both sides compute in fp32, with means and norms summed in
    other orders: ~2e-7 relative was seen; 1e-6 holds it."""
    rng = np.random.RandomState(12)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in LEAVES.items()}
    tx = optax.adafactor(0.1, **kw)
    jp = jax.tree.map(jnp.asarray, p)
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in p.items()}
    opt = topt.adafactor(0.1, **kw)(tp)
    for i in range(5):
        # grads whose scale moves from step to step, so that the decay and
        # the clipping both show
        g = {k: (rng.standard_normal(s) * (1 + 2 * i)).astype(np.float32)
             for k, s in LEAVES.items()}
        upd, jstate = update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        opt.step()
        for k in p:
            want = np.asarray(jp[k])
            got = tp[k].detach().numpy()
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-6, (i, k, err)
    fstate = jstate[0]
    for k in p:
        st = opt.state[tp[k]]
        dims = topt.factored_dims(LEAVES[k], kw.get("factored", True))
        names = ("v",) if dims is None else ("v_row", "v_col")
        assert st["step"] == 5 and set(names) <= set(st)
        for name in names:
            want = np.asarray(getattr(fstate, name)[k])
            got = st[name].numpy()
            assert got.shape == want.shape and got.dtype == np.float32
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), \
                (k, name)


def test_adafactor_state_is_fp32_for_bf16_params():
    rng = np.random.RandomState(13)
    w = torch.from_numpy(rng.standard_normal((256, 192)).astype(np.float32))
    p = w.bfloat16().requires_grad_(True)
    opt = topt.adafactor(1e-2)([p])
    p.grad = torch.from_numpy(
        rng.standard_normal((256, 192)).astype(np.float32)).bfloat16()
    before = p.detach().clone()
    opt.step()
    st = opt.state[p]
    assert st["v_row"].dtype == st["v_col"].dtype == torch.float32
    assert p.dtype == torch.bfloat16 and not torch.equal(p.detach(), before)
    with pytest.raises(ValueError, match="closure"):
        opt.step(lambda: 0.0)


def _cfgs():
    """tiny in fp32 with remat "dots", for both packages. Its embedding,
    lm-head and MLP leaves are factored ([256, 128], [2, 128, 352], ...);
    its attention and norm leaves are not."""
    kw = dict(remat=True, remat_policy="dots")
    return (dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32,
                                **kw),
            dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                                **kw))


def test_dense_adafactor_train_step_matches_jax():
    """3 dense steps of llama_loss with adafactor(1e-3) and remat "dots":
    loss and grad norm within 1e-4 relative, as test_train_step_matches_jax
    holds the AdamW step, and each leaf's update within 1e-3 of its norm."""
    jc, tc = _cfgs()
    rng = np.random.RandomState(14)
    tok = rng.randint(0, jc.vocab_size, (4, 17)).astype(np.int32)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    tx = optax.adafactor(1e-3)
    with jax.set_mesh(mesh):
        jstate, sh = jts.create_train_state(
            lambda k: jl.init_llama(jc, k), tx, mesh,
            jl.llama_logical_axes(jc))
        jstep = jts.make_train_step(
            lambda p, bb: jl.llama_loss(p, bb, jc), tx, mesh, sh,
            batch_logical_axes=("batch", "seq"), donate=False)
        init = jax.tree.map(np.asarray, jstate.params)
        want = []
        for _ in range(3):
            jstate, m = jstep(jstate, batch)
            want.append((float(m["loss"]), float(m["grad_norm"])))
        want_params = jax.tree.map(np.asarray, jstate.params)
    state = tts.create_train_state(lambda g: tl.params_from_jax(init),
                                   topt.adafactor(1e-3), device="cpu")
    step = tts.make_train_step(lambda p, bb: tl.llama_loss(p, bb, tc),
                               topt.adafactor(1e-3))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    got = []
    for _ in range(3):
        state, m = step(state, tb)
        got.append((m["loss"].item(), m["grad_norm"].item()))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= 1e-4 * abs(wl), (got, want)
        assert abs(gn - wn) <= 1e-4 * abs(wn), (got, want)
    flat = [dict(jax.tree_util.tree_flatten_with_path(t)[0]) for t in (
        tree_map(lambda t: t.detach().numpy(), state.params), want_params,
        init)]
    for path, w in flat[1].items():
        g, w0 = flat[0][path], flat[2][path]
        assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w - w0), \
            jax.tree_util.keystr(path)
    # the factored leaves kept row and column statistics only
    opt = state.opt_state
    kinds = {tuple(p.shape): set(opt.state[p]) - {"step"}
             for p in tree_leaves(state.params)}
    assert kinds[(256, 128)] == {"v_row", "v_col"}
    assert kinds[(2, 128, 4, 32)] == {"v"}


def test_dense_rung_arithmetic_matches_jax():
    """bench.py's dense rung: ~1.005B params, 6.88 GFLOP a token at S=2048,
    the same in both packages."""
    jc = dataclasses.replace(jl.LlamaConfig(), **DENSE)
    tc = dataclasses.replace(tl.LlamaConfig(), **DENSE)
    assert tc.num_params() == jc.num_params()
    assert abs(tc.num_params() / 1e9 - 1.005) < 1e-3
    assert tc.flops_per_token(2048) == jc.flops_per_token(2048)
    assert abs(tc.flops_per_token(2048) / 1e9 - 6.88) < 1e-2
    assert (tc.remat, tc.remat_policy, tc.loss_chunk) == (True, "dots", 0)


def test_stacked_layer_grads_are_written_once():
    """The layers' weights reach the layers through one ``unbind`` per
    stacked leaf, whose backward stacks their grads once (as the
    reference's scan writes them): no per-layer ``select``, whose backward
    is a zero-filled grad of the whole stack added once a layer."""
    _, tc = _cfgs()
    params = tl.init_llama(dataclasses.replace(tc, num_layers=3),
                           torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    params = tree_map(lambda t: t.requires_grad_(True), params)
    tok = torch.randint(0, tc.vocab_size, (1, 9))
    loss = tl.llama_loss(params, {"tokens": tok},
                         dataclasses.replace(tc, num_layers=3))
    seen, stack, kinds = set(), [loss.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        kinds.append(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    assert "SelectBackward0" not in kinds
    assert kinds.count("UnbindBackward0") == len(params["layers"])
