"""The whole Llama on the dry run's three-dim mesh, against JAX, on the CPU.

``dryrun_multichip(8)``'s first section trains the tiny Llama with
``attn_impl="ring_seq"`` on ``MeshConfig(data=-1, fsdp=2, seq=2,
tensor=2)``: the batch split over fsdp, the sequence over seq, heads and
the MLP over tensor, every weight's embed dim over fsdp. The port runs it
on 8 spawned gloo ranks (``tests/_torch_ranks.py``); JAX runs the same
function on the conftest's 8 virtual CPU devices, on the same mesh, from
the same weights (carried across as numpy through ``params_from_jax``) and
tokens, B=8, S=128, vocab 256, fp32 on both sides.

The port's projections keep batch and sequence apart on this mesh
(``models/llama.py`` ``_proj``): einsum's merged (batch, seq) dim would be
split over two mesh dims, and DTensor's planner took minutes of host time
on each product of it.

Tolerances (those of the ring_seq tests): the loss 1e-5 relative, every
grad atol = rtol = 1e-4; one ``adamw(1e-3)`` step's loss and grad norm
1e-5 relative, and its params by ``_update_close`` (each leaf within 1e-3
of the norm of its update)."""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.parallel import sharding as jsh  # noqa: E402
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_sharded_step import (  # noqa: E402
    _metrics_close, _update_close)
from tests.test_torch_train_step import _batch, _np  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

MESH = dict(data=-1, fsdp=2, seq=2, tensor=2)


def _jcfg():
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=256),
                               dtype=jnp.float32, attn_impl="ring_seq")


@pytest.fixture(scope="module")
def inputs():
    jc = _jcfg()
    return {"params": _np(jl.init_llama(jc, jax.random.PRNGKey(0))),
            "batch": _batch(11, 8, 128, jc.vocab_size), "mesh": MESH}


@pytest.fixture(scope="module")
def port(inputs):
    return run_ranks("mesh3d_step", 8, inputs)


@pytest.fixture(scope="module")
def jax_mesh():
    return create_mesh(MeshConfig(**MESH), devices=jax.devices()[:8])


def test_loss_and_grads_match_jax(inputs, port, jax_mesh):
    jc = _jcfg()
    with jax.set_mesh(jax_mesh):
        params = jax.device_put(inputs["params"], jsh.param_shardings(
            jl.llama_logical_axes(jc), jax_mesh))
        bsh = NamedSharding(jax_mesh, jsh.logical_to_spec(("batch", "seq")))
        batch = {k: jax.device_put(v, bsh)
                 for k, v in inputs["batch"].items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jl.llama_loss(p, b, jc)))(params, batch)
    assert abs(port["loss"] - float(loss)) <= 1e-5 * abs(float(loss))
    flat_w = dict(jax.tree_util.tree_flatten_with_path(_np(grads))[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(port["grads"])[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        np.testing.assert_allclose(flat_g[path], w, atol=1e-4, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_adamw_step_matches_jax(inputs, port, jax_mesh):
    jc = _jcfg()
    tx = optax.adamw(1e-3)
    base = jax.tree.map(jnp.asarray, inputs["params"])
    with jax.set_mesh(jax_mesh):
        state, sh = jts.create_train_state(
            lambda k: base, tx, jax_mesh, jl.llama_logical_axes(jc))
        step = jts.make_train_step(
            lambda p, b: jl.llama_loss(p, b, jc), tx, jax_mesh, sh,
            batch_logical_axes=("batch", "seq"), donate=False)
        state, m = step(state, inputs["batch"])
        want = [(float(m["loss"]), float(m["grad_norm"]), int(m["step"]))]
    _metrics_close(port["step"]["metrics"], want)
    _update_close(port["step"]["params"], _np(state.params),
                  inputs["params"])
