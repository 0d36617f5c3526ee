"""The port's expert-parallel MoE against the JAX package's, on the CPU.

The port runs on spawned gloo ranks (``tests/_torch_ranks.py``), its params
DTensors placed by ``moe_logical_axes`` on a (data, expert) ``DeviceMesh``;
JAX runs the same train step in this process on the conftest's virtual CPU
devices, on a mesh of the same shape (``tests/test_models_parallel.py``'s
``test_expert_parallel_training_step``: ``MoEConfig.tiny``, tokens from
``default_rng(0)`` of shape (8, 17), ``adamw(1e-3)``), from the same
weights (JAX's ``init_moe``, carried across with ``moe_params_from_jax``),
in fp32 on both sides so that the routing cannot differ.

Meshes: (data=2, expert=4) on 8 ranks and (data=1, expert=4) on 4. Under
the default rules the batch rides ``data``, not ``expert``, so every expert
rank holds its data shard's tokens whole: the dispatch keeps each rank's own
experts' slots and the combine is a sum over ``expert``.

Tolerances are ``tests/test_torch_moe.py``'s fp32 ones (the sums run in
other orders, here also over other partial sums): the first step's loss
1e-6 relative, its grads 1e-5 of each leaf's largest entry, the losses of 3
AdamW steps 1e-4 relative, each leaf's distance from JAX's after them
within 1e-3 of the norm of its update."""

import dataclasses
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402

from ray_tpu.models import moe as jm  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
from ray_tpu.parallel.train_step import (  # noqa: E402
    create_train_state, make_train_step)
from ray_tpu_torch.models import moe as tm  # noqa: E402
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

TOL_LOSS, TOL_GRAD, TOL_STEPS, TOL_UPDATE = 1e-6, 1e-5, 1e-4, 1e-3
MESHES = {"data2_expert4": dict(data=2, expert=4),
          "data1_expert4": dict(data=1, expert=4)}


def _jcfg():
    return dataclasses.replace(jm.MoEConfig.tiny(), dtype=jnp.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_named(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _rel_max(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def inputs():
    cfg = _jcfg()
    params = _np(jax.jit(lambda k: jm.init_moe(cfg, k))(jax.random.key(0)))
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 17)).astype(np.int32)
    return {"params": params,
            "batch": {"inputs": toks[:, :-1], "targets": toks[:, 1:]}}


def _jax_run(mesh_kw, inputs):
    """JAX's EP step on the mesh: the first step's loss and grads (a jitted
    grad over the placed params), then 3 steps' (loss, grad norm, step) and
    the params after them, the we_gate spec."""
    cfg = _jcfg()
    n = mesh_kw["data"] * mesh_kw["expert"]
    mesh = create_mesh(MeshConfig(fsdp=1, **mesh_kw),
                       devices=jax.devices()[:n])
    tx = optax.adamw(1e-3)
    base = jax.tree.map(jnp.asarray, inputs["params"])
    batch = jax.tree.map(jnp.asarray, inputs["batch"])
    with jax.set_mesh(mesh):
        state, sh = create_train_state(lambda k: base, tx, mesh,
                                       jm.moe_logical_axes(cfg))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jm.moe_loss(p, batch, cfg)))(state.params)
        step = make_train_step(lambda p, b: jm.moe_loss(p, b, cfg), tx, mesh,
                               sh, batch_logical_axes=("batch", "seq"))
        metrics = []
        for _ in range(3):
            state, m = step(state, inputs["batch"])
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
    return {"loss": float(loss), "grads": _np(grads), "metrics": metrics,
            "params": _np(state.params),
            "spec": state.params["layers"]["we_gate"].sharding.spec}


@pytest.fixture(scope="module", params=sorted(MESHES))
def case(request, inputs):
    mesh_kw = MESHES[request.param]
    world = mesh_kw["data"] * mesh_kw["expert"]
    port = run_ranks("moe_ep", world, {"mesh": mesh_kw, **inputs})
    return mesh_kw, port, _jax_run(mesh_kw, inputs)


def test_moe_logical_axes_match_jax():
    assert tm.moe_logical_axes(tm.MoEConfig.tiny()) == \
        jm.moe_logical_axes(jm.MoEConfig.tiny())


def test_expert_leaves_sharded_on_the_expert_dim(case):
    """Every ``we_*`` leaf (L, E, ...) is Shard(1) over ``expert``, as JAX
    asserts ``spec[1] == "expert"``; the router's expert dim too; the
    experts' input and output are cut along E over ``expert``."""
    mesh_kw, port, want = case
    assert want["spec"][1] == "expert"
    names = [a for a in ("data", "expert") if mesh_kw[a] > 1]
    assert port["mesh"] == names
    for leaf in ("we_gate", "we_up", "we_down"):
        assert dict(port["placements"][leaf])["expert"] == "Shard(dim=1)"
    assert dict(port["placements"]["router"])["expert"] == "Shard(dim=2)"
    assert dict(port["placements"]["wq"])["expert"] == "Replicate()"
    e = names.index("expert")
    assert port["constrained"] and all(
        p[e] == "Shard(dim=0)" for p in port["constrained"])


def test_first_step_loss_and_grads_match_jax(case):
    _, port, want = case
    assert abs(port["loss"] - want["loss"]) <= TOL_LOSS * want["loss"]
    got, ref = _named(port["grads"]), _named(want["grads"])
    assert got.keys() == ref.keys()
    for name, w in ref.items():
        assert _rel_max(got[name], w) < TOL_GRAD, name


def test_adamw_steps_match_jax(case, inputs):
    _, port, want = case
    got = port["metrics"]
    assert [s for _, _, s in got] == [1, 2, 3]
    np.testing.assert_allclose([(l, g) for l, g, _ in got],
                               [(l, g) for l, g, _ in want["metrics"]],
                               rtol=TOL_STEPS)
    assert got[-1][0] < got[0][0]
    init = _named(inputs["params"])
    final = _named(port["params"])
    for name, w in _named(want["params"]).items():
        upd = np.linalg.norm(w - init[name])
        assert np.linalg.norm(final[name] - w) <= TOL_UPDATE * upd, name


def test_no_view_merges_a_sharded_dim_inside(case):
    """No view or reshape of the MoE's step (the first loss and backward,
    then 3 steps of ``make_train_step``) merges a sharded dim other than as
    the outer one of the merge: torch 2.11's DTensor refuses such a view
    ("Attempted to flatten multiple dimensions, with dimension 2 being
    sharded"), where the torch here allows it. Before the repair the
    combine's einsum merged (C, E) with E sharded over ``expert``."""
    _, port, _ = case
    assert port["views_checked"] > 100
    assert port["sharded_inner_merges"] == []
