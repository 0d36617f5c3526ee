"""The port's GPipe pipeline against the JAX package's, on the CPU.

The port runs on spawned gloo ranks (``tests/_torch_ranks.py``): each stage
rank holds its stage of the stacked params (DTensors sharded over ``stage``),
activations go to the next stage over point-to-point sends and their
gradients come back over the reverse sends. JAX runs ``pipeline_apply`` and
``make_pipeline_train_step`` in this process on the conftest's virtual CPU
devices. ``tests/test_pipeline.py``'s cases, on the same meshes: (data=2,
stage=4) on 8 ranks and (stage=4) on 4; its stage function (tanh(h @ w +
b), D=16), its init (JAX's ``init_stage_params``, carried across with
``stage_params_from_jax``) and inputs of its shapes drawn with numpy.

- The forward equals the stages applied in sequence at atol=1e-5
  (``test_pipeline.py``'s tolerance) and JAX's ``pipeline_apply`` at the
  same, with the given M and the default M, and an indivisible batch
  raises ``ValueError``.
- The grads of mean((y - t)**2) equal ``jax.grad`` of JAX's pipeline at
  atol=1e-6 (fp32, the same products summed in other orders, here over
  the microbatches and the data ranks).
- One ``make_pipeline_train_step`` step with adamw(1e-3): the loss 1e-6
  relative, each leaf's distance from JAX's within 1e-3 of the norm of its
  update (Adam's first step is lr · g / (|g| + eps), which turns the sums'
  last-digit differences of entries with g near 0 into whole steps); 20
  steps of adam(1e-2) more than halve the loss (``test_pipeline.py``'s
  training test).
- Every stage's ticks run in one process (no mesh, the card's way) equal
  the gloo ring: output and grads at 1e-6.
"""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from ray_tpu.parallel.pipeline import (  # noqa: E402
    init_stage_params, make_pipeline_train_step, pipeline_apply)
from ray_tpu_torch.parallel import pipeline as tp  # noqa: E402
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

D = 16
ATOL_FWD, ATOL_GRAD, LOSS_REL, UPDATE_REL = 1e-5, 1e-6, 1e-6, 1e-3
# name: (mesh shape, axis names, data_axis, rows, microbatches, seed)
MESHES = {"data2_stage4": ((2, 4), ("data", "stage"), ("data",), 16, 8, 0),
          "stage4": ((4,), ("stage",), None, 8, 4, 2)}


def _init_fn(key):
    k1, k2 = jax.random.split(key)
    return {"w": jax.random.normal(k1, (D, D)) * 0.1,
            "b": jax.random.normal(k2, (D,)) * 0.1}


def _stage_fn(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _mse(y, t):
    return jnp.mean((y - t) ** 2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sequential(params, x, n):
    h = x
    for s in range(n):
        h = np.tanh(h @ params["w"][s] + params["b"][s])
    return h


def _jax_side(shape, names, data_axis, x, tgt, M, seed):
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)
    params = init_stage_params(_init_fn, 4, mesh, seed=seed)

    def apply(p, m=M):
        return pipeline_apply(_stage_fn, p, x, mesh, data_axis=data_axis,
                              num_microbatches=m)

    out = {"params": _np(params), "y": np.asarray(apply(params)),
           "y_default_m": np.asarray(pipeline_apply(
               _stage_fn, params, x, mesh, data_axis=data_axis)),
           "grads": _np(jax.grad(lambda p: _mse(apply(p), tgt))(params))}
    tx = optax.adamw(1e-3)
    step = make_pipeline_train_step(_stage_fn, _mse, tx, mesh, params,
                                    data_axis=data_axis, num_microbatches=M)
    (p1, _), m = step((params, tx.init(params)), (x, tgt))
    out["step"] = {"losses": [float(m["loss"])], "params": _np(p1)}
    return out


@pytest.fixture(scope="module", params=sorted(MESHES))
def case(request):
    shape, names, data_axis, rows, M, seed = MESHES[request.param]
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(rows, D)).astype(np.float32)
    tgt = np.full((rows, D), 0.3, np.float32)
    want = _jax_side(shape, names, data_axis, jnp.asarray(x),
                     jnp.asarray(tgt), M, seed)
    port = run_ranks("pipeline", int(np.prod(shape)), {
        "mesh": dict(zip(names, shape)), "data_axis": data_axis,
        "microbatches": M, "params": want["params"], "x": x,
        "target": tgt})
    return x, want, port


def test_gpipe_ticks():
    ticks = tp.gpipe_ticks(4, 4)
    assert len(ticks) == 4 + 4 - 1
    assert ticks[0] == [(0, 0)] and ticks[3] == [(0, 3), (1, 2), (2, 1),
                                                  (3, 0)]
    assert ticks[-1] == [(3, 3)]
    pairs = [p for t in ticks for p in t]
    assert sorted(pairs) == [(s, m) for s in range(4) for m in range(4)]


def test_forward_matches_sequential_and_jax(case):
    x, want, port = case
    assert port["n_stages"] == 4
    ref = _sequential(want["params"], x, 4)
    np.testing.assert_allclose(port["y"], ref, atol=ATOL_FWD)
    np.testing.assert_allclose(port["y"], want["y"], atol=ATOL_FWD)


def test_default_microbatches_and_validation(case):
    x, want, port = case
    np.testing.assert_allclose(port["y_default_m"],
                               _sequential(want["params"], x, 4),
                               atol=ATOL_FWD)
    np.testing.assert_allclose(port["y_default_m"], want["y_default_m"],
                               atol=ATOL_FWD)
    assert port["validation"] and "not divisible" in port["validation"]


def test_grads_match_jax(case):
    _, want, port = case
    for k in ("w", "b"):
        np.testing.assert_allclose(port["grads"][k], want["grads"][k],
                                   atol=ATOL_GRAD)


def test_train_step_matches_jax(case):
    _, want, port = case
    (got,), (ref,) = port["step"]["losses"], want["step"]["losses"]
    assert abs(got - ref) <= LOSS_REL * ref
    for k in ("w", "b"):
        w, w0 = want["step"]["params"][k], want["params"][k]
        assert np.linalg.norm(port["step"]["params"][k] - w) <= \
            UPDATE_REL * np.linalg.norm(w - w0), k


def test_training_converges(case):
    losses = case[2]["train"]["losses"]
    assert len(losses) == 20 and losses[-1] < losses[0] * 0.5


def test_in_process_schedule_equals_ring(case):
    _, _, port = case
    np.testing.assert_allclose(port["in_process"]["y"], port["y"], atol=1e-6)
    for k in ("w", "b"):
        np.testing.assert_allclose(port["in_process"]["grads"][k],
                                   port["grads"][k], atol=1e-6)


def test_num_stages_needs_the_axis():
    class _Mesh:
        mesh_dim_names = ("data",)
        shape = (2,)
    with pytest.raises(ValueError, match="no 'stage' axis"):
        tp.num_stages(_Mesh())
