"""The port's sharded train step against the JAX package's, on the CPU.

The port runs on 4 spawned gloo ranks (``tests/_torch_ranks.py``), its
params DTensors on a ``DeviceMesh``; JAX runs ``make_train_step`` in this
process on 4 of the conftest's 8 virtual CPU devices, on the same mesh
shape, from the same weights (carried across as numpy through
``params_from_jax`` / ``lora_from_jax`` and placed by ``shard_pytree``) and
the same tokens. Tiny Llama in fp32:

- 3 AdamW steps on ``MeshConfig(data=-1, fsdp=2, tensor=2)``; the state
  through ``train_state_tree`` / ``load_train_state`` (its next step equal
  to the continued one's), and ``make_eval_step`` on the loaded params;
- ``grad_accum=2`` against 1 on ``MeshConfig(data=-1)`` (data=4);
- 3 LoRA steps on (fsdp=2, tensor=2) with the frozen base placed by
  ``frozen_logical_axes``;
- 3 Adafactor steps on ``MeshConfig(data=-1, fsdp=4)``, its factored
  moments replicated;
- ``TorchTrainer`` with 2 CPU workers on ``MeshConfig(data=-1)`` equals one
  process over the doubled batch, with no all_reduce in the loop.

Tolerances (fp32 on both sides; the sums run in other orders and, on the
mesh, over other partial sums): the first step's loss and grad norm 1e-5
relative; later steps' 1e-4 relative, since an Adam update divides each
gradient by its own running magnitude and so grows the summation
differences of near-zero entries; the params after the steps by
``_update_close``: each leaf's distance from JAX's within 1e-3 of the norm
of its update."""

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

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.parallel import train_step as jts  # noqa: E402
from ray_tpu.parallel.mesh import MeshConfig, create_mesh  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.parallel import optim as topt  # noqa: E402
from ray_tpu_torch.parallel import train_step as tts  # noqa: E402
from tests._torch_ranks import run_ranks  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_train_step import (  # noqa: E402
    ALL_TARGETS, _batch, _jax_lora, _np, _tb)
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

LOSS_REL_FIRST, LOSS_REL, UPDATE_REL = 1e-5, 1e-4, 1e-3


def _jcfg():
    return dataclasses.replace(jl.LlamaConfig.tiny(), dtype=jnp.float32)


def _jax_run(mesh_kw, tx, batch, n, *, params, accum=1, lora=None):
    """n JAX steps on 4 virtual devices: (metrics, final params, eval loss
    of the final params)."""
    jc = _jcfg()
    mesh = create_mesh(MeshConfig(**mesh_kw), devices=jax.devices()[:4])
    base = jax.tree.map(jnp.asarray, params)
    with jax.set_mesh(mesh):
        if lora is None:
            state, sh = jts.create_train_state(
                lambda k: base, tx, mesh, jl.llama_logical_axes(jc))
            loss = lambda p, b: jl.llama_loss(p, b, jc)  # noqa: E731
            step = jts.make_train_step(
                loss, tx, mesh, sh, batch_logical_axes=("batch", "seq"),
                grad_accum=accum, donate=False)
        else:
            lcfg = jl.LoraConfig(rank=4, targets=ALL_TARGETS)
            adapters = jax.tree.map(jnp.asarray, lora)
            state, sh = jts.create_train_state(
                lambda k: adapters, tx, mesh, jl.lora_logical_axes(jc, lcfg))
            step = jts.make_train_step(
                lambda lo, b, fz: jl.llama_lora_loss(fz, lo, b, jc, lcfg),
                tx, mesh, sh, batch_logical_axes=("batch", "seq"),
                frozen=base, frozen_logical_axes=jl.llama_logical_axes(jc),
                donate=False)
        metrics = []
        for _ in range(n):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            int(m["step"])))
        ev = None
        if lora is None:
            ev = float(jts.make_eval_step(
                loss, mesh, sh, batch_logical_axes=("batch", "seq"))(
                    state.params, batch))
    return metrics, _np(state.params), ev


@pytest.fixture(scope="module")
def inputs():
    jc = _jcfg()
    params = _np(jl.init_llama(jc, jax.random.PRNGKey(0)))
    lcfg = jl.LoraConfig(rank=4, targets=ALL_TARGETS)
    return {"params": params, "lora": _np(_jax_lora(jc, lcfg, 3)),
            "batch": _batch(21, 8, 16, jc.vocab_size),
            "targets": ALL_TARGETS}


@pytest.fixture(scope="module")
def port(inputs):
    """Every case of the port, in one run of 4 gloo ranks."""
    return run_ranks("sharded_step", 4, inputs)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, np.asarray(tree))]


def _update_close(got, want, init, rel=UPDATE_REL):
    for (path, g), (_, w), (_, w0) in zip(_flat(got), _flat(want),
                                          _flat(init)):
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w - w0), path


def _metrics_close(got, want):
    assert len(got) == len(want)
    for i, ((gl, gn, gs), (wl, wn, ws)) in enumerate(zip(got, want)):
        rel = LOSS_REL_FIRST if i == 0 else LOSS_REL
        assert abs(gl - wl) <= rel * abs(wl), (got, want)
        assert abs(gn - wn) <= rel * abs(wn), (got, want)
        assert gs == ws


def test_dense_adamw_fsdp_tensor_matches_jax(inputs, port):
    want, want_params, want_eval = _jax_run(
        dict(data=-1, fsdp=2, tensor=2), optax.adamw(3e-3), inputs["batch"],
        3, params=inputs["params"])
    _metrics_close(port["dense"]["metrics"], want)
    _update_close(port["dense"]["params"], want_params, inputs["params"])
    assert abs(port["eval"] - want_eval) <= LOSS_REL * abs(want_eval)


def test_sharded_state_round_trips_train_state_tree(port):
    """The sharded state through ``train_state_tree`` (gathered with
    ``full_tensor``) and ``load_train_state`` (placed again): the AdamW
    moments back on their param's placements, and the resumed step equal
    to the continued one."""
    r = port["resume"]
    assert r["resumed"] == r["continued"]
    assert r["placed"] and all(r["placed"])


def test_grad_accum_2_matches_1(inputs, port):
    """On data=4: grad_accum=2 over 8 rows equals grad_accum=1 over the
    same rows, and both equal JAX's step."""
    want, want_params, _ = _jax_run(dict(data=-1), optax.adamw(3e-3),
                                    inputs["batch"], 1,
                                    params=inputs["params"])
    for accum in ("accum1", "accum2"):
        _metrics_close(port[accum]["metrics"], want)
        _update_close(port[accum]["params"], want_params, inputs["params"])
    _update_close(port["accum2"]["params"], port["accum1"]["params"],
                  inputs["params"])


def test_lora_step_with_placed_frozen_base_matches_jax(inputs, port):
    want, want_params, _ = _jax_run(
        dict(data=-1, fsdp=2, tensor=2), optax.adamw(3e-3), inputs["batch"],
        3, params=inputs["params"], lora=inputs["lora"])
    _metrics_close(port["lora"]["metrics"], want)
    _update_close(port["lora"]["params"], want_params, inputs["lora"])


def test_adafactor_fsdp4_matches_jax(inputs, port):
    want, want_params, _ = _jax_run(dict(data=-1, fsdp=4),
                                    optax.adafactor(1e-2), inputs["batch"],
                                    3, params=inputs["params"])
    _metrics_close(port["adafactor"]["metrics"], want)
    _update_close(port["adafactor"]["params"], want_params, inputs["params"])
    placed = port["adafactor"]["state_placed"]
    assert placed and all(placed)


@pytest.fixture(scope="module")
def port_cluster():
    key = "RAY_TPU_TORCH_TRAIN_RESULT_TIMEOUT_S"
    old = os.environ.get(key)
    os.environ[key] = "120"
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    if old is None:
        os.environ.pop(key, None)
    else:
        os.environ[key] = old
    port_session_leak_check(session_dir)


def test_trainer_data_mesh_equals_one_process_on_doubled_batch(
        inputs, port_cluster):
    """2 gloo workers, each building ``MeshConfig(data=-1)`` over the
    trainer's group and stepping on the doubled batch: the step shards the
    batch over data and averages the grads itself; the losses and grad
    norms equal one process's (no mesh) over the doubled batch."""
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    def loop(config):
        import dataclasses

        import numpy as np
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models import llama as tl
        from ray_tpu_torch.parallel import optim as topt
        from ray_tpu_torch.parallel import train_step as tts
        from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

        torch.set_num_threads(1)
        cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
        mesh = create_mesh(MeshConfig(data=-1), device="cpu")
        tx = topt.adamw(3e-3)
        state = tts.create_train_state(
            lambda g: tl.params_from_jax(config["params"]), tx, mesh,
            tl.llama_logical_axes(cfg), device="cpu")
        step = tts.make_train_step(lambda p, b: tl.llama_loss(p, b, cfg),
                                   tx, mesh,
                                   batch_logical_axes=("batch", "seq"))
        batch = {k: torch.from_numpy(v.astype(np.int64))
                 for k, v in config["batch"].items()}
        history = []
        for _ in range(config["steps"]):
            state, m = step(state, batch)
            history.append((float(m["loss"]), float(m["grad_norm"])))
            train.report({"history": list(history),
                          "mesh": [mesh.mesh_dim_names,
                                   tuple(map(int, mesh.shape))]})

    doubled = {k: np.concatenate([v, v[::-1]]) for k, v in
               inputs["batch"].items()}
    steps = 2
    result = TorchTrainer(
        loop, train_loop_config={"params": inputs["params"],
                                 "batch": doubled, "steps": steps},
        scaling_config=ScalingConfig(num_workers=2, use_gpu=False)).fit()
    assert result.error is None, result.error
    got = [tuple(h) for h in result.metrics["history"]]
    assert [tuple(x) for x in result.metrics["mesh"]] == [("data",), (2,)]

    cfg = dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32)
    tx = topt.adamw(3e-3)
    state = tts.create_train_state(lambda g: tl.params_from_jax(
        inputs["params"]), tx, device="cpu")
    step = tts.make_train_step(lambda p, b: tl.llama_loss(p, b, cfg), tx)
    want = []
    for _ in range(steps):
        state, m = step(state, _tb(doubled))
        want.append((m["loss"].item(), m["grad_norm"].item()))
    assert len(got) == steps
    for i, ((gl, gn), (wl, wn)) in enumerate(zip(got, want)):
        rel = LOSS_REL_FIRST if i == 0 else LOSS_REL
        assert abs(gl - wl) <= rel * abs(wl), (got, want)
        assert abs(gn - wn) <= rel * abs(wn), (got, want)
