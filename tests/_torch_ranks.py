"""Run a scenario of the port on several gloo ranks, on the CPU.

``run_ranks(name, world, inputs)`` spawns ``world`` processes (torch's
``spawn`` start method), joins them in a gloo process group over a free
``localhost`` port, and runs ``SCENARIOS[name](rank, world, inputs)`` in each;
rank 0's return value comes back. Inputs and outputs are numpy arrays in
plain containers. This module imports torch, numpy and ``ray_tpu_torch`` only
(never jax): the spawned ranks import it by name."""

from __future__ import annotations

import copy
import dataclasses
import faulthandler
import os
import pickle
import socket
import tempfile
import threading
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, name, tmp):
    # a wedged rank prints its stack and exits, which fails the run
    faulthandler.dump_traceback_later(
        float(os.environ.get("TORCH_RANKS_WATCHDOG_S", "240")), exit=True)
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "in.pkl"), "rb") as f:
        inputs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = SCENARIOS[name](rank, world, inputs)
        if rank == 0:
            with open(os.path.join(tmp, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(name: str, world: int, inputs: Dict[str, Any]) -> Any:
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "in.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        mp.start_processes(_entry, args=(world, _free_port(), name, tmp),
                           nprocs=world, start_method="spawn")
        with open(os.path.join(tmp, "out.pkl"), "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------- helpers

def _np(tree):
    """A tree of tensors (DTensors gathered with ``full_tensor``) as
    numpy."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    return tree.detach().numpy().copy()


def _tb(batch):
    """Numpy batch → torch (token ids as int64)."""
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _tiny(**kw):
    from ray_tpu_torch.models import llama as tl

    return dataclasses.replace(tl.LlamaConfig.tiny(), dtype=torch.float32,
                               **kw)


def _run_steps(step, state, batch, n):
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        int(m["step"])))
    return state, metrics


# -------------------------------------------------------------- scenarios

def sharded_step(rank, world, inp):
    """The sharded train step's cases on 4 ranks: dense AdamW on
    (fsdp=2, tensor=2), grad_accum 2 against 1 on data=4, the LoRA step
    with a frozen base placed by ``llama_logical_axes``, Adafactor on
    fsdp=4, and the eval step."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel import optim as topt
    from ray_tpu_torch.parallel import train_step as tts
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from torch.distributed.tensor import DTensor, Replicate

    cfg = _tiny()
    axes = tl.llama_logical_axes(cfg)
    batch = _tb(inp["batch"])
    out = {}

    def dense(mesh, tx, n, accum=1, params="params"):
        state = tts.create_train_state(
            lambda g: tl.params_from_jax(inp[params]), tx, mesh, axes,
            device="cpu")
        step = tts.make_train_step(lambda p, b: tl.llama_loss(p, b, cfg),
                                   tx, mesh, batch_logical_axes=("batch",
                                                                 "seq"),
                                   grad_accum=accum)
        return _run_steps(step, state, batch, n)

    ft = create_mesh(MeshConfig(data=-1, fsdp=2, tensor=2), device="cpu")
    state, m = dense(ft, topt.adamw(3e-3), 3)
    out["dense"] = dict(metrics=m, params=_np(state.params))
    # the state through train_state_tree (gathered to full tensors, copied
    # as a checkpoint would) and load_train_state (placed again): its next
    # step equals the continued one's
    tree = copy.deepcopy(tts.train_state_tree(state))
    tx = topt.adamw(3e-3)
    resumed = tts.load_train_state(tree, tx, ft, axes, device="cpu")
    eval_step = tts.make_eval_step(lambda p, b: tl.llama_loss(p, b, cfg), ft,
                                   batch_logical_axes=("batch", "seq"))
    out["eval"] = float(eval_step(resumed.params, batch))
    step = tts.make_train_step(lambda p, b: tl.llama_loss(p, b, cfg), tx,
                               ft, batch_logical_axes=("batch", "seq"))
    _, m_res = _run_steps(step, resumed, batch, 1)
    state, m_cont = _run_steps(step, state, batch, 1)
    leaf = resumed.params["layers"]["wq"]
    out["resume"] = dict(
        resumed=m_res, continued=m_cont,
        placed=[tuple(v.placements) == tuple(leaf.placements)
                for k, v in resumed.opt_state.state[leaf].items()
                if k != "step"] + [not any(
                    isinstance(pl, Replicate) for pl in leaf.placements)])

    dp = create_mesh(MeshConfig(data=-1), device="cpu")
    for accum in (1, 2):
        state, m = dense(dp, topt.adamw(3e-3), 1, accum)
        out[f"accum{accum}"] = dict(metrics=m, params=_np(state.params))

    lcfg = tl.LoraConfig(rank=4, targets=inp["targets"])
    tx = topt.adamw(3e-3)
    state = tts.create_train_state(
        lambda g: tl.lora_from_jax(inp["lora"]), tx, ft,
        tl.lora_logical_axes(cfg, lcfg), device="cpu")
    step = tts.make_train_step(
        lambda lo, b, fz: tl.llama_lora_loss(fz, lo, b, cfg, lcfg), tx, ft,
        batch_logical_axes=("batch", "seq"),
        frozen=tl.params_from_jax(inp["params"]), frozen_logical_axes=axes)
    state, m = _run_steps(step, state, batch, 3)
    out["lora"] = dict(metrics=m, params=_np(state.params))

    f4 = create_mesh(MeshConfig(data=-1, fsdp=4), device="cpu")
    state, m = dense(f4, topt.adafactor(1e-2), 3, params="params")
    factored = []
    for p, st in state.opt_state.state.items():
        for k in ("v_row", "v_col"):
            if k in st:
                factored.append(isinstance(st[k], DTensor) and all(
                    isinstance(pl, Replicate) for pl in st[k].placements))
        if "v" in st:
            factored.append(tuple(st["v"].placements) == tuple(p.placements))
    out["adafactor"] = dict(metrics=m, params=_np(state.params),
                            state_placed=factored)
    return out


def _chunks(x, world):
    return list(torch.from_numpy(x).chunk(world, dim=1))


def ring(rank, world, inp):
    """Ring attention over the gloo world: each rank's seq chunk; the
    output and the grads of sum(out**2), gathered; rank 0 also runs every
    rank's hop schedule in process on the same chunks."""
    from ray_tpu_torch.ops import ring_attention as ra
    from ray_tpu_torch.ops.cuda import flash_attention as fa

    causal = inp["causal"]
    q, k, v = (_chunks(inp[n], world)[rank].clone().requires_grad_(True)
               for n in ("q", "k", "v"))
    o = ra.ring_attention(q, k, v, causal=causal, group=dist.group.WORLD)
    (o.float() ** 2).sum().backward()

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=1).numpy()

    out = {"o": gather(o.detach()), "dq": gather(q.grad),
           "dk": gather(k.grad), "dv": gather(v.grad)}
    if rank == 0:
        qs, ks, vs = (_chunks(inp[n], world) for n in ("q", "k", "v"))
        T = [[t.transpose(1, 2) for t in c] for c in (qs, ks, vs)]
        os_, dq_, dk_, dv_ = [], [], [None] * world, [None] * world
        for r in range(world):
            kv = [(T[1][(r - j) % world], T[2][(r - j) % world])
                  for j in range(world)]
            o_r, lse = ra.ring_fwd_schedule(T[0][r], r, world, kv, causal)
            o_r = o_r.to(T[0][r].dtype)
            do = 2 * o_r.float()
            delta = fa._delta(o_r, do)

            def add(j, dk, dv, r=r):
                src = (r - j) % world
                dk_[src] = dk.float() if dk_[src] is None else dk_[src] + dk
                dv_[src] = dv.float() if dv_[src] is None else dv_[src] + dv
            dq_.append(ra.ring_bwd_schedule(T[0][r], do, lse, delta, r,
                                            world, kv, causal, add))
            os_.append(o_r)
        cat = (lambda ts: torch.cat([t.transpose(1, 2) for t in ts],
                                    dim=1).numpy())
        out["schedule"] = {"o": cat(os_), "dq": cat(dq_), "dk": cat(dk_),
                           "dv": cat(dv_)}
    return out


def _mesh_and_shard(inp):
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.sharding import (
        NamedSharding, logical_to_spec, shard_tensor)

    mesh = create_mesh(MeshConfig(**inp["mesh"]), device="cpu")

    def place(t, axes):
        return shard_tensor(t, NamedSharding(mesh, logical_to_spec(axes)))
    return mesh, place


def ring_llama(rank, world, inp):
    """Llama with ``attn_impl="ring_seq"`` and every layer under checkpoint
    (remat "full") on the given mesh: the loss and the gathered grads of
    every param. The backward, and with it the layers' recompute, runs on
    another thread, where the ambient mesh is not set, as autograd runs a
    CUDA backward on a thread of its own."""
    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.sharding import (
        compat_mesh_ctx, param_shardings, shard_pytree)

    cfg = _tiny(attn_impl="ring_seq", remat=True, remat_policy="full")
    mesh, place = _mesh_and_shard(inp)
    params = tree_map(lambda t: t.requires_grad_(True), shard_pytree(
        tl.params_from_jax(inp["params"]),
        param_shardings(tl.llama_logical_axes(cfg), mesh)))
    batch = {k: place(v, ("batch", "seq"))
             for k, v in _tb(inp["batch"]).items()}
    with compat_mesh_ctx(mesh):
        loss = tl.llama_loss(params, batch, cfg)
    worker = threading.Thread(target=loss.backward)
    worker.start()
    worker.join()
    return {"loss": float(loss.full_tensor()),
            "grads": _np(tree_map(lambda t: t.grad, params))}


def ring_layer(rank, world, inp):
    """Llama's ring_seq attention layer (``_ring_seq_attention``: local_map
    over the ambient mesh, the ring on its seq sub-group) on q, k, v placed
    by ("batch", "seq", "heads"/"kv_heads", "head_dim"): the output and
    the grads of sum(out**2), gathered."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.sharding import compat_mesh_ctx

    mesh, place = _mesh_and_shard(inp)
    qkv = [place(torch.from_numpy(inp[n]), ("batch", "seq", h, "head_dim"))
           .requires_grad_(True)
           for n, h in (("q", "heads"), ("k", "kv_heads"), ("v", "kv_heads"))]
    with compat_mesh_ctx(mesh):
        out = tl._ring_seq_attention(*qkv)
        (out ** 2).sum().backward()
    return {"o": _np(out), "dq": _np(qkv[0].grad), "dk": _np(qkv[1].grad),
            "dv": _np(qkv[2].grad)}


def moe_ep(rank, world, inp):
    """The MoE train step on ``inp["mesh"]`` (a (data, expert) mesh), the
    params carried across from JAX and placed by ``moe_logical_axes``, fp32:
    the first step's loss and gathered grads, 3 AdamW steps' metrics and
    the params after them, the params' placements, and the placements
    ``constrain`` gave ``expert_in`` and the experts' output."""
    from ray_tpu_torch.models import moe as tm
    from ray_tpu_torch.parallel import optim as topt
    from ray_tpu_torch.parallel import train_step as tts
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.sharding import compat_mesh_ctx

    cfg = dataclasses.replace(tm.MoEConfig.tiny(), dtype=torch.float32)
    mesh = create_mesh(MeshConfig(**inp["mesh"]), device="cpu")
    axes = tm.moe_logical_axes(cfg)
    batch = _tb(inp["batch"])
    seen = []
    constrain = tm.constrain

    def recording(x, logical_axes, rules=None):
        out = constrain(x, logical_axes, rules)
        if logical_axes[0] == "expert":
            seen.append([repr(p) for p in out.placements])
        return out

    tm.constrain = recording
    try:
        tx = topt.adamw(1e-3)
        state = tts.create_train_state(
            lambda g: tm.moe_params_from_jax(inp["params"]), tx, mesh, axes,
            device="cpu")
        with compat_mesh_ctx(mesh):
            loss = tm.moe_loss(state.params, _shard_rows(batch, mesh), cfg)
        loss.backward()
        grads = _np(_dicts(state.params, lambda t: t.grad))
        first_loss = float(loss.full_tensor())
        step = tts.make_train_step(lambda p, b: tm.moe_loss(p, b, cfg), tx,
                                   mesh, batch_logical_axes=("batch", "seq"))
        state, metrics = _run_steps(step, state, batch, 3)
    finally:
        tm.constrain = constrain
    names = mesh.mesh_dim_names
    placements = {
        k: [(names[i], repr(p)) for i, p in enumerate(v.placements)]
        for k, v in state.params["layers"].items()}
    return {"loss": first_loss, "grads": grads, "metrics": metrics,
            "params": _np(state.params), "placements": placements,
            "constrained": seen[:2], "mesh": list(names)}


def _shard_rows(batch, mesh):
    from ray_tpu_torch.parallel.sharding import (
        NamedSharding, logical_to_spec, shard_tensor)

    spec = logical_to_spec(("batch", "seq"))
    return {k: shard_tensor(v, NamedSharding(mesh, spec))
            for k, v in batch.items()}


def _dicts(tree, leaf=lambda t: t):
    """The tree with its lists as dicts keyed by index (``_np`` walks
    dicts), each leaf through ``leaf``."""
    if isinstance(tree, dict):
        return {k: _dicts(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return {str(i): _dicts(v, leaf) for i, v in enumerate(tree)}
    return leaf(tree)


def pipeline(rank, world, inp):
    """The GPipe pipeline on ``inp["mesh"]`` from JAX's stacked stage params:
    ``pipeline_apply``'s output (M given, and M by default), the
    validation error, the grads of mean((y - t)**2), one
    ``make_pipeline_train_step`` step and 20 steps of adam(1e-2); rank 0
    also runs every stage's ticks in this process (no mesh) on the same
    params for the output and the grads."""
    from ray_tpu_torch.parallel import optim as topt
    from ray_tpu_torch.parallel import pipeline as tp
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding, shard_tensor
    from ray_tpu_torch._private.tree import tree_map

    mesh = create_mesh(MeshConfig(**inp["mesh"]), device="cpu")
    data_axis = inp["data_axis"]
    M = inp["microbatches"]

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    def mse(y, t):
        return torch.mean((y - t) ** 2)

    def placed():
        full = tp.stage_params_from_jax(inp["params"])
        return tree_map(lambda t: shard_tensor(t, NamedSharding(
            mesh, tp.stage_param_spec(t))).requires_grad_(True), full)

    x, tgt = torch.from_numpy(inp["x"]), torch.from_numpy(inp["target"])
    out = {"n_stages": tp.num_stages(mesh)}
    params = placed()
    y = tp.pipeline_apply(stage_fn, params, x, mesh, data_axis=data_axis,
                          num_microbatches=M)
    t = torch.distributed.tensor.DTensor.from_local(
        tp._local_rows(tgt, mesh, tp._data_axes(mesh, data_axis)), mesh,
        y.placements, run_check=False)
    mse(y, t).backward()
    out["y"] = _np(y)
    out["grads"] = _np(_dicts(params, lambda t: t.grad))
    out["y_default_m"] = _np(tp.pipeline_apply(
        stage_fn, params, x, mesh, data_axis=data_axis))
    try:
        tp.pipeline_apply(stage_fn, params, x[:6], mesh,
                          data_axis=data_axis, num_microbatches=4)
        out["validation"] = None
    except ValueError as e:
        out["validation"] = str(e)

    for name, tx, n in (("step", topt.adamw(1e-3), 1),
                        ("train", topt.adamw(1e-2, weight_decay=0.0), 20)):
        params = placed()
        step = tp.make_pipeline_train_step(stage_fn, mse, tx, mesh, params,
                                           data_axis=data_axis,
                                           num_microbatches=M)
        carry, losses = (params, tx(params)), []
        for _ in range(n):
            carry, m = step(carry, (x, tgt))
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "params": _np(carry[0])}

    if rank == 0:
        full = tree_map(lambda t: t.requires_grad_(True),
                        tp.stage_params_from_jax(inp["params"]))
        y_in = tp.pipeline_apply(stage_fn, full, x, None, num_microbatches=M)
        mse(y_in, tgt).backward()
        out["in_process"] = {"y": _np(y_in),
                             "grads": _np(_dicts(full, lambda t: t.grad))}
    return out


def ppo_mesh(rank, world, inp):
    """A PPOLearner on the data mesh of every rank (``use_mesh=True``), its
    params set to JAX's: the first minibatch's grads and loss metrics, then
    one ``update`` and the params after it."""
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import (
        RLModuleSpec, rl_params_from_jax)

    lrn = PPOLearner(RLModuleSpec(**inp["spec"]), inp["config"],
                     use_mesh=True, device="cpu")
    lrn.set_weights(rl_params_from_jax(inp["params"]))
    metrics = lrn.compute_grads(lrn._batch(inp["batch"]))
    grads = _np(_dicts(lrn.params, lambda t: t.grad))
    update = lrn.update(inp["batch"])
    return {"mesh": dict(zip(lrn._mesh.mesh_dim_names, lrn._mesh.shape)),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "update": update,
            "params": _np(_dicts(lrn.params))}


def mesh3d_step(rank, world, inp):
    """The tiny Llama in fp32 with ``attn_impl="ring_seq"`` on
    ``inp["mesh"]`` (the dry run's (fsdp=2, seq=2, tensor=2) on 8 ranks),
    its params carried across from JAX and placed by
    ``llama_logical_axes``: the loss and the gathered grads of every
    param; then one ``adamw(1e-3)`` train step from the same params, its
    metrics and the params after it."""
    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel import optim as topt
    from ray_tpu_torch.parallel import train_step as tts
    from ray_tpu_torch.parallel.sharding import (
        compat_mesh_ctx, param_shardings, shard_pytree)

    cfg = _tiny(attn_impl="ring_seq")
    mesh, place = _mesh_and_shard(inp)
    axes = tl.llama_logical_axes(cfg)
    params = tree_map(lambda t: t.requires_grad_(True), shard_pytree(
        tl.params_from_jax(inp["params"]), param_shardings(axes, mesh)))
    batch = _tb(inp["batch"])
    with compat_mesh_ctx(mesh):
        loss = tl.llama_loss(params, {k: place(v, ("batch", "seq"))
                                      for k, v in batch.items()}, cfg)
    loss.backward()
    out = {"loss": float(loss.full_tensor()),
           "grads": _np(tree_map(lambda t: t.grad, params))}
    tx = topt.adamw(1e-3)
    state = tts.create_train_state(
        lambda g: tl.params_from_jax(inp["params"]), tx, mesh, axes,
        device="cpu")
    step = tts.make_train_step(lambda p, b: tl.llama_loss(p, b, cfg), tx,
                               mesh, batch_logical_axes=("batch", "seq"))
    state, metrics = _run_steps(step, state, batch, 1)
    out["step"] = dict(metrics=metrics, params=_np(state.params))
    return out


def data_sharding(rank, world, inp):
    """``DataIterator.iter_torch_batches(sharding=)`` on a data mesh of
    every rank: each rank iterates its own rows (rank r's slice of every
    global batch) through the prefetch thread, and each column comes back
    as a DTensor on the mesh, its batch dim sharded. Per batch: the local
    shard, the full tensor and the placements."""
    from ray_tpu_torch.data.iterator import DataIterator
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    from ray_tpu_torch.parallel.sharding import (
        NamedSharding, logical_to_spec)

    mesh = create_mesh(MeshConfig(data=-1), device="cpu")
    bs = inp["batch_size"]
    cols = inp["columns"]
    n = len(next(iter(cols.values())))
    mine = [r for start in range(0, n, bs * world)
            for r in range(start + rank * bs, start + (rank + 1) * bs)]
    blocks = [{k: v[mine[i:i + 3]] for k, v in cols.items()}
              for i in range(0, len(mine), 3)]
    it = DataIterator(lambda: iter(blocks))
    out = []
    for batch in it.iter_torch_batches(
            batch_size=bs, sharding=NamedSharding(
                mesh, logical_to_spec(("batch", "seq"))),
            dtypes={"x": torch.float64}, prefetch_batches=2):
        out.append({k: {"local": v.to_local().numpy().copy(),
                        "full": v.full_tensor().numpy().copy(),
                        "dtype": str(v.dtype),
                        "placements": [repr(p) for p in v.placements]}
                    for k, v in batch.items()})
    return out


SCENARIOS: Dict[str, Callable] = {
    "sharded_step": sharded_step, "ring": ring, "ring_llama": ring_llama,
    "ring_layer": ring_layer, "moe_ep": moe_ep, "pipeline": pipeline,
    "ppo_mesh": ppo_mesh, "mesh3d_step": mesh3d_step,
    "data_sharding": data_sharding}
