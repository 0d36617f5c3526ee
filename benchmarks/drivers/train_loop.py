"""The train loop that ``TorchTrainer`` runs in its worker, the process that
holds the card: the program's train step (``make_train_step`` over
``moe_loss`` and ``adamw``) built once, driven through its first steps for
the comparison, then timed over the window.

Everything the harness needs leaves the worker in one ``train.report``: the
first steps' losses, each leaf's first gradient as AdamW holds it after one
step (``exp_avg / (1 - b1)``), each leaf's change after the compared steps,
the window's steps and times, the trace summary, the peak memory and the
modules the process loaded."""

from __future__ import annotations

import os
import time
from typing import Any, Dict


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def build(config: Dict[str, Any], dev):
    """(step, state) of the program for the cell: a full fine-tune of the
    Mixtral-shaped MoE with fp32 params and AdamW."""
    import torch

    from ray_tpu_torch.models.moe import MoEConfig, init_moe, moe_loss
    from ray_tpu_torch.parallel import (
        adamw, create_train_state, make_train_step)

    c, seed = config["sizes"], config["seed"]
    tx = adamw(config["lr"])
    cfg = MoEConfig(
        vocab_size=c["vocab_size"], hidden=c["hidden"],
        mlp_hidden=c["mlp_hidden"], num_layers=c["num_layers"],
        num_heads=c["num_heads"], num_kv_heads=c["num_kv_heads"],
        num_experts=c["num_experts"],
        experts_per_token=c["experts_per_token"],
        capacity_factor=c["capacity_factor"],
        rope_theta=c["rope_theta"], rms_eps=c["rms_eps"],
        aux_loss_coeff=c["aux_loss_coeff"],
        dtype=getattr(torch, config["dtype"]))
    if cfg.head_dim != c["head_dim"]:
        raise ValueError(f"MoEConfig's head_dim {cfg.head_dim} != "
                         f"{c['head_dim']}")
    state = create_train_state(lambda g: init_moe(cfg, g, g.device), tx,
                               device=dev, seed=seed)
    step = make_train_step(lambda p, b: moe_loss(p, b, cfg), tx)
    return step, state


def compared_steps(step, state, feed, n: int, b1: float):
    """The first ``n`` steps, the ones the reference follows: each step's
    loss, each leaf's first gradient as AdamW holds it after one step
    (``exp_avg / (1 - b1)``; a leaf that the optimizer did not step has
    none), each leaf's change over the ``n`` steps, and for an MoE the
    routing of each step's layers (``moe.route``'s top-k experts and which
    of them kept a slot), read by wrapping ``route`` for these steps
    only. Returns (state, readings)."""
    import numpy as np

    from ray_tpu_torch.models import moe

    leaves = list(_named(state.params))
    first = {k: p.detach().to("cpu", copy=True) for k, p in leaves}
    losses, grad_norms, routing = [], {}, []
    route = moe.route

    def spy(cfg, x, router):
        r = route(cfg, x, router)
        routing[-1].append((r.expert_idx.to("cpu").numpy().astype(np.int8),
                            r.keep.any(-1).to("cpu").numpy()))
        return r

    moe.route = spy
    try:
        for i in range(n):
            routing.append([])
            state, m = step(state, feed[i % len(feed)])
            losses.append(float(m["loss"]))
            if i == 0:
                opt = state.opt_state
                grad_norms = {
                    k: float(opt.state[p]["exp_avg"].norm() / (1 - b1))
                    if "exp_avg" in opt.state[p] else 0.0
                    for k, p in leaves}
    finally:
        moe.route = route
    change = {k: float((p.detach() - first[k].to(p.device)).norm())
              for k, p in leaves}
    out = {"losses": losses, "grad_norms": grad_norms,
           "change_norms": change}
    if any(routing):
        out["routing"] = routing
    return state, out


def train_loop(config: Dict[str, Any]) -> None:
    import torch

    from ray_tpu_torch import train

    from benchmarks.harness import forbidden_modules
    from benchmarks.trace import Tracer

    dev = torch.device(config["device"])
    on = dev.type == "cuda"
    sync = torch.cuda.synchronize if on else (lambda: None)
    step, state = build(config, dev)
    feed = [{"inputs": t[:, :-1], "targets": t[:, 1:]} for t in (
        torch.tensor(b, device=dev) for b in config["batches"])]
    if on:
        torch.cuda.reset_peak_memory_stats()
    state, readings = compared_steps(step, state, feed,
                                     config["compared_steps"], config["b1"])
    n_cmp = config["compared_steps"]
    # one more step on the window's next batch: every shape is warm
    state, m = step(state, feed[n_cmp % len(feed)])
    sync()
    tracer = Tracer() if config["trace"] else None
    t_open = time.time()
    t0 = time.perf_counter()
    if tracer:
        tracer.start()
    n, i = 0, n_cmp + 1
    seconds = config["seconds"]
    trace_s = config.get("trace_seconds") or seconds
    summary, trace_steps = None, None
    # after a trace that stops inside the window, the rest of the window is
    # timed on its own: reducing the trace takes host time
    rest_t0, rest_n0 = t0, 0
    while True:
        state, m = step(state, feed[i % len(feed)])
        n, i = n + 1, i + 1
        now = time.perf_counter() - t0
        if tracer and tracer.running and now >= trace_s:
            # stopped here, reduced after the window
            tracer.finish()
            trace_steps = n
            rest_t0, rest_n0 = time.perf_counter(), n
        if now >= seconds:
            break
    sync()
    t1 = time.perf_counter()
    last_loss = float(m["loss"])
    if tracer and tracer.running:
        tracer.finish()
        trace_steps = n
    if tracer:
        summary = tracer.summary()
        summary["steps"] = trace_steps
    train.report(dict(readings, **{
        "steps": n, "window_s": t1 - t0, "t_open": t_open,
        "untraced": {"steps": n - rest_n0, "seconds": t1 - rest_t0},
        "last_loss": last_loss, "trace": summary,
        "probe": {
            "pid": os.getpid(),
            "device": torch.cuda.get_device_name(0) if on else "cpu",
            "memory_peak_bytes": torch.cuda.max_memory_allocated()
            if on else 0,
            "forbidden": forbidden_modules(),
        },
    }))
