"""The train driver: the program's train step through ``TorchTrainer.fit()``
with one worker on the card.

Set-up starts the port's runtime with its session under ``$TMPDIR`` and
fits ``train_loop.train_loop``: the worker draws the weights on the card
from the seed, builds the step and its AdamW state once, drives that same
step through the mix's compared steps on distinct batches of the seed, one
more step, then the window. After ``fit`` returns and the runtime is shut
down, the plain reference (``reference/moe.py``) redraws the weights from
the seed and follows the compared steps on the same batches, on the
program's routing; the first gradients and the changes are compared leaf
by leaf, and the first step's routing with the reference's own."""

from __future__ import annotations

import gc
import sys
import tempfile
import time
from typing import Any, Dict, Optional

from benchmarks import traffic as traffic_gen
from benchmarks.harness import Cell, sizes, start_runtime, stop_runtime

# The faults that ``program_readings`` can plant in the program's steps.
FAULTS = ("unchanged", "half_batch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loop_config(cell: Cell, seed: int, seconds: float, trace: bool,
                device: str) -> Dict[str, Any]:
    if cell.config["architecture"] != "moe":
        raise ValueError(f"the train driver runs the MoE's full fine-tune; "
                         f"{cell.config_name} is a "
                         f"{cell.config['architecture']}")
    mix = cell.traffic
    c = sizes(cell.config)
    return {
        "sizes": c, "seed": seed,
        "dtype": cell.config["config"].get("torch_dtype", "bfloat16"),
        "lr": mix["optimizer"]["lr"], "b1": 0.9,
        "batches": traffic_gen.train_batches(mix, seed, c["vocab_size"]),
        "compared_steps": mix["compared_steps"], "seconds": seconds,
        "trace": trace, "trace_seconds": mix.get("trace_seconds"),
        "device": device,
    }


def half_batch(step):
    """The step on half of each batch, the mean taken over the rest: half
    the rows, or half the positions of a batch of one row."""
    def half(state, batch):
        rows = batch["inputs"].shape[0]
        cut = ((lambda v: v[:rows // 2]) if rows > 1
               else (lambda v: v[:, :v.shape[1] // 2]))
        return step(state, {k: cut(v) for k, v in batch.items()})
    return half


def program_readings(config: Dict[str, Any], device,
                     fault: Optional[str] = None) -> Dict[str, Any]:
    """The program's compared steps in this process, as the worker runs
    them (``train_loop.compared_steps``), its state freed after. ``fault``
    plants one of ``FAULTS``: "unchanged", an optimizer that steps nothing;
    "half_batch", a step on half of each batch (``half_batch``)."""
    import torch

    from benchmarks.drivers.train_loop import build, compared_steps

    step, state = build(config, torch.device(device))
    if fault == "unchanged":
        state.opt_state.step = lambda closure=None: None
    elif fault == "half_batch":
        step = half_batch(step)
    elif fault is not None:
        raise ValueError(f"no fault {fault!r} (have {FAULTS})")
    feed = [{"inputs": t[:, :-1], "targets": t[:, 1:]} for t in (
        torch.tensor(b, device=device)
        for b in config["batches"][:config["compared_steps"]])]
    _, out = compared_steps(step, state, feed, config["compared_steps"],
                            config["b1"])
    del step, state, feed
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def reference_readings(config: Dict[str, Any], device,
                       quant: Optional[str] = None,
                       routing=None) -> Dict[str, Any]:
    """The plain reference through the compared steps on the same batches,
    from the weights redrawn from the seed, on the program's ``routing``
    (``train_loop.compared_steps``) where given, with its own choices in
    ``route_idx``."""
    import torch

    from benchmarks.reference import draws, moe as ref, train as ref_train

    c, seed = config["sizes"], config["seed"]
    feed = [{"inputs": t[:, :-1], "targets": t[:, 1:]} for t in (
        torch.as_tensor(b, device=device)
        for b in config["batches"][:config["compared_steps"]])]
    if routing is not None:
        # a step whose routing has another shape than its batch (a fault
        # that ran on half the batch) is routed by the reference itself
        feed = [dict(b, routing=r)
                if r[0][0].shape[:2] == tuple(b["inputs"].shape) else b
                for b, r in zip(feed, routing)]
    params = draws.moe_weights(c, seed, device)
    seen = []
    out = ref_train.run_steps(
        params, lambda p, b: ref.loss(p, b, c, quant=quant, seen=seen),
        feed, config["lr"])
    n_layers = c["num_layers"]
    out["route_idx"] = [seen[k:k + n_layers]
                        for k in range(0, len(seen), n_layers)]
    return out


def compare(prog: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers the limits hold, and the readings that PERF.md reports
    beside them: the worst leaf's gap of the first gradient's norm and of
    the change's norm (``leaf_gaps``), and the share of routing choices
    that differ from the reference's own at the first step (held); the
    worst step's relative loss gap and the first step's, and the routing
    share over all the steps (reported)."""
    from benchmarks.reference.train import leaf_gap

    gaps = [abs(a - b) / abs(b)
            for a, b in zip(prog["losses"], want["losses"])]
    grad_gap, grad_leaf = leaf_gap(prog["grad_norms"], want["grad_norms"])
    change_gap, change_leaf = leaf_gap(prog["change_norms"],
                                       want["change_norms"])
    out = {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf}
    # the share of (token, k) choices that differ from the reference's own:
    # over the first step's layers (the routing at the start, before updates
    # that make the routing noisier), and over all the steps
    # (a step's choices of another shape, as a fault's on half the batch,
    # all count as differing)
    def share(steps):
        pairs = [(a, b) for sa, sb in steps for a, b in zip(sa, sb)]
        return float(sum((a != b).sum() if a.shape == b.shape else b.size
                         for a, b in pairs)
                     / sum(b.size for _, b in pairs))
    # the program's own choices, or the reference's where ``prog`` is the
    # control (the reference in fp8 on the program's routing)
    mine = prog.get("route_idx") or [[r[0] for r in step]
                                     for step in prog["routing"]]
    steps = list(zip(mine, want["route_idx"]))
    out["route1_disagree"] = share(steps[:1])
    out["route_disagree"] = share(steps)
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        loop=None) -> Dict[str, Any]:
    """One run of a train cell; returns the run's figures for ``run.py``.
    ``device="cpu"`` and ``loop`` serve the CPU tests."""
    import ray_tpu_torch  # noqa: F401 — the program; fails early if absent
    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchTrainer)

    from benchmarks.drivers.train_loop import train_loop

    t_start = time.time() if t_start is None else t_start
    on_card = device == "cuda"
    config = loop_config(cell, seed, seconds, trace, device)
    mix = cell.traffic
    node = start_runtime(num_gpus=1 if on_card else 0)
    storage = tempfile.mkdtemp(prefix="bench_train_")
    try:
        result = TorchTrainer(
            loop or train_loop, train_loop_config=config,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
            run_config=RunConfig(
                name="bench", storage_path=storage,
                failure_config=FailureConfig(max_failures=0))).fit()
    finally:
        stop_runtime(node)
        import shutil

        shutil.rmtree(storage, ignore_errors=True)
    if result.error is not None:
        raise RuntimeError(f"fit failed: {result.error!r}")
    rep = result.metrics
    setup_s = rep["t_open"] - t_start
    tokens = mix["batch"] * mix["seq"]
    log(f"[train] window {rep['window_s']:.3f} s: {rep['steps']} steps of "
        f"{tokens} tokens, last loss {rep['last_loss']:.5f}; set-up "
        f"{setup_s:.2f} s")
    want = reference_readings(config, device, routing=rep.get("routing"))
    cmp = compare(rep, want)
    c = config["sizes"]
    readings = {
        "window_s": rep["window_s"], "steps": rep["steps"],
        "untraced": rep["untraced"],
        "trace": rep["trace"], "sizes": c,
        "batch": mix["batch"], "seq": mix["seq"],
        "memory_peak_bytes": rep["probe"]["memory_peak_bytes"],
    }
    return {
        "end_to_end": {
            "train_tok_s": rep["steps"] * tokens / rep["window_s"],
            "setup_s": setup_s,
        },
        "attempted": rep["steps"], "failed": 0,
        "compared": cmp, "probes": [rep["probe"]], "readings": readings,
        "config": config, "report": rep,
    }
