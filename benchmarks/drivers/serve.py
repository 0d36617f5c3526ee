"""The serve driver: a llama-shaped model behind Serve, loaded by a closed
loop of streaming clients.

Set-up starts the port's runtime with its session under ``$TMPDIR``, runs
``serve.run`` with one replica that holds the card (``BenchGenerator``, the
program's ``LlamaGenerator`` with the harness's hooks), draws the weights on
the card from the seed, and warms every (batch, length) shape up. Then the
mix's clients stream requests through ``DeploymentHandle.options(stream=True,
multiplexed_model_id=...)``, each sending its next request when the last one
has ended. The window opens once the engine has dispatched the mix's
``window_opens_after`` (a batch of that many rows, that many steps), and
lasts ``seconds``. After it closes the clients stop, the replica reports its
counters, trace and memory, Serve and the runtime are shut down, and a sample
of the finished requests, drawn from the seed with the longest in it, is run
through the plain reference (``reference/llama.py``) on the same device."""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from benchmarks import traffic as traffic_gen
from benchmarks.harness import (
    Cell, percentile, sizes, start_runtime, stop_runtime)

LORA_TARGETS = ("wq", "wv")   # the generator's adapted projections
LORA_ALPHA = 32.0             # LoraConfig's default alpha


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def llama_config(c: Dict[str, Any], dtype):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=c["vocab_size"], hidden=c["hidden"],
        mlp_hidden=c["mlp_hidden"], num_layers=c["num_layers"],
        num_heads=c["num_heads"], num_kv_heads=c["num_kv_heads"],
        head_dim=c["head_dim"], max_seq_len=c["max_seq_len"],
        rope_theta=c["rope_theta"], rms_eps=c["rms_eps"], dtype=dtype)


class _Client(threading.Thread):
    """One closed-loop client: takes the next request of the shared order,
    streams it, records each token's arrival, and repeats until ``no_new``
    is set; it leaves a stream unread once ``abort`` is set."""

    def __init__(self, handle, reqs, counter, lock, no_new, abort, records,
                 errors):
        super().__init__(daemon=True)
        self.handle, self.reqs, self.counter = handle, reqs, counter
        self.lock, self.no_new, self.abort = lock, no_new, abort
        self.records, self.errors = records, errors

    def run(self):
        while not self.no_new.is_set():
            with self.lock:
                idx = next(self.counter)
            r = self.reqs[idx % len(self.reqs)]
            rec = {"req": idx % len(self.reqs), "prompt_len": r["prompt_len"],
                   "max_new": r["max_new"], "adapter": r["adapter"],
                   "t_submit": time.perf_counter(), "times": [],
                   "tokens": [], "error": None}
            with self.lock:
                self.records.append(rec)
            try:
                stream = self.handle.options(
                    stream=True, multiplexed_model_id=r["adapter"]).remote(
                        {"prompt": r["prompt"], "max_new": r["max_new"]})
                for tok in stream:
                    rec["times"].append(time.perf_counter())
                    rec["tokens"].append(int(tok))
                    if self.abort.is_set():
                        return
            except Exception as e:  # noqa: BLE001 — counted as failed
                if not self.abort.is_set():
                    rec["error"] = repr(e)
                    with self.lock:
                        self.errors.append(repr(e))
                return


def _finished(records) -> int:
    return sum(1 for r in records if r["error"] is None
               and len(r["tokens"]) >= r["max_new"])


def _wait_window(handle, opens_after: Dict[str, int], timeout: float):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = handle.engine_stats.remote().result(timeout_s=60)
        if (st["max_batch"] >= opens_after.get("max_batch", 1)
                and st["steps"] >= opens_after.get("steps", 1)):
            return
        time.sleep(0.02)
    raise TimeoutError(f"the engine did not reach {opens_after} within "
                       f"{timeout} s")


def _window_figures(records, t0: float, t1: float) -> Dict[str, Any]:
    tokens, gaps, ttft, served = 0, [], [], []
    for rec in records:
        ts = rec["times"]
        in_win = [k for k, t in enumerate(ts) if t0 <= t < t1]
        tokens += len(in_win)
        for k in in_win:
            if k > 0 and ts[k - 1] >= t0:
                gaps.append(ts[k] - ts[k - 1])
        if ts and t0 <= rec["t_submit"] and ts[0] < t1:
            ttft.append(ts[0] - rec["t_submit"])
        if in_win:
            served.append([rec["prompt_len"], in_win])
    attempted = [r for r in records if r["t_submit"] < t1 and not (
        r["times"] and len(r["tokens"]) >= r["max_new"]
        and r["times"][-1] < t0)]
    return {"tokens": tokens, "gaps": gaps, "ttft": ttft, "served": served,
            "attempted": len(attempted),
            "failed": sum(1 for r in attempted if r["error"])}


def check_sample(records, reqs, seed: int, n: int) -> List[Dict[str, Any]]:
    """The finished requests to compare: the one with the most served tokens
    and ``n - 1`` others, drawn from the seed."""
    done = [r for r in records if r["error"] is None
            and len(r["tokens"]) >= r["max_new"]]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["tokens"]), r["prompt_len"]))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(seed)
    pick = [rest[i] for i in sorted(
        rng.choice(len(rest), min(n - 1, len(rest)), replace=False))]
    return [dict(r, prompt=reqs[r["req"]]["prompt"])
            for r in [longest] + pick]


def compare(sample, c: Dict[str, Any], seed: int, lora_rank: int,
            device, quant: Optional[str] = None,
            dtype: str = "bfloat16") -> Dict[str, Any]:
    """Each sampled request's prompt and served tokens through the plain
    reference: the widest gap by which a served token's reference logit lies
    below the reference's best at its position, over all positions. With
    ``quant`` the tokens judged are the ones the reference in that
    precision puts first at each position (the control). The weights are
    redrawn in ``dtype``, the type the generator holds them in."""
    import torch

    from benchmarks.reference import draws, llama as ref

    weights = draws.llama_weights(c, seed, device, getattr(torch, dtype))
    scale = LORA_ALPHA / lora_rank
    worst, flips, positions = 0.0, 0, 0
    adapters: Dict[str, Any] = {}
    for r in sample:
        if r["adapter"] not in adapters:
            adapters[r["adapter"]] = draws.served_adapter(
                c, lora_rank, LORA_TARGETS, r["adapter"], device) \
                if r["adapter"] else None
        lora = adapters[r["adapter"]]
        seq = r["prompt"] + r["tokens"]
        toks = torch.tensor(seq[:-1], device=device)
        P, n = len(r["prompt"]), len(r["tokens"])
        logits = ref.forward(weights, lora, c, toks, scale)[P - 1:P - 1 + n]
        if quant is None:
            judged = torch.tensor(r["tokens"], device=device)
        else:
            judged = ref.forward(weights, lora, c, toks, scale,
                                 quant=quant)[P - 1:P - 1 + n].argmax(-1)
        best = logits.max(-1).values
        gap = best - logits.gather(-1, judged[:, None]).squeeze(-1)
        worst = max(worst, float(gap.max()))
        flips += int((gap > 0).sum())
        positions += n
        del logits
    del weights
    return {"max_gap": worst, "flips": flips, "positions": positions}


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        gen_cls=None) -> Dict[str, Any]:
    """One run of a serve cell; returns the run's figures for ``run.py``.
    ``device="cpu"`` and ``gen_cls`` serve the CPU tests."""
    import torch

    import ray_tpu_torch  # noqa: F401 — the program; fails early if absent
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.deployment import Deployment

    from benchmarks.drivers.serve_generator import BenchGenerator

    t_start = time.time() if t_start is None else t_start
    mix, s = cell.traffic, cell.traffic["serve"]
    c = sizes(cell.config)
    dtype = cell.config["config"].get("torch_dtype", "bfloat16")
    cfg = llama_config(c, getattr(torch, dtype))
    on_card = device == "cuda"
    reqs = traffic_gen.requests(mix, seed, c["vocab_size"])
    max_len = max(r["prompt_len"] + r["max_new"] for r in reqs)
    bucket = s["seq_bucket"]
    lengths = list(range(bucket, -(-max_len // bucket) * bucket + 1, bucket))

    phases = {"imports": time.time() - t_start}
    node = start_runtime(num_gpus=1 if on_card else 0)
    phases["runtime"] = time.time() - t_start
    records: List[Dict[str, Any]] = []
    errors: List[str] = []
    no_new, abort = threading.Event(), threading.Event()
    clients: List[_Client] = []
    out: Dict[str, Any] = {}
    try:
        serve.start(http_options={"port": 0})
        phases["serve"] = time.time() - t_start
        dep = Deployment(
            gen_cls or BenchGenerator, "BenchGenerator", num_replicas=1,
            max_ongoing_requests=s["max_ongoing_requests"],
            max_queued_requests=s["max_queued_requests"],
            ray_actor_options={"num_gpus": 1} if on_card else {})
        app = dep.bind(config=cfg, lora_rank=s["lora_rank"],
                       max_batch_size=s["max_batch_size"],
                       allowed_batch_sizes=tuple(s["allowed_batch_sizes"]),
                       max_new_tokens=s["max_new_tokens"],
                       seq_bucket=bucket, max_adapters=s["max_adapters"],
                       seed=seed, device=None if on_card else device)
        handle = serve.run(app, name="bench", wait_timeout_s=900)
        phases["replica"] = time.time() - t_start
        warm = handle.warm_up.remote(
            s["allowed_batch_sizes"], lengths,
            mix["adapters"]["names"][0]).result(timeout_s=900)
        phases["warm"] = time.time() - t_start
        log(f"[serve] replica RUNNING and warm ({warm['shapes']} shapes) "
            f"{time.time() - t_start:.2f} s after start")
        counter, lock = itertools.count(), threading.Lock()
        clients = [_Client(handle, reqs, counter, lock, no_new, abort,
                           records, errors) for _ in range(mix["clients"])]
        for cl in clients:
            cl.start()
        _wait_window(handle, mix.get("window_opens_after", {}), 900)
        if trace:
            handle.trace_start.remote().result(timeout_s=60)
        stats0 = handle.engine_stats.remote().result(timeout_s=60)
        t0 = time.perf_counter()
        setup_s = time.time() - t_start
        log("[serve] set-up phases, s after start: " + ", ".join(
            f"{k} {v:.2f}" for k, v in phases.items())
            + f", window {setup_s:.2f}")
        if trace:
            # the trace covers the mix's first ``trace_seconds``
            time.sleep(max(0.0, t0 + min(mix["trace_seconds"], seconds)
                           - time.perf_counter()))
            handle.trace_stop.remote().result(timeout_s=60)
        time.sleep(max(0.0, t0 + seconds - time.perf_counter()))
        t1 = time.perf_counter()
        stats1 = handle.engine_stats.remote().result(timeout_s=60)
        # no new requests; the ones in flight run on until the sample to
        # compare has finished, or for ``drain_s`` at the most
        no_new.set()
        want, drain_end = mix["check"]["requests"], \
            time.monotonic() + mix["check"]["drain_s"]
        while _finished(records) < want and time.monotonic() < drain_end \
                and any(cl.is_alive() for cl in clients):
            time.sleep(0.1)
        abort.set()
        summary, t_red = None, time.perf_counter()
        while trace and summary is None:
            summary = handle.trace_summary.remote().result(timeout_s=60)
            if summary is None:
                if time.perf_counter() - t_red > 300:
                    raise TimeoutError("the replica's trace was not reduced "
                                       "within 300 s")
                time.sleep(0.5)
        if trace:
            if "error" in summary:
                raise RuntimeError(f"the replica's trace failed: "
                                   f"{summary['error']}")
            log(f"[serve] trace reduced {time.perf_counter() - t_red:.1f} s "
                f"after the drain ({summary['events']} events, "
                f"{summary['reduce_s']:.1f} s to reduce)")
        probe = handle.probe.remote().result(timeout_s=60)
        out.update(t0=t0, t1=t1, stats0=stats0, stats1=stats1,
                   summary=summary, probe=probe, setup_s=setup_s)
    finally:
        no_new.set()
        abort.set()
        try:
            serve.shutdown()
        finally:
            stop_runtime(node)
        for cl in clients:
            cl.join(timeout=60)
    if any(cl.is_alive() for cl in clients):
        raise RuntimeError("a client thread outlived the runtime")

    t0, t1 = out["t0"], out["t1"]
    fig = _window_figures(records, t0, t1)
    window_s = t1 - t0
    if not fig["gaps"]:
        raise RuntimeError("no inter-token gap fell inside the window")
    gaps_ms = [g * 1e3 for g in fig["gaps"]]
    ttft = fig["ttft"]
    log(f"[serve] window {window_s:.3f} s: {fig['tokens']} tokens, "
        f"{len(gaps_ms)} gaps (p50 {percentile(gaps_ms, 50):.1f} ms), "
        f"requests attempted {fig['attempted']} failed {fig['failed']}, "
        f"ttft p50/p95 "
        + (f"{percentile(ttft, 50) * 1e3:.0f}/"
           f"{percentile(ttft, 95) * 1e3:.0f} ms over {len(ttft)}"
           if ttft else "none in window"))
    if errors:
        log(f"[serve] first error: {errors[0]}")

    # the comparison, on the device the replica used, once its state is
    # gone; its time is not set-up
    sample = check_sample(records, reqs, seed, mix["check"]["requests"])
    if not sample:
        raise RuntimeError("no request finished: nothing to compare")
    cmp = compare(sample, c, seed, s["lora_rank"], device, dtype=dtype)
    cmp["requests"] = len(sample)
    cmp["tokens_compared"] = sum(len(r["tokens"]) for r in sample)
    readings = {
        "window_s": window_s, "stats0": out["stats0"],
        "stats1": out["stats1"], "trace": out["summary"],
        "served": fig["served"], "sizes": c,
        "lora": {"rank": s["lora_rank"], "targets": list(LORA_TARGETS)},
    }
    return {
        "end_to_end": {
            "serve_tok_s": fig["tokens"] / window_s,
            "itl_p95_ms": percentile(gaps_ms, 95),
            "setup_s": out["setup_s"],
        },
        "attempted": fig["attempted"], "failed": fig["failed"],
        "compared": cmp,
        "sample": sample, "sizes": c, "lora_rank": s["lora_rank"],
        "dtype": dtype,
        "probes": [out["probe"]],
        "readings": readings,
    }
