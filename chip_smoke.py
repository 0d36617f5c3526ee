#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. Report the machine: ``nvidia-smi`` name and power limit, torch and CUDA.
2. Build every CUDA kernel of the package from its sources with nvcc
   (sm_90a), one nvcc per source, all started together.
3. Hold each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and a few more, and time kernel, plain version and
   the PyTorch library call that computes the same function (a yardstick
   only: the port never calls it).
4. Drive the main path: ``LlamaGenerator`` at full Llama-2-7B width (random
   weights from a seed, drawn on the card) answers 6 concurrent requests
   with multiplexed LoRA adapters; every attention call must have gone
   through the flash kernel.
5. Check the slice's output against its reference path on the card: a
   2-layer cut of the same 7B weights with attention through the kernel and
   through the plain reference.
6. Show where a 7B forward's time goes: host wall, and device time by kind
   of kernel from torch.profiler.

It prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import llama_forward
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.serve.llm import LlamaGenerator

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # fp32: CUDA cores

# (B, H, KVH, S, D, causal, dtype): the path's shapes first (Llama-2-7B,
# seq buckets 128 and 256, batch buckets 4, 2 and 1), then GQA, non-causal
# and fp32 / D=64
KERNEL_SHAPES = [
    (4, 32, 32, 128, 128, True, "bfloat16"),
    (4, 32, 32, 256, 128, True, "bfloat16"),
    (2, 32, 32, 128, 128, True, "bfloat16"),
    (2, 32, 32, 256, 128, True, "bfloat16"),
    (1, 32, 32, 128, 128, True, "bfloat16"),
    (1, 32, 32, 256, 128, True, "bfloat16"),
    (2, 32, 8, 512, 128, True, "bfloat16"),
    (2, 32, 32, 256, 128, False, "bfloat16"),
    (2, 16, 4, 256, 64, True, "float32"),
]
# o: kernel and plain version both compute in fp32 from the same inputs and
# differ only in summation order (~1e-6); in bf16 o is then rounded once,
# and one bf16 step at |o| < 4 is at most 2**-6 = 1.6e-2. lse is fp32 on
# both sides (values ~5, sums of up to 512 terms in another order).
TOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3
# 2-layer 7B-width forward, flash kernel vs plain reference attention: the
# reference rounds the probabilities to bf16 before the PV product (as the
# JAX reference does) and the kernel does not, so the logits differ at bf16
# rounding level (2**-8 relative per element, partly averaging out)
TOL_SLICE_REL = 2e-2
N_TIMED = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = N_TIMED, inner: int = 10) -> float:
    """Device time of one call of ``fn``: the median over ``reps`` runs of
    (CUDA events around ``inner`` calls) / inner, warm. A sleep kernel holds
    the stream while the host enqueues the calls, so the events see device
    time and not the host's launch overhead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms at H100 clocks
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_bound(B, H, KVH, S, D, causal, dtype_name, elem_bytes):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (q, k, v, o once each, plus the fp32 lse) over HBM bandwidth, and the
    operations these inputs need (2 products of 2 flops per multiply-add,
    over the (q, k) pairs the causal mask keeps) over the type's peak."""
    nbytes = (2 * B * H * S * D + 2 * B * KVH * S * D) * elem_bytes \
        + B * H * S * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4.0 * B * H * pairs * D
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_machine():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s), "
        f"{torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (secs, text) in built.items():
        log(f"[2] built {name} in {secs:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {line.strip()}")
    log(f"[2] build total {time.perf_counter() - t0:.1f} s")


def phase_kernels():
    """Kernel vs plain version at each shape; returns per-shape records."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    records = []
    for (B, H, KVH, S, D, causal, dname) in KERNEL_SHAPES:
        dt = getattr(torch, dname)
        # the path's layout: [B,S,H,D] tensors, read as [B,H,S,D] views
        q, k, v = (torch.randn((B, S, n, D), generator=gen, device="cuda",
                               dtype=torch.float32).to(dt).transpose(1, 2)
                   for n in (H, KVH, KVH))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o).all()) and bool(
            torch.isfinite(lse).all())
        ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_fwd_plain(q, k, v, causal))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=H != KVH))
        bound_ms, bound_by = attention_bound(B, H, KVH, S, D, causal, dname,
                                             q.element_size())
        shape = f"B={B} H={H} KVH={KVH} S={S} D={D} " \
                f"{'causal' if causal else 'full'} {dname}"
        log(f"[3] flash_attention_fwd {shape}: max|o-plain| {err_o:.3e} "
            f"(tol {TOL_O[dname]:g}), max|lse-plain| {err_lse:.3e} "
            f"(tol {TOL_LSE:g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, sdpa {lib_ms:.4f} ms, bound {bound_ms * 1e3:.2f} us "
            f"({bound_by}), {bound_ms / ms:.1%} of bound")
        if not finite:
            raise AssertionError(f"non-finite kernel output at {shape}")
        if err_o > TOL_O[dname] or err_lse > TOL_LSE:
            raise AssertionError(f"kernel disagrees with plain at {shape}")
        records.append(dict(shape=shape, err_o=err_o, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
    return records


def phase_main_path():
    """7B LlamaGenerator answers 6 concurrent requests; returns (flash
    kernel launches during the requests, the generator)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = LlamaGenerator(config="llama2_7b", device="cuda", seq_bucket=128,
                         max_batch_size=4, allowed_batch_sizes=(1, 2, 4),
                         max_new_tokens=16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = gen._cfg
    log(f"[4] LlamaGenerator llama2_7b: {cfg.num_params() / 1e9:.3f} B "
        f"params, init {init_s:.1f} s")

    rng = torch.Generator().manual_seed(7)
    lens = torch.randint(20, 201, (6,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in lens]
    adapters = ["", "a1", "", "a2", "", ""]
    prompts[5] = prompts[0]  # same adapter and prompt: same tokens
    max_new = 16
    out, errors = {}, []

    def run(i):
        try:
            out[i] = list(gen({"prompt": prompts[i], "max_new": max_new,
                               "adapter": adapters[i]}))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    fa.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    try:
        if any(t.is_alive() for t in threads):
            raise AssertionError("a request did not finish within 600 s")
        if errors:
            raise errors[0]
        stats = gen.engine.stats()
    finally:
        gen.engine.shutdown()
    for i in range(6):
        toks = out[i]
        if len(toks) != max_new or not all(
                isinstance(x, int) and 0 <= x < cfg.vocab_size
                for x in toks):
            raise AssertionError(f"request {i} yielded {toks}")
    if out[0] != out[5]:
        raise AssertionError(f"same prompt and adapter diverged: {out[0]} "
                             f"vs {out[5]}")
    if stats["completed"] != 6:
        raise AssertionError(f"engine completed {stats['completed']} != 6")
    steps = stats["steps"]
    if launches <= 0 or launches != cfg.num_layers * steps:
        raise AssertionError(f"flash kernel launches {launches} != "
                             f"{cfg.num_layers} x {steps} forward calls")
    log(f"[4] prompts {lens}, adapters {adapters}: 6 x {max_new} tokens in "
        f"{wall:.2f} s, {steps} steps ({stats['max_batch']} max batch), "
        f"{wall / steps * 1e3:.1f} ms/step, "
        f"{6 * max_new / wall:.1f} generated tokens/s, flash launches "
        f"{launches} = {cfg.num_layers} x {steps}, max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, gen


def phase_slice_check(gen):
    """2-layer cut of the 7B weights: logits through the flash kernel vs
    through the plain reference attention, on the card."""
    cfg = dataclasses.replace(gen._cfg, num_layers=2)
    params = dict(gen._params)
    params["layers"] = {n: w[:2] for n, w in gen._params["layers"].items()}
    lora = gen._adapter("a1")
    lora = {"layers": {n: {"a": ab["a"][:2], "b": ab["b"][:2]}
                       for n, ab in lora["layers"].items()}}
    tokens = torch.randint(
        0, cfg.vocab_size, (2, 256), device=gen.device,
        generator=torch.Generator(device=gen.device).manual_seed(11))
    with torch.inference_mode():
        got = llama_forward(params, tokens, cfg, lora=lora,
                            lora_cfg=gen._lcfg)
        want = llama_forward(
            params, tokens, dataclasses.replace(cfg, attn_impl="reference"),
            lora=lora, lora_cfg=gen._lcfg)
    if got.shape != (2, 256, cfg.vocab_size) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"bad logits: {tuple(got.shape)}")
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[5] 2-layer 7B-width forward, flash vs reference attention: "
        f"relative error {rel:.3e} (tol {TOL_SLICE_REL:g}), argmax "
        f"agreement {agree:.4f}")
    if rel > TOL_SLICE_REL:
        raise AssertionError("flash path disagrees with reference path")


def phase_profile(gen):
    """Where one 7B forward's time goes at the path's largest and smallest
    shapes: host wall per forward (synchronised, no profiler), and device
    kernel time by kind from torch.profiler (CUPTI)."""
    cfg, n = gen._cfg, 3
    lora = gen._adapter("a1")
    rng = torch.Generator(device=gen.device).manual_seed(12)
    for B, S in ((4, 256), (1, 128)):
        tokens = torch.randint(0, cfg.vocab_size, (B, S), device=gen.device,
                               generator=rng)

        def fwd():
            with torch.inference_mode():
                llama_forward(gen._params, tokens, cfg, lora=lora,
                              lora_cfg=gen._lcfg)

        fwd()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fwd()
            torch.cuda.synchronize()
        kinds = {"matmul": 0.0, "flash": 0.0, "other": 0.0}
        kernels = 0
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = e.key.lower()
            kind = ("flash" if "flash_fwd_kernel" in name else
                    "matmul" if any(w in name for w in
                                    ("gemm", "nvjet", "cutlass", "xmma"))
                    else "other")
            kinds[kind] += e.self_device_time_total / 1e3 / n
            kernels += e.count
        device_ms = sum(kinds.values())
        if device_ms <= 0:
            raise AssertionError("the profiler saw no device time")
        log(f"[6] 7B forward B={B} S={S} (adapter a1): wall {wall_ms:.2f} "
            f"ms, device kernels {device_ms:.2f} ms (busy "
            f"{min(device_ms / wall_ms, 1.0):.1%} of wall): matmul "
            f"{kinds['matmul']:.2f} ms, flash {kinds['flash']:.2f} ms, "
            f"other {kinds['other']:.2f} ms; {kernels / n:.0f} kernel "
            f"launches per forward")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    resolve_device("cuda")  # fp32 means fp32: TF32 off
    t_start = time.perf_counter()
    card = phase_machine()
    phase_build()
    records = phase_kernels()
    launches, gen = phase_main_path()
    phase_slice_check(gen)
    phase_profile(gen)

    head = records[0]  # the path's shape: B=4, S=128
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/cuda/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/pallas/flash_attention.py:110",
        "launches": launches,
        "max_abs_err": max(r["err_o"] for r in records),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_us": head["bound_ms"] * 1e3,
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
    }]
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
