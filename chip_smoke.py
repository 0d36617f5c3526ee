#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. Report the machine: ``nvidia-smi`` name and power limit, torch and CUDA.
2. Build every CUDA kernel of the package from its sources with nvcc
   (sm_90a), one nvcc per source, all started together, and count the
   tensor-core instructions (HGMMA, HMMA) in each library's SASS: the bf16
   forward (K1) and dk/dv (K3) must have some.
3. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and a few more: K1 (forward) at the serving shapes
   and the training shape, K2 (dq) and K3 (dk/dv) at the training shape,
   GQA, non-causal and fp32; time kernel, plain version and the PyTorch
   library call that computes the same function (a yardstick only: the
   port never calls it).
4. Drive the serving path: ``LlamaGenerator`` at full Llama-2-7B width
   (random weights from a seed, drawn on the card) answers 6 concurrent
   requests with multiplexed LoRA adapters; every attention call must have
   gone through K1.
5. Check the serving slice's output against its reference path on the
   card: a 2-layer cut of the same 7B weights with attention through the
   kernel and through the plain reference.
6. Show where a 7B forward's time goes: host wall, and device time by kind
   of kernel from torch.profiler.
7. Drive the training path: the Llama-2-7B LoRA fine-tune step
   (``create_train_state`` + ``make_train_step``, rank 16 on all seven
   projections, ``adamw(1e-4)``, remat "full", ``loss_chunk=256``) at full
   width and depth, B=1, S=2048, on the generator's frozen bf16 base: one
   warm-up step and three timed ones, with finite loss and grad norm, and
   K1 = 64, K2 = K3 = 32 launches per step.
8. Check the training slice's gradients: the LoRA grads of a 2-layer cut,
   through the kernels and through the plain reference attention.
9. Show where a train step's time goes: device time by kind of kernel.

It prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.llama import (
    LoraConfig, init_lora, llama_forward, llama_lora_loss)
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.parallel import (
    adamw, create_train_state, make_train_step)
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
    (2, 16, 4, 256, 64, True, "bfloat16"),
    (1, 32, 32, 2048, 128, True, "bfloat16"),  # the training path's
]
# K2 and K3: the training path's shape first (the 7B LoRA step at B=1,
# S=2048), then GQA, non-causal and fp32 / D=64
BWD_SHAPES = [
    (1, 32, 32, 2048, 128, True, "bfloat16"),
    (1, 32, 8, 1024, 128, True, "bfloat16"),
    (2, 32, 32, 256, 128, False, "bfloat16"),
    (2, 16, 4, 256, 64, True, "float32"),
    (2, 16, 4, 256, 64, True, "bfloat16"),
]
# dq, dk, dv against the plain version, as the largest error relative to
# max|plain|. fp32: both compute in fp32 from the same inputs and differ in
# summation order only (~1e-6 relative). bf16: the plain version computes in
# fp32; K2 does too, and K3 (on the tensor cores) rounds P^T and dS^T to bf16
# before its two products, 2**-9 relative per term and random in sign over
# up to 2048 terms times the group's 4 heads, so the sums' relative error
# stays near 2**-9 / sqrt(terms) of their size; the output is then rounded
# once, one bf16 step of 2**-8 relative. 2e-2 leaves room for both.
TOL_GRAD_REL = {"bfloat16": 2e-2, "float32": 1e-4}
# o: in fp32 kernel and plain version differ only in summation order
# (~1e-6). In bf16 the kernel rounds P to bf16 before the PV product (2**-9
# relative per term, random in sign, so o moves by a small part of 2**-9
# |v|), and o is then rounded once: one bf16 step at |o| < 4 is at most
# 2**-6 = 1.6e-2. lse is fp32 on both sides and sums the unrounded P
# (values ~5, sums of up to 2048 terms in another order).
TOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3
# 2-layer 7B-width forward, flash kernel vs plain reference attention: both
# round the probabilities to bf16 before the PV product (the reference as
# the JAX reference does, the kernel as the A operand of its tensor-core
# product), but from statistics summed in another order, so the logits
# differ at bf16 rounding level (2**-8 relative per element, partly
# averaging out)
TOL_SLICE_REL = 2e-2
N_TIMED = 30
# the training path: bench.py's Llama-2-7B LoRA rung on one card
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 2048, 3


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
    return roofline(nbytes, 4.0 * B * H * pairs * D, dtype_name)


def roofline(nbytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    flops over the type's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bwd_bound(kernel, B, H, KVH, S, D, causal, dtype_name, elem_bytes):
    """(bound_ms, bound_by) of K2 ("dq") or K3 ("dkv"): the larger of the
    bytes the function must move over HBM bandwidth (K2: q, k, v, dO and dq;
    K3: q, k, v, dO, dk and dv; both: the fp32 lse and delta) and the
    operations these inputs need (K2: 3 products, K3: 4, of 2 flops per
    multiply-add over the (q, k) pairs the causal mask keeps) over the
    type's peak."""
    q_elems, kv_elems = B * H * S * D, B * KVH * S * D
    if kernel == "dq":
        elems, products = 3 * q_elems + 2 * kv_elems, 3
    else:
        elems, products = 2 * q_elems + 4 * kv_elems, 4
    pairs = S * (S + 1) // 2 if causal else S * S
    return roofline(elems * elem_bytes + 2 * B * H * S * 4,
                    2.0 * products * B * H * pairs * D, dtype_name)


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


# libraries whose bf16 route must run on the tensor cores
TENSOR_CORE_LIBS = ("flash_attention_fwd", "flash_attention_dkv")


def tensor_core_ops(lib_path: str) -> int:
    """Count of tensor-core instructions (HGMMA, HMMA) in a library's SASS,
    read with cuobjdump from the nvcc that built it."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return len(re.findall(r"\b(?:HGMMA|HMMA)\b", sass))


def phase_build():
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (secs, text) in built.items():
        log(f"[2] built {name} in {secs:.1f} s")
        for line in text.splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                log(f"[2]   {line.strip()}")
    for name in built:
        n = tensor_core_ops(str(_build._target(name)[1]))
        log(f"[2] {name}: {n} tensor-core instructions (HGMMA, HMMA) in "
            f"its SASS")
        if name in TENSOR_CORE_LIBS and n == 0:
            raise AssertionError(f"{name} has no tensor-core instruction")
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


def phase_bwd_kernels():
    """K2 and K3 vs their plain versions at each backward shape, on K1's o
    and lse; returns per-shape records."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    records = []
    for (B, H, KVH, S, D, causal, dname) in BWD_SHAPES:
        dt = getattr(torch, dname)
        q, k, v, do = (torch.randn((B, S, n, D), generator=gen,
                                   device="cuda", dtype=torch.float32)
                       .to(dt).transpose(1, 2) for n in (H, KVH, KVH, H))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = fa._delta(o, do)
        args = (q, k, v, do, lse, delta, causal)
        got = (fa.flash_attention_dq(*args), *fa.flash_attention_dkv(*args))
        want = (fa.flash_attention_dq_plain(*args),
                *fa.flash_attention_dkv_plain(*args))
        torch.cuda.synchronize()
        errs, abs_errs = {}, {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"bad {name} {tuple(g.shape)} at "
                                     f"{(B, H, KVH, S, D, causal, dname)}")
            abs_errs[name] = (g.float() - w.float()).abs().max().item()
            errs[name] = abs_errs[name] / w.float().abs().max().item()
        reps, inner = (10, 3) if S >= 1024 else (N_TIMED, 10)
        ms = {"dq": cuda_ms(lambda: fa.flash_attention_dq(*args), reps,
                            inner),
              "dkv": cuda_ms(lambda: fa.flash_attention_dkv(*args), reps,
                             inner)}
        plain = {"dq": cuda_ms(lambda: fa.flash_attention_dq_plain(*args),
                               reps, inner),
                 "dkv": cuda_ms(
                     lambda: fa.flash_attention_dkv_plain(*args), reps,
                     inner)}
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = F.scaled_dot_product_attention(
            qr, kr, vr, is_causal=causal, enable_gqa=H != KVH)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qr, kr, vr), do, retain_graph=True), reps, inner)
        del out
        shape = f"B={B} H={H} KVH={KVH} S={S} D={D} " \
                f"{'causal' if causal else 'full'} {dname}"
        tol = TOL_GRAD_REL[dname]
        rec = dict(shape=shape, library_ms=lib_ms)
        for kern, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            bound_ms, bound_by = bwd_bound(kern, B, H, KVH, S, D, causal,
                                           dname, q.element_size())
            err = max(errs[n] for n in names)
            abs_err = max(abs_errs[n] for n in names)
            log(f"[3] flash_attention_{kern} {shape}: max error {abs_err:.3e}"
                f", / max|plain| {err:.3e} (tol {tol:g}); kernel "
                f"{ms[kern]:.4f} ms, plain {plain[kern]:.4f} ms, sdpa "
                f"backward (dq, dk, dv together) {lib_ms:.4f} ms, bound "
                f"{bound_ms * 1e3:.2f} us ({bound_by}), "
                f"{bound_ms / ms[kern]:.1%} of bound")
            rec[kern] = dict(err=err, abs_err=abs_err, ms=ms[kern],
                             plain_ms=plain[kern],
                             bound_ms=bound_ms, bound_by=bound_by)
        if any(e > tol for e in errs.values()):
            raise AssertionError(f"backward kernels disagree with plain at "
                                 f"{shape}: {errs}")
        records.append(rec)
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


def cut_layers(params, n):
    """The first n layers of a layer-stacked param tree (views, no copy)."""
    out = dict(params)
    out["layers"] = {name: w[:n] for name, w in params["layers"].items()}
    return out


def phase_slice_check(gen):
    """2-layer cut of the 7B weights: logits through the flash kernel vs
    through the plain reference attention, on the card."""
    cfg = dataclasses.replace(gen._cfg, num_layers=2)
    params = cut_layers(gen._params, 2)
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


def train_setup(gen, num_layers=None):
    """bench.py's Llama-2-7B LoRA rung: rank 16 on all seven projections,
    remat "full", loss_chunk 256, on the generator's frozen bf16 base; and a
    batch of B=1 x 2048 next-token pairs from a numpy seed."""
    cfg = dataclasses.replace(
        gen._cfg, max_seq_len=TRAIN_S, remat=True, remat_policy="full",
        loss_chunk=256, num_layers=num_layers or gen._cfg.num_layers)
    lcfg = LoraConfig(rank=16)
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
    tok = torch.from_numpy(tok).to(gen.device)
    return cfg, lcfg, {"inputs": tok[:, :-1], "targets": tok[:, 1:]}


def reset_counts():
    fa.launches = fa.dq_launches = fa.dkv_launches = 0


def counts():
    return fa.launches, fa.dq_launches, fa.dkv_launches


def phase_train(gen):
    """The 7B LoRA fine-tune step at full width and depth: one warm-up and
    TRAIN_STEPS timed steps; returns (K1, K2, K3 launches over the timed
    steps, ms/step, the step and its state and batch)."""
    cfg, lcfg, batch = train_setup(gen)
    tx = adamw(1e-4)
    t0 = time.perf_counter()
    state = create_train_state(
        lambda g: init_lora(cfg, lcfg, g, g.device), tx, device=gen.device,
        seed=1)
    step = make_train_step(
        lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg), tx,
        frozen=gen._params)
    torch.cuda.reset_peak_memory_stats()
    state, m = step(state, batch)
    warm = (m["loss"].item(), m["grad_norm"].item())
    warm_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        metrics.append((m["loss"], m["grad_norm"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    metrics = [warm] + [(a.item(), b.item()) for a, b in metrics]
    if not all(np.isfinite(v) for pair in metrics for v in pair):
        raise AssertionError(f"non-finite loss or grad norm: {metrics}")
    L = cfg.num_layers
    want = (2 * L * TRAIN_STEPS, L * TRAIN_STEPS, L * TRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"train launches (K1, K2, K3) {launches} != "
                             f"{want} over {TRAIN_STEPS} steps")
    ms_step = wall / TRAIN_STEPS * 1e3
    tok_s = TRAIN_B * TRAIN_S * TRAIN_STEPS / wall
    flops_tok = cfg.flops_per_token_frozen(lcfg.num_params(cfg), TRAIN_S)
    log(f"[7] 7B LoRA step B={TRAIN_B} S={TRAIN_S} rank {lcfg.rank} "
        f"({lcfg.num_params(cfg) / 1e6:.1f} M adapter params), remat "
        f"{cfg.remat_policy}, loss_chunk {cfg.loss_chunk}: warm-up "
        f"{warm_s:.1f} s (state init and first step); (loss, grad_norm) "
        f"per step {[(round(a, 5), round(b, 5)) for a, b in metrics]}; "
        f"{ms_step:.1f} ms/step, {tok_s:.0f} tokens/s, MFU "
        f"{tok_s * flops_tok / PEAK_FLOPS['bfloat16']:.1%} (vs 989 "
        f"TFLOP/s bf16), launches K1 {launches[0]} = {2 * L} x "
        f"{TRAIN_STEPS}, K2 {launches[1]} = K3 {launches[2]} = {L} x "
        f"{TRAIN_STEPS}, max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(launches=launches, ms_step=ms_step, step=step, state=state,
                batch=batch)


def phase_grad_check(gen):
    """LoRA grads of a 2-layer cut of the 7B weights at B=1, S=2048, with B
    perturbed so that dA is not 0: through the kernels vs through the plain
    reference attention, on the card."""
    cfg, lcfg, batch = train_setup(gen, num_layers=2)
    params = cut_layers(gen._params, 2)
    rng = torch.Generator(device=gen.device).manual_seed(21)
    lora = init_lora(cfg, lcfg, rng, gen.device)
    for ab in lora["layers"].values():
        ab["b"] = torch.randn(ab["b"].shape, generator=rng,
                              device=gen.device) * 0.02

    def grads(c):
        lo = {"layers": {n: {k: t.detach().clone().requires_grad_(True)
                             for k, t in ab.items()}
                         for n, ab in lora["layers"].items()}}
        loss = llama_lora_loss(params, lo, batch, c, lcfg)
        loss.backward()
        return loss.item(), {(n, k): t.grad for n, ab in lo["layers"].items()
                             for k, t in ab.items()}

    reset_counts()
    loss, got = grads(cfg)
    if counts() != (4, 2, 2):  # 2 layers: forward + recompute, backward
        raise AssertionError(f"grad check launches {counts()} != (4, 2, 2)")
    ref_loss, want = grads(dataclasses.replace(cfg, attn_impl="reference"))
    errs = {}
    for key, g in got.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite grad {key}")
        errs[key] = ((g - want[key]).norm() / want[key].norm()).item()
    worst = max(errs, key=errs.get)
    log(f"[8] 2-layer 7B-width LoRA grads, kernels vs reference attention: "
        f"loss {loss:.5f} vs {ref_loss:.5f}; relative norm error per leaf "
        f"max {errs[worst]:.3e} at {worst[0]}.{worst[1]} (tol "
        f"{TOL_SLICE_REL:g}), " + ", ".join(
            f"{n}.{k} {e:.2e}" for (n, k), e in sorted(errs.items())))
    if errs[worst] > TOL_SLICE_REL:
        raise AssertionError("kernel gradients disagree with reference")


def phase_train_profile(train):
    """Device time of one 7B LoRA step by kind of kernel, from
    torch.profiler, against the timed steps' wall."""
    step, state, batch = train["step"], train["state"], train["batch"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    kinds = {"matmul": 0.0, "K1": 0.0, "K2": 0.0, "K3": 0.0, "other": 0.0}
    kernels = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.key.lower()
        kind = ("K1" if "flash_fwd_kernel" in name else
                "K2" if "flash_dq_kernel" in name else
                "K3" if "flash_dkv_kernel" in name else
                "matmul" if any(w in name for w in
                                ("gemm", "nvjet", "cutlass", "xmma"))
                else "other")
        kinds[kind] += e.self_device_time_total / 1e3
        kernels += e.count
    device_ms = sum(kinds.values())
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    wall = train["ms_step"]
    log(f"[9] 7B LoRA step: wall {wall:.1f} ms (timed steps), device "
        f"kernels {device_ms:.1f} ms (busy {min(device_ms / wall, 1.0):.1%} "
        f"of wall): " + ", ".join(
            f"{k} {v:.1f} ms ({v / device_ms:.1%})" for k, v in
            kinds.items()) + f"; {kernels} kernel launches per step")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    resolve_device("cuda")  # fp32 means fp32: TF32 off
    t_start = time.perf_counter()
    card = phase_machine()
    phase_build()
    records = phase_kernels()
    bwd = phase_bwd_kernels()
    reset_counts()
    serve_launches, gen = phase_main_path()
    if counts()[1:] != (0, 0):
        raise AssertionError(f"the serving path ran backward kernels: "
                             f"{counts()}")
    phase_slice_check(gen)
    phase_profile(gen)
    train = phase_train(gen)
    phase_grad_check(gen)
    phase_train_profile(train)

    # K1 at the serving path's B=4, S=128 (its headline numbers) and at the
    # training path's B=1, S=2048; K2 and K3 at the training shape
    head, k1t, tb = records[0], records[-1], bwd[0]
    k1_train = train["launches"][0]
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/cuda/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/pallas/flash_attention.py:110",
        "launches": serve_launches + k1_train,
        "launches_by_path": {"serve": serve_launches, "train": k1_train},
        "max_abs_err": max(r["err_o"] for r in records),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_us": head["bound_ms"] * 1e3,
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "train_shape": {key: k1t[key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    }]
    for kern, name, line, n in (("dq", "flash_attention_dq", 275,
                                 train["launches"][1]),
                                ("dkv", "flash_attention_dkv", 303,
                                 train["launches"][2])):
        r = tb[kern]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ray_tpu_torch/ops/cuda/csrc/{name}.cu",
            "replaces": f"ray_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": n,
            "launches_by_path": {"train": n},
            "max_abs_err": max(b[kern]["abs_err"] for b in bwd),
            # the largest error relative to max|plain|, what the tolerance
            # holds, over every shape
            "max_rel_err": max(b[kern]["err"] for b in bwd),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_us": r["bound_ms"] * 1e3,
            "bound_by": r["bound_by"],
            # the backward of scaled_dot_product_attention: dq, dk and dv
            # together, so the same time stands on K2's and K3's rows
            "library_ms": tb["library_ms"],
            "shape": tb["shape"],
        })
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
