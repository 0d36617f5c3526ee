#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is not 0:

1. Report the machine: ``nvidia-smi`` name and power limit, torch and CUDA.
2. Build every CUDA kernel of the package from its sources with nvcc
   (sm_90a), one nvcc per source, all started together, and count the
   tensor-core instructions (HGMMA, HMMA) in each library's SASS: the bf16
   forward (K1), dq (K2) and dk/dv (K3) must each have some.
3. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and a few more: K1 (forward) at the serving shapes
   and both training shapes (the 7B LoRA step's B=1, H=32 and the dense
   rung's B=4, H=16, S=2048), K2 (dq) and K3 (dk/dv) at both training
   shapes, GQA, non-causal and fp32; time kernel, plain version and the PyTorch
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
10. Drive the dense training path: ``bench.py``'s second rung (~1.005B
    params: hidden 2048, mlp 5632, 17 layers, 16 heads of 128, fp32
    params, remat "dots", ``adafactor(1e-3)``) at full width and depth,
    B=4, S=2048: one warm-up step and three timed ones, K1 = 34, K2 = K3 =
    17 launches per step, and device time by kind of one profiled step.
11. Check the dense slice's gradients: every grad of a 2-layer cut of the
    rung, through the kernels and through the plain reference attention.
12. Check kv-cache decode at 7B on the generator's base: prefill 4 prompts
    of 128 tokens into a 256-slot cache, then decode 16 tokens teacher-
    forced with the recompute path's greedy tokens; each step's logits
    against ``llama_forward``'s at the same position.
13. Check ``merge_lora`` at 7B: ``llama_forward`` on the weights merged
    with adapter ``a1`` against the activation-side adapter path.
14. Check blockwise attention against the reference attention, output and
    q/k/v grads, at the dense rung's attention shape and at a GQA shape.
15. Drive the MLP family: 3 AdamW steps of ``MLPConfig()`` (784-512-10) on
    the card, against the same 3 steps on the CPU.
16. Drive the MoE training path, after releasing the 7B base: the
    Mixtral-style MoE (``models/moe.py``) at Mixtral-8x7B's widths (hidden
    4096, 8 experts of 14336, top-2, capacity 1.25, 32 heads, 8 kv heads,
    vocab 32000) cut to 2 of its 32 layers, fp32 params, ``adamw(1e-3)``,
    B=1, S=2048: one warm-up step and three timed ones, with finite loss and
    grad norm, aux > 0 and no flash launch (the reference attention is the
    reference's choice); the routing after the last step, MFU with its FLOP
    count, peak memory and device time by kind of one profiled step.
17. Check the MoE on the card against the CPU: ``_moe_ffn`` at full width
    on layer 0's weights (the routing, the capacity drops, y and aux), and 3
    AdamW steps of a narrow fp32 MoE on both.

It prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
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
from ray_tpu_torch._private.tree import tree_leaves, tree_map
from ray_tpu_torch.models.llama import (
    LlamaConfig, LoraConfig, init_llama, init_lora, llama_decode,
    llama_forward, llama_lora_loss, llama_loss, merge_lora)
from ray_tpu_torch.models import moe
from ray_tpu_torch.models.mlp import MLPConfig, init_mlp, mlp_loss
from ray_tpu_torch.models.moe import MoEConfig, init_moe, moe_loss
from ray_tpu_torch.ops.attention import attention, reference_attention
from ray_tpu_torch.ops.cuda import _build
from ray_tpu_torch.ops.cuda import flash_attention as fa
from ray_tpu_torch.parallel import (
    adafactor, adamw, create_train_state, make_train_step)
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
    (1, 32, 32, 2048, 128, True, "bfloat16"),  # the 7B LoRA step's
    (4, 16, 16, 2048, 128, True, "bfloat16"),  # the dense 1B step's
]
SERVE_SHAPE = KERNEL_SHAPES[0]
TRAIN_SHAPE = (1, 32, 32, 2048, 128, True, "bfloat16")
DENSE_SHAPE = (4, 16, 16, 2048, 128, True, "bfloat16")
# K2 and K3: the training paths' shapes first (the 7B LoRA step at B=1,
# S=2048, the dense 1B step at B=4, S=2048), then GQA, non-causal and fp32 /
# D=64
BWD_SHAPES = [
    TRAIN_SHAPE,
    DENSE_SHAPE,
    (1, 32, 8, 1024, 128, True, "bfloat16"),
    (2, 32, 32, 256, 128, False, "bfloat16"),
    (2, 16, 4, 256, 64, True, "float32"),
    (2, 16, 4, 256, 64, True, "bfloat16"),
]
# dq, dk, dv against the plain version, as the largest error relative to
# max|plain|. fp32: both compute in fp32 from the same inputs and differ in
# summation order only (~1e-6 relative). bf16: the plain version computes in
# fp32; K2 and K3 (on the tensor cores) round dS (K2) and P^T, dS^T (K3) to
# bf16 before their accumulating products, 2**-9 relative per term and
# random in sign over up to 2048 terms (times the group's 4 heads in K3), so
# the sums' relative error stays near 2**-9 / sqrt(terms) of their size; the
# output is then rounded once, one bf16 step of 2**-8 relative. 2e-2 leaves
# room for both.
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
# 32 layers of bf16 activations (the 7B decode and merge checks): the two
# paths round to bf16 at other places (the cached keys and values, products
# of other shapes, the merged weights against an activation-side delta),
# 2**-9 relative per rounding and random in sign; through 32 residual layers
# such differences were 5.4e-3 of the logits' norm at 2 layers (phase 5), so
# about 2e-2 at 32 if they add in quadrature. 5e-2 leaves room for that
TOL_DEEP_REL = 5e-2
# the MLP's 3 AdamW steps, card against CPU: fp32 on both (TF32 off), sums
# in other orders (~1e-6 relative), which an Adam update can grow where a
# gradient is near 0 (test_train_step_matches_jax saw 1.3e-5 on the loss)
TOL_MLP_REL = 1e-4
N_TIMED = 30
# where phases 10-15 run (the card; a CPU rehearsal of their control flow at
# a tiny size may set "cpu")
DEVICE = "cuda"
# the training path: bench.py's Llama-2-7B LoRA rung on one card
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 2048, 3
# the dense training path: bench.py's second rung (bench.py:55-61), ~1.005B
# params at its published widths and depth, nothing cut
DENSE_CFG = LlamaConfig(
    vocab_size=32000, hidden=2048, mlp_hidden=5632, num_layers=17,
    num_heads=16, num_kv_heads=16, head_dim=128, max_seq_len=2048,
    remat=True, remat_policy="dots", attn_impl="auto", loss_chunk=0,
    param_dtype=torch.float32, dtype=torch.bfloat16)
DENSE_B, DENSE_S, DENSE_STEPS = 4, 2048, 3
# kv-cache decode at 7B: 4 prompts of 128 tokens, 16 decoded, 256 slots
DECODE_B, DECODE_PROMPT, DECODE_NEW, DECODE_MAX_S = 4, 128, 16, 256
# blockwise attention: the dense rung's attention shape, then GQA
# (B, H, KVH, S, D), bf16, causal
BLOCKWISE_SHAPES = [(4, 16, 16, 2048, 128), (2, 32, 8, 1024, 128)]
# the MoE training path: MoEConfig.mixtral_8x7b_proxy (Mixtral-8x7B's widths)
# at 2 of its 32 layers (32 are 46.7 B params, 93 GB in bf16 for the weights
# alone), fp32 params, bf16 activations; 3.165 B params under AdamW
MOE_CFG = dataclasses.replace(MoEConfig.mixtral_8x7b_proxy(), num_layers=2)
MOE_B, MOE_S, MOE_STEPS = 1, 2048, 3
# phase 17: _moe_ffn at full width on B=1 x MOE_FFN_S tokens; and 3 AdamW
# steps of a narrow MoE in fp32 (so that no routing can flip between the
# card's and the CPU's fp32 sums of other orders), B=4, S=128
MOE_FFN_S = 256
MOE_NARROW_CFG = dataclasses.replace(
    MoEConfig.tiny(), hidden=256, mlp_hidden=512, num_experts=4,
    dtype=torch.float32)
MOE_NARROW_B, MOE_NARROW_S = 4, 128
# _moe_ffn at full width, card (bf16 products, as the path runs) against the
# CPU in fp32 from the same bf16 x and the same fp32 weights: the card rounds
# x's expert products, the SwiGLU activations and the combine to bf16 (2**-9
# relative per rounding, random in sign over 4096-14336 terms), so y moves by
# about one bf16 step of its largest entries: 2e-2 of max|y|. The aux loss is
# fp32 from the same fp32 router inputs on both (sums of another order only)
TOL_MOE_Y_REL = 2e-2
TOL_MOE_AUX_REL = 1e-5
# routing: the share of (token, k) pairs that must pick the same expert in
# the same order on the card and on the CPU
MOE_ROUTING_AGREE = 0.999


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
TENSOR_CORE_LIBS = ("flash_attention_fwd", "flash_attention_dq",
                    "flash_attention_dkv")


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
        records.append(dict(key=(B, H, KVH, S, D, causal, dname),
                            shape=shape, err_o=err_o, ms=ms,
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
        rec = dict(key=(B, H, KVH, S, D, causal, dname), shape=shape,
                   library_ms=lib_ms)
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


def step_profile(train):
    """Device time of one train step by kind of kernel, from torch.profiler:
    (ms by kind, their sum, kernel launches, the largest "other" kernels as
    (ms, launches, name))."""
    step, state, batch = train["step"], train["state"], train["batch"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    kinds = {"matmul": 0.0, "K1": 0.0, "K2": 0.0, "K3": 0.0, "other": 0.0}
    kernels, others = 0, []
    for e in prof.key_averages():
        # a record_function span (the optimizer's step) also shows on the
        # device's timeline: it is no kernel, and the kernels inside it
        # are counted on their own
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
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
        if kind == "other":
            others.append((e.self_device_time_total / 1e3, e.count, e.key))
    device_ms = sum(kinds.values())
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return kinds, device_ms, kernels, sorted(others, reverse=True)[:8]


_NAME_NOISE = re.compile(r"void |at::native::|[(]anonymous namespace[)]::")


def top_others(others):
    """The largest "other" kernels of a profiled step, one line."""
    return "; ".join(f"{ms:.1f} ms in {n} x {_NAME_NOISE.sub('', name)[:110]}"
                     for ms, n, name in others)


def phase_train_profile(train):
    """Device time of one 7B LoRA step by kind of kernel, against the timed
    steps' wall."""
    kinds, device_ms, kernels, others = step_profile(train)
    wall = train["ms_step"]
    log(f"[9] 7B LoRA step: wall {wall:.1f} ms (timed steps), device "
        f"kernels {device_ms:.1f} ms (busy {min(device_ms / wall, 1.0):.1%} "
        f"of wall): " + ", ".join(
            f"{k} {v:.1f} ms ({v / device_ms:.1%})" for k, v in
            kinds.items()) + f"; {kernels} kernel launches per step")
    log(f"[9] largest other kernels: {top_others(others)}")


def dense_setup(num_layers=None):
    """bench.py's dense rung (cut to ``num_layers`` if given) and a batch of
    B=4 x 2048 next-token pairs from numpy seed 0, as bench.py draws it."""
    cfg = dataclasses.replace(
        DENSE_CFG, num_layers=num_layers or DENSE_CFG.num_layers)
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (DENSE_B, DENSE_S + 1))
    tok = torch.from_numpy(tok).to(DEVICE)
    return cfg, {"inputs": tok[:, :-1], "targets": tok[:, 1:]}


def phase_dense():
    """The dense 1B rung at full width and depth: fp32 params drawn on the
    card, adafactor(1e-3), remat "dots"; one warm-up and DENSE_STEPS timed
    steps, then one profiled step. Returns (K1, K2, K3 launches over the
    timed steps, ms/step)."""
    cfg, batch = dense_setup()
    tx = adafactor(1e-3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_train_state(lambda g: init_llama(cfg, g, g.device), tx,
                               device=DEVICE, seed=0)
    step = make_train_step(lambda p, b: llama_loss(p, b, cfg), tx)
    state, m = step(state, batch)
    warm = (m["loss"].item(), m["grad_norm"].item())
    warm_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    metrics = []
    for _ in range(DENSE_STEPS):
        state, m = step(state, batch)
        metrics.append((m["loss"], m["grad_norm"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    max_mem = torch.cuda.max_memory_allocated() / 2**30
    metrics = [warm] + [(a.item(), b.item()) for a, b in metrics]
    if not all(np.isfinite(v) for pair in metrics for v in pair):
        raise AssertionError(f"non-finite loss or grad norm: {metrics}")
    L = cfg.num_layers
    # "dots" keeps only the products: each layer's flash call runs in the
    # forward and again in the backward's recompute
    want = (2 * L * DENSE_STEPS, L * DENSE_STEPS, L * DENSE_STEPS)
    if launches != want:
        raise AssertionError(f"dense launches (K1, K2, K3) {launches} != "
                             f"{want} over {DENSE_STEPS} steps")
    ms_step = wall / DENSE_STEPS * 1e3
    tokens = DENSE_B * DENSE_S
    tok_s = tokens * DENSE_STEPS / wall
    flops_tok = cfg.flops_per_token(DENSE_S)
    n_state = sum(t.numel() for st in state.opt_state.state.values()
                  for k, t in st.items() if k != "step")
    log(f"[10] dense {cfg.num_params() / 1e9:.3f} B params (fp32) B="
        f"{DENSE_B} S={DENSE_S}, remat {cfg.remat_policy}, loss_chunk "
        f"{cfg.loss_chunk}, adafactor(1e-3) ({n_state * 4 / 1e9:.3f} GB of "
        f"fp32 state): warm-up {warm_s:.1f} s (init and first step); (loss, "
        f"grad_norm) per step "
        f"{[(round(a, 5), round(b, 5)) for a, b in metrics]}; "
        f"{ms_step:.1f} ms/step, {tok_s:.0f} tokens/s, MFU "
        f"{tok_s * flops_tok / PEAK_FLOPS['bfloat16']:.1%} "
        f"({flops_tok * tokens / 1e12:.1f} TFLOP a step vs 989 TFLOP/s "
        f"bf16), launches K1 {launches[0]} = {2 * L} x {DENSE_STEPS}, K2 "
        f"{launches[1]} = K3 {launches[2]} = {L} x {DENSE_STEPS}, max "
        f"memory allocated {max_mem:.2f} GiB")
    kinds, device_ms, kernels, others = step_profile(
        dict(step=step, state=state, batch=batch))
    log(f"[10] dense step: wall {ms_step:.1f} ms (timed steps), device "
        f"kernels {device_ms:.1f} ms (busy "
        f"{min(device_ms / ms_step, 1.0):.1%} of wall): " + ", ".join(
            f"{k} {v:.1f} ms ({v / device_ms:.1%})" for k, v in
            kinds.items()) + f"; {kernels} kernel launches per step")
    log(f"[10] largest other kernels: {top_others(others)}")
    return dict(launches=launches, ms_step=ms_step)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {n: t for key in sorted(tree) for n, t in _named_leaves(
            tree[key], f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def phase_dense_grad_check():
    """Every grad of a 2-layer cut of the dense rung at B=4, S=2048: through
    the kernels vs through the plain reference attention, on the card."""
    cfg, batch = dense_setup(num_layers=2)
    params = init_llama(cfg, torch.Generator(device=DEVICE).manual_seed(31),
                        torch.device(DEVICE))

    def grads(c):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                     params)
        loss = llama_loss(p, batch, c)
        loss.backward()
        return loss.item(), {n: t.grad for n, t in _named_leaves(p).items()}

    reset_counts()
    loss, got = grads(cfg)
    if counts() != (4, 2, 2):  # 2 layers: forward + recompute, backward
        raise AssertionError(f"dense grad check launches {counts()} != "
                             f"(4, 2, 2)")
    ref_loss, want = grads(dataclasses.replace(cfg, attn_impl="reference"))
    errs = {}
    for name, g in got.items():
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"non-finite grad {name}")
        errs[name] = ((g - want[name]).norm() / want[name].norm()).item()
    worst = max(errs, key=errs.get)
    log(f"[11] 2-layer dense grads, kernels vs reference attention: loss "
        f"{loss:.5f} vs {ref_loss:.5f}; relative norm error per leaf max "
        f"{errs[worst]:.3e} at {worst} (tol {TOL_SLICE_REL:g}), " +
        ", ".join(f"{n} {e:.2e}" for n, e in sorted(errs.items())))
    if errs[worst] > TOL_SLICE_REL:
        raise AssertionError("dense kernel gradients disagree with reference")


def _rel_max(got, want):
    """max|got - want| / max|want|, in fp32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase_decode(gen):
    """kv-cache decode at 7B against the recompute path. The recompute path
    (the generator's own: one llama_forward over the whole sequence a token)
    picks DECODE_NEW + 1 greedy tokens; llama_decode then prefills the
    prompts and decodes the first DECODE_NEW of those tokens, one at a time,
    teacher-forced. Each call's last logits are held against the recompute
    path's at the same position."""
    cfg, params = gen._cfg, gen._params
    prompts = torch.randint(
        0, cfg.vocab_size, (DECODE_B, DECODE_PROMPT), device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(41))
    fwd_ms, dec_ms, want, errs, agree = [], [], [], [], []
    with torch.inference_mode():
        seq = prompts
        for _ in range(DECODE_NEW + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = llama_forward(params, seq, cfg)[:, -1]
            seq = torch.cat([seq, logits.argmax(-1)[:, None]], dim=1)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
            want.append(logits)
        greedy = seq[:, DECODE_PROMPT:]
        shape = (DECODE_B, DECODE_MAX_S, cfg.num_kv_heads, cfg.head_dim)
        caches = [(torch.zeros(shape, dtype=cfg.dtype, device=DEVICE),
                   torch.zeros(shape, dtype=cfg.dtype, device=DEVICE))
                  for _ in range(cfg.num_layers)]
        reset_counts()
        calls = [(prompts, 0)] + [(greedy[:, i:i + 1], DECODE_PROMPT + i)
                                  for i in range(DECODE_NEW)]
        for i, (toks, index) in enumerate(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = llama_decode(params, toks, cfg, caches, index)
            torch.cuda.synchronize()
            dec_ms.append((time.perf_counter() - t0) * 1e3)
            last = logits[:, -1]
            if last.shape != want[i].shape or not bool(
                    torch.isfinite(last).all()):
                raise AssertionError(f"bad decode logits at call {i}")
            errs.append(_rel_max(last, want[i]))
            agree.append((last.argmax(-1) == greedy[:, i]).float().mean()
                         .item())
    if counts() != (0, 0, 0):
        raise AssertionError(f"decode launched flash kernels: {counts()}")
    log(f"[12] 7B kv-cache decode B={DECODE_B}, prompt {DECODE_PROMPT}, "
        f"{DECODE_NEW} tokens teacher-forced, cache {DECODE_MAX_S} slots: "
        f"max|decode - forward| / max|forward| per call (prefill first) "
        f"{[f'{e:.2e}' for e in errs]} (tol {TOL_DEEP_REL:g}); argmax "
        f"agreement {statistics.mean(agree):.3f}; prefill "
        f"{dec_ms[0]:.2f} ms, decode step median "
        f"{statistics.median(dec_ms[1:]):.2f} ms vs recompute step median "
        f"{statistics.median(fwd_ms):.2f} ms (wall, synchronised, "
        f"B={DECODE_B})")
    if max(errs) > TOL_DEEP_REL:
        raise AssertionError("kv-cache decode disagrees with the forward")
    return dict(decode_ms=statistics.median(dec_ms[1:]),
                recompute_ms=statistics.median(fwd_ms))


def phase_merge(gen):
    """llama_forward at 7B on the base weights merged with adapter a1,
    against the activation-side adapter path."""
    cfg, lcfg = gen._cfg, gen._lcfg
    lora = gen._adapter("a1")
    merged = merge_lora(gen._params, lora, cfg, lcfg)
    tokens = torch.randint(
        0, cfg.vocab_size, (2, 256), device=DEVICE,
        generator=torch.Generator(device=DEVICE).manual_seed(42))
    with torch.inference_mode():
        got = llama_forward(merged, tokens, cfg)
        want = llama_forward(gen._params, tokens, cfg, lora=lora,
                             lora_cfg=lcfg)
    del merged
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"bad merged logits {tuple(got.shape)}")
    rel = ((got - want).norm() / want.norm()).item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[13] 7B merge_lora(a1) vs the adapter path, B=2 S=256: relative "
        f"error {rel:.3e} (tol {TOL_DEEP_REL:g}), argmax agreement "
        f"{agree:.4f}")
    if rel > TOL_DEEP_REL:
        raise AssertionError("merged weights disagree with the adapter path")


def phase_blockwise():
    """attention(impl="blockwise") against reference_attention, output and
    q/k/v grads, bf16, causal, at each of BLOCKWISE_SHAPES."""
    gen = torch.Generator(device=DEVICE).manual_seed(43)
    tol = TOL_GRAD_REL["bfloat16"]
    for B, H, KVH, S, D in BLOCKWISE_SHAPES:
        q, k, v, do = (torch.randn((B, S, n, D), generator=gen,
                                   device=DEVICE).bfloat16()
                       for n in (H, KVH, KVH, H))
        outs = {}
        for name, fn in (
                ("blockwise", lambda *a: attention(*a, impl="blockwise")),
                ("reference", reference_attention)):
            qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(qr, kr, vr)
            grads = torch.autograd.grad(out, (qr, kr, vr), do)
            end.record()
            end.synchronize()
            outs[name] = ((out.detach(),) + grads, start.elapsed_time(end))
        (got, ms), (want, ref_ms) = outs["blockwise"], outs["reference"]
        errs = {n: _rel_max(g, w) for n, g, w in zip(
            ("o", "dq", "dk", "dv"), got, want)}
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError("non-finite blockwise output or grad")
        log(f"[14] blockwise vs reference attention B={B} H={H} KVH={KVH} "
            f"S={S} D={D} causal bf16: max error / max|reference| "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (tol {tol:g}); forward + backward {ms:.2f} ms vs "
            f"reference {ref_ms:.2f} ms (one call each, first use)")
        if max(errs.values()) > tol:
            raise AssertionError(f"blockwise disagrees with reference: "
                                 f"{errs}")


def phase_mlp():
    """3 AdamW steps of the default MLP (784-512-10) on the card, against
    the same steps on the CPU from the same init and batch."""
    cfg = MLPConfig()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((128, cfg.in_dim))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, cfg.out_dim, (128,)))
    losses = {}
    for dev in (DEVICE, "cpu"):
        # the same init on both: drawn on the CPU, then moved
        state = create_train_state(
            lambda g: init_mlp(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu")), adamw(1e-3), device=dev)
        step = make_train_step(lambda p, b: mlp_loss(p, b, cfg), adamw(1e-3))
        batch = {"x": x.to(dev), "y": y.to(dev)}
        losses[dev] = []
        for _ in range(3):
            state, m = step(state, batch)
            losses[dev].append(m["loss"].item())
    got, want = losses[DEVICE], losses["cpu"]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    log(f"[15] MLP 784-512-10, 3 AdamW steps, B=128: losses on the card "
        f"{[round(v, 6) for v in got]}, on the CPU "
        f"{[round(v, 6) for v in want]}, max relative difference "
        f"{max(errs):.2e} (tol {TOL_MLP_REL:g})")
    if not all(np.isfinite(got)) or max(errs) > TOL_MLP_REL:
        raise AssertionError("MLP steps on the card disagree with the CPU")


def moe_flops(cfg, B, S):
    """(model FLOPs a step, executed FLOPs by part a step). The model's: 6 x
    the params a token meets (attention projections, router, its top-k
    experts' FFN, lm_head; the embedding is a gather) x tokens, plus the
    attention's score and value products at 12 x L x H x D x S a token, as
    ``LlamaConfig.flops_per_token`` reckons them. Executed: the expert
    products over every capacity slot (E x C rows an expert batch, forward
    and two backward products), the dense dispatch (forward, dx) and combine
    (forward and both grads) einsums, the projections, the full S x S score
    and value products of the reference attention, and the lm_head."""
    h, m, E, K, L = (cfg.hidden, cfg.mlp_hidden, cfg.num_experts,
                     cfg.experts_per_token, cfg.num_layers)
    nh, nkv, hd, V = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.vocab_size
    C, T = moe.capacity(cfg, S), B * S
    proj = h * (nh + 2 * nkv) * hd + nh * hd * h
    active = L * (proj + h * E + K * 3 * h * m) + h * V
    attn = 12.0 * L * nh * hd * S * T
    executed = {
        "experts at capacity": 18.0 * L * E * B * C * h * m,
        "dispatch/combine": 5 * 2.0 * L * T * E * C * h,
        "attention projections and router": 6.0 * L * (proj + h * E) * T,
        "attention scores and values": attn,
        "lm_head": 6.0 * h * V * T,
    }
    return 6.0 * active * T + attn, executed


def moe_routing(params, tokens, cfg):
    """One forward without grad: (each layer's ``moe.Routing``, the layers'
    aux loss summed). The module's ``route`` is wrapped for the call."""
    seen, route = [], moe.route

    def spy(c, x, router):
        r = route(c, x, router)
        seen.append(r)
        return r

    moe.route = spy
    try:
        with torch.no_grad():
            _, aux = moe.moe_forward(params, tokens, cfg)
    finally:
        moe.route = route
    return seen, aux.item()


MOE_KINDS = ("expert products", "dispatch/combine", "attention",
             "other products", "AdamW", "other")


def moe_op_kind(name, shapes, cfg, B, S):
    """The kind of an operator of the MoE step, from its name and input
    shapes: products (bmm/mm) by their batch and widths (the experts' batch
    is E, the attention's B x H; dispatch and combine have an E x C width or
    a B x S x E batch), AdamW by torch's foreach kernels, and elementwise
    work on an S x S score matrix or on the [..., E, C] masks by its
    shapes."""
    E, C = cfg.num_experts, moe.capacity(cfg, S)
    shapes = [tuple(sh) for sh in shapes if sh]
    if name.startswith("aten::_foreach_"):
        return "AdamW"
    if name in ("aten::bmm", "aten::mm") and shapes:
        batch = shapes[0][0] if len(shapes[0]) == 3 else 1
        dims = {d for sh in shapes for d in sh[-2:]}
        if batch == E:
            return "expert products"
        if batch == B * cfg.num_heads:
            return "attention"
        if E * C in dims or batch == B * S * E:
            return "dispatch/combine"
        return "other products"
    if any(len(sh) >= 2 and sh[-2:] == (S, S) for sh in shapes):
        return "attention"
    if any(len(sh) >= 2 and sh[-2:] == (E, C) for sh in shapes):
        return "dispatch/combine"
    return "other"


def moe_step_profile(step, state, batch, cfg, B, S):
    """Device time of one MoE train step by kind (``moe_op_kind``), from
    torch.profiler with input shapes: each operator's own kernels. Returns
    (ms by kind, device kernel ms in all, kernel launches, the largest
    "other" operators as (ms, launches, name and shapes))."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kinds = dict.fromkeys(MOE_KINDS, 0.0)
    others = {}
    for e in prof.events():
        # operators only: the runtime's own events ("Command Buffer Full")
        # carry the kernels they waited on a second time
        if (e.device_type != torch.autograd.DeviceType.CPU
                or not e.name.startswith("aten::") or not e.kernels):
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        kind = moe_op_kind(e.name, e.input_shapes or [], cfg, B, S)
        kinds[kind] += ms
        if kind == "other":
            key = f"{e.name} {[list(sh) for sh in e.input_shapes if sh]}"
            t, n = others.get(key, (0.0, 0))
            others[key] = (t + ms, n + len(e.kernels))
    device_ms, launches = 0.0, 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            device_ms += e.self_device_time_total / 1e3
            launches += e.count
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(((t, n, key) for key, (t, n) in others.items()),
                 reverse=True)[:8]
    return kinds, device_ms, launches, top


def phase_moe():
    """The MoE train step at Mixtral-8x7B width, 2 layers: fp32 params drawn
    on the card, adamw(1e-3); one warm-up and MOE_STEPS timed steps, the
    routing after them, then one profiled step. Returns (K1, K2, K3
    launches over the warm-up and timed steps, the params)."""
    cfg = MOE_CFG
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_B, MOE_S + 1))
    tok = torch.from_numpy(tok).to(DEVICE)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    tx = adamw(1e-3)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = create_train_state(lambda g: init_moe(cfg, g, g.device), tx,
                               device=DEVICE, seed=0)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    routing0, aux0 = moe_routing(state.params, batch["inputs"], cfg)
    step = make_train_step(lambda p, b: moe_loss(p, b, cfg), tx)
    t0 = time.perf_counter()
    state, m = step(state, batch)
    warm = (m["loss"].item(), m["grad_norm"].item())
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    metrics = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(MOE_STEPS):
        state, m = step(state, batch)
        metrics.append((m["loss"], m["grad_norm"]))
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    event_ms = start.elapsed_time(end) / MOE_STEPS
    max_mem = torch.cuda.max_memory_allocated() / 2**30
    metrics = [warm] + [(a.item(), b.item()) for a, b in metrics]
    if not all(np.isfinite(v) for pair in metrics for v in pair):
        raise AssertionError(f"non-finite loss or grad norm: {metrics}")
    if launches != (0, 0, 0):
        raise AssertionError(f"the MoE step launched flash kernels "
                             f"{launches}: its attention is the reference")
    routing, aux = moe_routing(state.params, batch["inputs"], cfg)
    if not (aux0 > 0 and aux > 0):
        raise AssertionError(f"aux loss {aux0}, {aux} is not positive")
    ms_step = wall / MOE_STEPS * 1e3
    tokens = MOE_B * MOE_S
    tok_s = tokens * MOE_STEPS / wall
    model_flops, executed = moe_flops(cfg, MOE_B, MOE_S)
    log(f"[16] MoE {n_params / 1e9:.3f} B params (fp32; hidden "
        f"{cfg.hidden}, {cfg.num_experts} experts of {cfg.mlp_hidden} top-"
        f"{cfg.experts_per_token}, capacity {moe.capacity(cfg, MOE_S)} "
        f"slots an expert, {cfg.num_heads} heads, {cfg.num_kv_heads} kv "
        f"heads, vocab {cfg.vocab_size}, {cfg.num_layers} layers) B={MOE_B} "
        f"S={MOE_S}, adamw(1e-3): init {init_s:.1f} s, first step "
        f"{warm_s:.1f} s; (loss, grad_norm) per step "
        f"{[(round(a, 5), round(b, 5)) for a, b in metrics]}; "
        f"{ms_step:.1f} ms/step (host clock), {event_ms:.1f} ms/step "
        f"(CUDA events), {tok_s:.0f} tokens/s, MFU "
        f"{tok_s * model_flops / tokens / PEAK_FLOPS['bfloat16']:.1%} "
        f"({model_flops / 1e12:.2f} TFLOP a step of the model vs 989 "
        f"TFLOP/s bf16); executed a step: " + ", ".join(
            f"{k} {v / 1e12:.2f}" for k, v in executed.items())
        + f" TFLOP ({sum(executed.values()) / 1e12:.2f} in all); aux loss "
        f"(summed over the layers) {aux0:.5f} at init, {aux:.5f} after the "
        f"last step; launches "
        f"K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}; max memory "
        f"allocated {max_mem:.2f} GiB")
    for when, rs in (("at init", routing0), ("after the last step",
                                            routing)):
        for i, r in enumerate(rs):
            routed = r.onehot.sum((0, 1, 2))
            kept = r.keep.sum((0, 1, 2))
            log(f"[16] routing {when}, layer {i}: (token, k) pairs per "
                f"expert {routed.tolist()}, kept {kept.tolist()} of "
                f"{moe.capacity(cfg, MOE_S)} slots, dropped "
                f"{1 - kept.sum().item() / routed.sum().item():.2%}")
    kinds, device_ms, kernels, others = moe_step_profile(
        step, state, batch, cfg, MOE_B, MOE_S)
    attributed = sum(kinds.values())
    log(f"[16] MoE step: wall {ms_step:.1f} ms (timed steps), device "
        f"kernels {device_ms:.1f} ms (busy {min(device_ms / ms_step, 1.0):.1%}"
        f" of wall), by operator: " + ", ".join(
            f"{k} {v:.1f} ms ({v / device_ms:.1%})" for k, v in
            kinds.items()) + f" ({device_ms - attributed:.1f} ms not "
        f"attributed to an operator); {kernels} kernel launches per step")
    log("[16] largest other operators: " + "; ".join(
        f"{t:.1f} ms in {n} x {key[:110]}" for t, n, key in others))
    return dict(launches=launches, params=state.params)


def phase_moe_check(params):
    """(a) _moe_ffn at full width on layer 0's weights of phase 16: the card
    (bf16 activations) against the CPU (fp32, from the same bf16 x and fp32
    weights). (b) 3 AdamW steps of the narrow fp32 MoE on the card against
    the same steps on the CPU."""
    cfg = MOE_CFG
    lp = {n: w[0].detach() for n, w in params["layers"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, MOE_FFN_S, cfg.hidden), dtype=np.float32)).bfloat16()
    cpu_cfg = dataclasses.replace(cfg, dtype=torch.float32)
    cpu_lp = {n: w.cpu() for n, w in lp.items()}
    out = {}
    for dev, c, p, xd in ((DEVICE, cfg, lp, x.to(DEVICE)),
                          ("cpu", cpu_cfg, cpu_lp, x.float())):
        t0 = time.perf_counter()
        with torch.no_grad():
            r = moe.route(c, xd, p["router"])
            y, aux = moe._moe_ffn(c, xd, p)
        if dev != "cpu":
            torch.cuda.synchronize()
        out[dev] = (r, y.float().cpu(), aux.item(),
                    time.perf_counter() - t0)
    (rc, yc, auxc, tc), (rh, yh, auxh, th) = out[DEVICE], out["cpu"]
    same = (rc.expert_idx.cpu() == rh.expert_idx)
    agree = same.float().mean().item()
    drops = [int((r.onehot.sum() - r.keep.sum()).item()) for r in (rc, rh)]
    probs = torch.sort(rh.probs, dim=-1, descending=True).values
    K = cfg.experts_per_token
    margin = (probs[..., :K] - probs[..., 1:K + 1]).min().item()
    tok_ok = same.all(-1) & (rc.keep.cpu() == rh.keep).all(-1).all(-1)
    y_err = ((yc - yh).abs()[tok_ok].max() / yh.abs().max()).item()
    aux_err = abs(auxc - auxh) / abs(auxh)
    if not bool(torch.isfinite(yc).all()):
        raise AssertionError("non-finite _moe_ffn output on the card")
    log(f"[17] _moe_ffn at full width, B=1 S={MOE_FFN_S} (capacity "
        f"{moe.capacity(cfg, MOE_FFN_S)}), card bf16 vs CPU fp32 from the "
        f"same bf16 x: routing agreement {agree:.4%} of (token, k) pairs "
        f"(need {MOE_ROUTING_AGREE:.1%}), dropped pairs {drops[0]} vs "
        f"{drops[1]}, smallest gap between consecutive top-{K + 1} router "
        f"probabilities {margin:.3e}; max|y - y_cpu| / max|y_cpu| "
        f"{y_err:.3e} over {int(tok_ok.sum())} tokens routed alike (tol "
        f"{TOL_MOE_Y_REL:g}); aux {auxc:.6f} vs {auxh:.6f}, relative "
        f"{aux_err:.2e} (tol {TOL_MOE_AUX_REL:g}); card {tc * 1e3:.1f} ms, "
        f"CPU {th * 1e3:.0f} ms (first call each)")
    if (agree < MOE_ROUTING_AGREE or drops[0] != drops[1]
            or y_err > TOL_MOE_Y_REL or aux_err > TOL_MOE_AUX_REL):
        raise AssertionError("_moe_ffn on the card disagrees with the CPU")

    cfg = MOE_NARROW_CFG
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (MOE_NARROW_B, MOE_NARROW_S + 1)))
    losses = {}
    for dev in (DEVICE, "cpu"):
        # the same init on both: drawn on the CPU, then moved
        state = create_train_state(
            lambda g: init_moe(cfg, torch.Generator().manual_seed(0),
                               torch.device("cpu")), adamw(1e-3), device=dev)
        step = make_train_step(lambda p, b: moe_loss(p, b, cfg), adamw(1e-3))
        batch = {"inputs": tok[:, :-1].to(dev), "targets": tok[:, 1:].to(dev)}
        losses[dev] = []
        for _ in range(3):
            state, m = step(state, batch)
            losses[dev].append(m["loss"].item())
    got, want = losses[DEVICE], losses["cpu"]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    log(f"[17] narrow MoE (hidden {cfg.hidden}, {cfg.num_experts} experts "
        f"of {cfg.mlp_hidden}, {cfg.num_layers} layers, fp32), 3 AdamW "
        f"steps, B={MOE_NARROW_B} S={MOE_NARROW_S}: losses on the card "
        f"{[round(v, 6) for v in got]}, on the CPU "
        f"{[round(v, 6) for v in want]}, max relative difference "
        f"{max(errs):.2e} (tol {TOL_MLP_REL:g})")
    if not all(np.isfinite(got)) or max(errs) > TOL_MLP_REL:
        raise AssertionError("MoE steps on the card disagree with the CPU")
    if not got[-1] < got[0]:
        raise AssertionError(f"the MoE loss did not fall: {got}")


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
    train_launches = train["launches"]
    del train  # the LoRA state and its step
    dense = phase_dense()
    phase_dense_grad_check()
    phase_decode(gen)
    phase_merge(gen)
    del gen  # the 7B base: phase 16 needs the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    phase_blockwise()
    phase_mlp()
    log(f"[16] memory allocated before the MoE phases "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    moe_run = phase_moe()
    phase_moe_check(moe_run.pop("params"))
    moe_launches = moe_run["launches"]

    # K1 at the serving path's B=4, S=128 (its headline numbers) and at the
    # training paths' B=1 and B=4, S=2048; K2 and K3 at the training shapes
    k1 = {r["key"]: r for r in records}
    k23 = {r["key"]: r for r in bwd}
    head, k1t, tb = k1[SERVE_SHAPE], k1[TRAIN_SHAPE], k23[TRAIN_SHAPE]
    k1_train, k1_dense = train_launches[0], dense["launches"][0]
    timing_keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/cuda/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/pallas/flash_attention.py:110",
        "launches": serve_launches + k1_train + k1_dense,
        "launches_by_path": {"serve": serve_launches, "train": k1_train,
                             "dense": k1_dense, "moe": moe_launches[0]},
        "max_abs_err": max(r["err_o"] for r in records),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_us": head["bound_ms"] * 1e3,
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "train_shape": {key: k1t[key] for key in timing_keys},
        "dense_shape": {key: k1[DENSE_SHAPE][key] for key in timing_keys},
    }]
    for i, kern, name, line in ((1, "dq", "flash_attention_dq", 275),
                                (2, "dkv", "flash_attention_dkv", 303)):
        r = tb[kern]
        n = train_launches[i] + dense["launches"][i]
        dense_rec = dict(k23[DENSE_SHAPE][kern],
                         shape=k23[DENSE_SHAPE]["shape"],
                         library_ms=k23[DENSE_SHAPE]["library_ms"])
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"ray_tpu_torch/ops/cuda/csrc/{name}.cu",
            "replaces": f"ray_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": n,
            "launches_by_path": {"train": train_launches[i],
                                 "dense": dense["launches"][i],
                                 "moe": moe_launches[i]},
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
            "dense_shape": {key: dense_rec[key] for key in timing_keys},
        })
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
