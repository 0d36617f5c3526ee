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
20. (Runs here, between 3 and 4.) Ring attention's per-rank hop schedule
    for P=4 at Llama-2-7B attention width (B=1, H=KVH=32, D=128, S=8192,
    2048 a rank, bf16, causal), every rank's chunks fed in this process:
    o and lse against K1 on the whole sequence, dq, dk and dv (summed over
    the ranks) against K2 and K3 on the whole sequence, K1 = K2 = K3 = 10
    launches (P(P+1)/2 hops), and the schedule's time beside the kernels'
    on the whole sequence. Phase 3 also times K1-K3 at the off-diagonal
    hop's shape (B=1, H=32, S=2048, not masked).
4. Drive the serving path: ``LlamaGenerator`` at full Llama-2-7B width
   (random weights from a seed, drawn on the card) answers 6 concurrent
   requests with multiplexed LoRA adapters; every attention call must have
   gone through K1.
5. Check the serving slice's output against its reference path on the
   card: a 2-layer cut of the same 7B weights with attention through the
   kernel and through the plain reference.
6. Show where a 7B forward's time goes: host wall, and device time by kind
   of kernel from torch.profiler.
18. (Runs here, between 6 and 7.) Serve the same 7B through the port's
    runtime: ``ray_tpu_torch.init`` must detect the GPU;
    ``serve.run(build_llama_app(config="llama2_7b", ...,
    ray_actor_options={"num_gpus": 1}))`` starts a replica that holds the
    card. Phase 4's 6 requests stream through the handle one at a time,
    each token for token equal to the in-process generator's at B=1, then
    all at once (tokens/s, ms per step, the time from ``init`` to RUNNING,
    beside phase 4's). The same app with a probed subclass of
    ``LlamaGenerator`` then shows from the replica process itself its pid
    (not the driver's), its K1 launches (32 x its forward steps) and the
    weights in its CUDA memory; a CUDA tensor sent to a task comes back as
    the same CPU tensor. After Serve and the runtime shut down, every
    process of the session must be gone, the card's memory back and the
    session's directory removed. A K1 build failure in the replica fails
    its constructor, the deployment and the phase; the session's logs are
    printed when the phase fails.
7. Drive the training path: the Llama-2-7B LoRA fine-tune step
   (``create_train_state`` + ``make_train_step``, rank 16 on all seven
   projections, ``adamw(1e-4)``, remat "full", ``loss_chunk=256``) at full
   width and depth, B=1, S=2048, on the generator's frozen bf16 base: one
   warm-up step and three timed ones, with finite loss and grad norm, and
   K1 = 64, K2 = K3 = 32 launches per step.
8. Check the training slice's gradients: the LoRA grads of a 2-layer cut,
   through the kernels and through the plain reference attention.
9. Show where a train step's time goes: device time by kind of kernel.
19. (Runs here, between 9 and 10.) Train through the port's runtime:
    ``ray_tpu_torch.init(num_gpus=1)`` and ``TorchTrainer.fit()`` with one
    GPU worker (``ScalingConfig(num_workers=1, use_gpu=True)``, a NCCL
    group of one) running phase 7's step in its own process: the 7B base
    drawn as ``LlamaGenerator`` draws it, the LoRA from seed 1, phase 7's
    batch; 1 + 3 steps whose losses and grad norms equal phase 7's within
    1e-3 relative, with K1 = 64 and K2 = K3 = 32 launches a step from the
    kernels phase 2 built (loaded, not rebuilt); a checkpoint of the state
    (LoRA params, AdamW moments, step; ``save_pytree``, ~480 MB) after step
    4, then step 5. A second ``fit`` resumes from that checkpoint, and its
    step equals the continued step 5. ``ParamsPredictor`` runs the
    checkpoint's adapters in the driver on 4 prompts of 128 tokens, equal
    to a direct ``llama_forward`` with K1 = 32 a call. After shutdown every
    process of the session is gone, the card's memory back and the session
    directory removed. Prints the time from ``fit()`` to the first report,
    ms/step in the worker beside phase 7's, the checkpoint's bytes and save
    time, the resumed fit's time and ``df -h /dev/shm``. A kernel that does
    not load, a NCCL group that does not form or a loop that raises in the
    worker makes ``fit`` return an error, and the phase fails.
21. (Runs here, after 19, in a new session of the port's runtime.) A
    ``num_gpus=1`` actor joins ``init_collective_group(1, 0,
    backend="nccl")`` and sends a CUDA tensor through allreduce, broadcast,
    allgather, reducescatter, barrier and ``allreduce_sharded`` over a
    one-rank mesh (``local_mesh()``), each against numpy; the same call in
    an actor that sees no card must raise.
22. (The same session.) ``TorchTrainer.fit()`` with one GPU worker whose
    loop builds ``create_mesh(MeshConfig(data=-1))`` over the trainer's
    NCCL group and runs phase 7's 7B LoRA step on it (the adapters placed
    by ``lora_logical_axes``, the frozen base by ``llama_logical_axes``):
    3 steps with ``attn_impl="flash"``, 3 with ``attn_impl="ring_seq"``,
    each against phase 7's first 3 within 1e-3 relative, K1 = 64 and K2 =
    K3 = 32 a step; the step's wall and device time beside phases 7 and
    9's, the worker's peak memory and the placements of a LoRA leaf, a
    base leaf and an AdamW moment. Then every process of the session gone
    and the card's memory back.
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
23. Expert parallelism at phase 16's size, after phase 16's state is
    freed: a world-size-1 NCCL group in this process, the MoE's params
    placed by ``moe_logical_axes`` on ``create_mesh(MeshConfig(data=-1,
    expert=1))``, 3 AdamW steps through DTensor equal to phase 16's first 3
    (every placement is replicated on one card, so no expert collective
    runs here: the CPU tests hold them on 4 and 8 gloo ranks).
24. The GPipe pipeline at Llama-2-7B width: ``make_pipeline_train_step``
    over 4 stages of one decoder layer each (fp32 params, bf16
    activations), 4 microbatches of B=1 x 2048, ``adamw(1e-3)``, every
    stage's ticks in this process: the output and grads equal to the 4
    layers applied in sequence through the same kernels, K1 = 16 a forward
    (the idle ticks skipped), 1 + 3 steps with K1 = K2 = K3 = 16 a step,
    ms/step and device ms.
25. ``PPOLearner`` on the card (fp32, TF32 off) against the CPU learner
    from the same params on the dry run's batch (obs 8, 4 actions, B=16).
26. The port's multichip entry at one rank: ``dryrun_multichip(1)``, its
    tiny-mesh section in a spawned NCCL rank on the card, then the two
    process gates over gloo on the CPU.

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
    (1, 32, 32, 2048, 128, False, "bfloat16"),  # a ring hop's, off-diagonal
]
SERVE_SHAPE = KERNEL_SHAPES[0]
TRAIN_SHAPE = (1, 32, 32, 2048, 128, True, "bfloat16")
DENSE_SHAPE = (4, 16, 16, 2048, 128, True, "bfloat16")
# an off-diagonal hop of ring attention at P=4 over S=8192, 7B attention
# width: K1 without the mask; K2 and K3 at the same shape (the hops pass
# the whole row's lse and delta, which changes no work)
RING_HOP_SHAPE = (1, 32, 32, 2048, 128, False, "bfloat16")
# K2 and K3: the training paths' shapes first (the 7B LoRA step at B=1,
# S=2048, the dense 1B step at B=4, S=2048), then GQA, non-causal and fp32 /
# D=64
BWD_SHAPES = [
    TRAIN_SHAPE,
    DENSE_SHAPE,
    RING_HOP_SHAPE,
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
# phase 19: the train worker's losses and grad norms against phase 7's (the
# same card, code, seeds and data: equal up to the order of floating-point
# sums that can differ between two processes, such as cuBLAS's choice of
# algorithm), and the resumed step's loss against the continued one's
TOL_TRAINER_REL = 1e-3
# phase 22: the meshed step's losses and grad norms against phase 7's. The
# same products on the same card, through DTensor at world size 1 (whose
# ops call the same kernels on the local tensors), and ring_seq's one
# diagonal hop is K1 on the whole sequence with an lse merge of one pair;
# what can differ is the order of floating-point sums where DTensor or the
# new process picks another cuBLAS algorithm, as in phase 19
TOL_MESH_REL = 1e-3
# phase 20: ring attention's schedule at P=4 over S=8192 (2048 a rank) at
# Llama-2-7B attention width, bf16, causal, every rank's hops in this
# process, against K1-K3 on the whole sequence
RING_P, RING_B, RING_H, RING_S, RING_D = 4, 1, 32, 8192, 128
N_TIMED = 30
# where phases 10-18 run (the card; a CPU rehearsal of their control flow at
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


def ring_schedule_run(qs, ks, vs, dos):
    """Every rank's hop schedule of ring attention, in this process: the
    forward of each rank on its q chunk with the kv chunks in their ring
    arrival order, then the backward with the whole row's lse and delta,
    each hop's dk and dv summed into its source chunk. Returns (o, lse, dq,
    dk, dv), each rank's chunks concatenated along the sequence."""
    from ray_tpu_torch.ops import ring_attention as ra

    P = len(qs)

    def kv(r):
        return [(ks[(r - j) % P], vs[(r - j) % P]) for j in range(P)]

    outs = [ra.ring_fwd_schedule(qs[r], r, P, kv(r), True) for r in range(P)]
    os_ = [o.to(qs[0].dtype) for o, _ in outs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
          for k in ks]
    dv = [torch.zeros_like(t) for t in dk]
    dq = []
    for r in range(P):
        def add(j, a, b, r=r):
            dk[(r - j) % P].add_(a)
            dv[(r - j) % P].add_(b)
        delta = fa._delta(os_[r], dos[r])
        dq.append(ra.ring_bwd_schedule(qs[r], dos[r], outs[r][1], delta, r,
                                       P, kv(r), True, add))
    cat = lambda ts: torch.cat(ts, dim=2)  # noqa: E731
    return (cat(os_), cat([lse for _, lse in outs]), cat(dq), cat(dk),
            cat(dv))


def phase_ring_schedule():
    """Phase 20: ring attention's per-rank hop schedule for P = RING_P at
    Llama-2-7B attention width (B=1, H=KVH=32, D=128, S=8192, 2048 a rank,
    bf16, causal), every rank's chunks fed in this process: o and lse
    against K1 on the whole sequence; dq, dk and dv, summed over the ranks,
    against K2 and K3 on the whole sequence; K1 = K2 = K3 = P(P+1)/2
    launches (the backward recomputes no forward); the schedule's time
    beside the kernels' on the whole sequence. Returns the launches and the
    times."""
    P, B, H, S, D = RING_P, RING_B, RING_H, RING_S, RING_D
    gen = torch.Generator(device=DEVICE).manual_seed(2020)
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device=DEVICE,
                               dtype=torch.float32).to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(4))
    o_ref, lse_ref = fa.flash_attention_fwd(q, k, v, True)
    delta_ref = fa._delta(o_ref, do)
    want = (o_ref, lse_ref,
            fa.flash_attention_dq(q, k, v, do, lse_ref, delta_ref, True),
            *fa.flash_attention_dkv(q, k, v, do, lse_ref, delta_ref, True))
    chunks = [t.chunk(P, dim=2) for t in (q, k, v, do)]
    reset_counts()
    got = ring_schedule_run(*chunks)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    launches = counts()
    hops = P * (P + 1) // 2
    errs = {}
    for name, g, w in zip(("o", "lse", "dq", "dk", "dv"), got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ring {name}: {tuple(g.shape)} against "
                                 f"{tuple(w.shape)}, or not finite")
        e = (g.float() - w.float()).abs().max().item()
        errs[name] = e if name in ("o", "lse") else \
            e / w.float().abs().max().item()
    t_sched = cuda_ms(lambda: ring_schedule_run(*chunks), 5, 1)
    t_fwd = cuda_ms(lambda: [fa.flash_attention_fwd(q, k, v, True)], 5, 1)
    t_bwd = cuda_ms(lambda: (
        fa.flash_attention_dq(q, k, v, do, lse_ref, delta_ref, True),
        fa.flash_attention_dkv(q, k, v, do, lse_ref, delta_ref, True)), 5, 1)
    tol_g = TOL_GRAD_REL["bfloat16"]
    log(f"[20] ring schedule P={P}, B={B} H=KVH={H} S={S} ({S // P} a "
        f"rank) D={D} bf16 causal, every rank in this process: max|o - K1 "
        f"whole| {errs['o']:.3e} (tol {TOL_O['bfloat16']:g}), max|lse - "
        f"K1's| {errs['lse']:.3e} (tol {TOL_LSE:g}); dq, dk, dv against K2, "
        f"K3 on the whole sequence, / max|whole|: {errs['dq']:.3e}, "
        f"{errs['dk']:.3e}, {errs['dv']:.3e} (tol {tol_g:g}); launches (K1, "
        f"K2, K3) {launches} (want {hops} each: P(P+1)/2 hops, no forward "
        f"recomputed); schedule forward + backward {t_sched:.3f} ms against "
        f"K1 + K2 + K3 on the whole sequence {t_fwd + t_bwd:.3f} ms (K1 "
        f"{t_fwd:.3f}, K2 + K3 {t_bwd:.3f})")
    if errs["o"] > TOL_O["bfloat16"] or errs["lse"] > TOL_LSE or max(
            errs[n] for n in ("dq", "dk", "dv")) > tol_g:
        raise AssertionError(f"the ring schedule disagrees with the "
                             f"kernels on the whole sequence: {errs}")
    if DEVICE == "cuda" and launches != (hops, hops, hops):
        raise AssertionError(f"ring launches {launches} != {hops} each")
    return dict(launches=launches, ms=t_sched, whole_ms=t_fwd + t_bwd,
                errs=errs)


def serving_requests(cfg):
    """Phase 4's 6 requests: prompts of 20-200 tokens drawn from seed 7,
    the adapters, and 16 new tokens each; the last repeats the first."""
    rng = torch.Generator().manual_seed(7)
    lens = torch.randint(20, 201, (6,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in lens]
    adapters = ["", "a1", "", "a2", "", ""]
    prompts[5] = prompts[0]  # same adapter and prompt: same tokens
    return lens, prompts, adapters, 16


def phase_main_path():
    """7B LlamaGenerator answers 6 concurrent requests; returns (flash
    kernel launches during the requests, the generator, the run's figures:
    init s, wall s, steps, ms/step, generated tokens/s)."""
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

    lens, prompts, adapters, max_new = serving_requests(cfg)
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
    figures = {"init_s": init_s, "wall_s": wall, "steps": steps,
               "ms_step": wall / steps * 1e3,
               "tok_s": 6 * max_new / wall}
    return launches, gen, figures


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


def _stream_requests(handle, prompts, adapters, max_new, concurrent):
    """Stream each request through the handle, the adapter as the request's
    multiplexed model id: one at a time, or all at once from threads.
    Returns (token lists, wall s)."""
    out, errors = {}, []

    def run(i):
        try:
            resp = handle.options(stream=True,
                                  multiplexed_model_id=adapters[i]).remote(
                {"prompt": prompts[i], "max_new": max_new})
            out[i] = list(resp)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    if concurrent:
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if any(th.is_alive() for th in threads):
            raise AssertionError("a request did not finish within 600 s")
    else:
        for i in range(len(prompts)):
            run(i)
            if errors:
                break
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return [out[i] for i in range(len(prompts))], wall


def _log_tail(session_dir, n_bytes=4000, tag="18"):
    """The end of every log of the port's session (the replica's or the
    train worker's stderr among them): printed when the phase fails, before
    the session goes."""
    logs = os.path.join(session_dir, "logs")
    for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
        path = os.path.join(logs, name)
        if not os.path.isfile(path):
            continue
        with open(path, "rb") as f:
            f.seek(max(0, os.path.getsize(path) - n_bytes))
            tail = f.read().decode("utf-8", "replace").strip()
        if tail:
            log(f"[{tag}] --- {name} (last {n_bytes} bytes) ---\n{tail}")


def generate_alone(gen, prompt, adapter, max_new):
    """One request through the generator's own prefill and step at B=1, as
    its engine runs a request that is alone (phase 4 shut that engine
    down)."""
    state = gen._prefill({"prompt": prompt, "max_new": max_new}, adapter)
    toks, done = [], False
    while not done:
        (nxt, done), = gen._step(adapter, [state])
        toks.append(nxt)
    return toks


def _device_available():
    """Bytes the card could give: its free memory plus what this process's
    allocator holds. Another process's allocation lowers it."""
    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()


def _check_session_gone(tag, session_dir, procs, avail_before, pid, role):
    """After ``ray_tpu_torch.shutdown()``: every process the session
    registered (``procs``, read before the shutdown) and the worker ``pid``
    are gone, the card gives back what it gave before ``init`` (within 512
    MiB) and the session's directory is removed."""
    from ray_tpu_torch._private import lifecycle

    def alive():
        return [f"{r['role']}:{r['pid']}" for r in procs
                if lifecycle._pid_alive(r["pid"], r.get("create_time"))]

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and (
            alive() or lifecycle._pid_alive(pid)):
        time.sleep(0.2)
    on_card = DEVICE == "cuda"
    avail_after = _device_available() if on_card else 0
    left = [s for s in lifecycle.list_sessions()
            if os.path.normpath(s["path"]) == os.path.normpath(session_dir)]
    log(f"[{tag}] after shutdown: {len(procs)} processes of the session, "
        f"alive {alive()} ({role} {pid} among them: "
        f"{lifecycle._pid_alive(pid)}); the card gives "
        f"{(avail_before - avail_after) / 2**20:.0f} MiB less than before "
        f"init; sessions left {[s['path'] for s in left]}")
    if alive() or lifecycle._pid_alive(pid):
        raise AssertionError(f"{alive()} outlived the shutdown")
    if on_card and avail_before - avail_after > 512 * 2**20:
        raise AssertionError(f"the {role}'s memory did not come back")
    if left:
        raise AssertionError(f"session {session_dir} outlived the shutdown")


def phase_serve_deployment(gen, inproc):
    """Serve 7B through the port's runtime: ``ray_tpu_torch.init`` (the GPU
    detected), ``serve.run(build_llama_app(...))`` with a replica that holds
    the card; phase 4's 6 requests one at a time, token for token against
    the in-process generator at B=1, then all at once. Then the same app
    with a probed subclass of ``LlamaGenerator``, to read from the replica
    process itself its pid, its K1 launches (32 x its forward steps) and its
    memory. Shuts Serve and the runtime down and checks that the replica
    and its memory are gone. Returns the replica's K1 launches and the
    figures."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import lifecycle
    from ray_tpu_torch.serve import llm

    cfg = gen._cfg
    _, prompts, adapters, max_new = serving_requests(cfg)
    # the deployed config is the reference generator's own (llama2_7b)
    app_kw = dict(config=cfg, lora_rank=4, seq_bucket=128,
                  max_batch_size=4, allowed_batch_sizes=(1, 2, 4),
                  max_new_tokens=max_new)
    on_card = DEVICE == "cuda"
    if not on_card:
        app_kw["device"] = DEVICE

    # the reference: the in-process generator, one request at a time (B=1)
    want = [generate_alone(gen, prompts[i], adapters[i], max_new)
            for i in range(6)]
    avail_before = _device_available() if on_card else 0

    class ProbedGenerator(llm.LlamaGenerator):
        """``LlamaGenerator`` that also reports, from its own process, the
        K1 launches since the process started, its engine steps and what
        its weights hold on the card."""

        def probe(self):
            import os as _os

            from ray_tpu_torch._private.tree import tree_leaves
            from ray_tpu_torch.ops.cuda import flash_attention as _fa

            on = self.device.type == "cuda"
            if on:
                torch.cuda.synchronize()
            return {
                "pid": _os.getpid(),
                "visible": _os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": torch.cuda.get_device_name(0) if on else "cpu",
                "launches": _fa.launches,
                "bwd_launches": _fa.dq_launches + _fa.dkv_launches,
                "steps": self.engine.stats()["steps"],
                "layers": self._cfg.num_layers,
                "param_bytes": sum(x.numel() * x.element_size()
                                   for x in tree_leaves(self._params)
                                   if x.device.type == self.device.type),
                "allocated": torch.cuda.memory_allocated() if on else 0,
            }

    t_init = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    try:
        gpus = ray_tpu_torch.cluster_resources().get("GPU", 0)
        log(f"[18] ray_tpu_torch.init: session {session_dir}, GPU resource "
            f"detected {gpus:g}, {time.perf_counter() - t_init:.2f} s")
        if gpus != 1:
            raise AssertionError(f"GPU resource {gpus} != 1")
        serve.start(http_options={"port": 0})
        handle = serve.run(llm.build_llama_app(
            **app_kw, ray_actor_options={"num_gpus": 1}), name="llama",
            wait_timeout_s=600)
        running_s = time.perf_counter() - t_init
        log(f"[18] build_llama_app RUNNING {running_s:.2f} s after init "
            f"began")
        got, seq_wall = _stream_requests(handle, prompts, adapters, max_new,
                                         concurrent=False)
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                first = next((k for k, (a, b) in enumerate(zip(g, w))
                              if a != b), min(len(g), len(w)))
                raise AssertionError(
                    f"request {i} ({adapters[i] or 'base'}): the replica's "
                    f"stream diverges from the in-process generator at "
                    f"token {first}: {g} vs {w}")
        seq_steps = handle.engine_stats.remote().result(
            timeout_s=60)["steps"]
        log(f"[18] sequential: 6 streams equal, token for token, to the "
            f"in-process generator's at B=1 ({seq_steps} steps, "
            f"{seq_wall:.2f} s)")
        got, wall = _stream_requests(handle, prompts, adapters, max_new,
                                     concurrent=True)
        stats = handle.engine_stats.remote().result(timeout_s=60)
        steps = stats["steps"] - seq_steps
        if any(len(g) != max_new or not all(
                isinstance(x, int) and 0 <= x < cfg.vocab_size for x in g)
               for g in got):
            raise AssertionError(f"concurrent streams: {got}")
        if got[0] != got[5]:
            raise AssertionError("same prompt and adapter diverged")
        figures = {"init_to_running_s": running_s, "wall_s": wall,
                   "steps": steps, "ms_step": wall / steps * 1e3,
                   "tok_s": 6 * max_new / wall,
                   "max_batch": stats["max_batch"]}
        log(f"[18] concurrent: 6 x {max_new} tokens in {wall:.2f} s, "
            f"{steps} steps ({stats['max_batch']} max batch), "
            f"{figures['ms_step']:.1f} ms/step, {figures['tok_s']:.1f} "
            f"generated tokens/s; in-process (phase 4) "
            f"{inproc['ms_step']:.1f} ms/step, {inproc['tok_s']:.1f} "
            f"generated tokens/s, {inproc['steps']} steps")
        serve.delete("llama")

        # the same app, its generator probed: the proof from the replica
        probed = serve.deployment(
            name="LlamaGenerator",
            max_ongoing_requests=max(16, 2 * app_kw["max_batch_size"]),
            max_queued_requests=32,
            ray_actor_options={"num_gpus": 1})(ProbedGenerator)
        handle = serve.run(probed.bind(**app_kw), name="probed",
                           wait_timeout_s=600)
        got, _ = _stream_requests(handle, prompts, adapters, max_new,
                                  concurrent=True)
        if any(len(g) != max_new for g in got):
            raise AssertionError(f"probed streams: {got}")
        pr = handle.probe.remote().result(timeout_s=60)
        avail_during = _device_available() if on_card else 0
        log(f"[18] replica pid {pr['pid']} (driver {os.getpid()}), "
            f"CUDA_VISIBLE_DEVICES={pr['visible']}, {pr['device']}: K1 "
            f"launches {pr['launches']} = {pr['layers']} x {pr['steps']} "
            f"steps, backward launches {pr['bwd_launches']}, weights "
            f"{pr['param_bytes'] / 2**30:.2f} GiB of "
            f"{pr['allocated'] / 2**30:.2f} GiB allocated; the card has "
            f"{(avail_before - avail_during) / 2**30:.2f} GiB less to give")
        if pr["pid"] == os.getpid():
            raise AssertionError("the replica runs in the driver's process")
        if pr["bwd_launches"] != 0:
            raise AssertionError("the replica ran backward kernels")
        if on_card and (pr["launches"] <= 0 or
                        pr["launches"] != pr["layers"] * pr["steps"]):
            raise AssertionError("replica K1 launches != layers x steps")
        if on_card and (pr["param_bytes"] < cfg.num_params() * 2 or
                        pr["allocated"] < pr["param_bytes"] or
                        avail_before - avail_during < pr["param_bytes"]):
            raise AssertionError("the replica's weights are not on the card")

        # a CUDA tensor crosses the process boundary as a CPU tensor
        @ray_tpu_torch.remote(num_cpus=1)
        def echo(x):
            return (x.device.type, x)

        sent = torch.arange(1 << 20, device=DEVICE, dtype=torch.float32)
        where, back = ray_tpu_torch.get(echo.remote(sent), timeout=120)
        if where != "cpu" or back.device.type != "cpu" or not torch.equal(
                back, sent.cpu()):
            raise AssertionError("a CUDA tensor did not come back as the "
                                 "same CPU tensor")
        log(f"[18] a {DEVICE} tensor (4 MiB) went to a task and back as the "
            f"same CPU tensor")
        replica_launches = pr["launches"]
    except BaseException:
        _log_tail(session_dir)
        raise
    finally:
        # every process the session started: head, agent, forkserver,
        # workers (both replicas among them)
        procs = lifecycle.list_registered(session_dir)
        serve.shutdown()
        ray_tpu_torch.shutdown()

    _check_session_gone("18", session_dir, procs, avail_before,
                        pr["pid"], "replica")
    return replica_launches, figures


def train_setup(gen, num_layers=None):
    """bench.py's Llama-2-7B LoRA rung: rank 16 on all seven projections,
    remat "full", loss_chunk 256, on the generator's frozen bf16 base; and a
    batch of B=1 x 2048 next-token pairs from a numpy seed."""
    cfg = dataclasses.replace(
        gen._cfg, max_seq_len=TRAIN_S, remat=True, remat_policy="full",
        loss_chunk=256, num_layers=num_layers or gen._cfg.num_layers)
    lcfg = LoraConfig(rank=16)
    tok = torch.from_numpy(train_tokens(cfg)).to(gen.device)
    return cfg, lcfg, {"inputs": tok[:, :-1], "targets": tok[:, 1:]}


def train_tokens(cfg):
    """The 7B LoRA step's batch as numpy token ids, B=TRAIN_B x (TRAIN_S +
    1), from numpy seed 0: inputs are [:, :-1], targets [:, 1:]."""
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))


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
                batch=batch, metrics=metrics)


def phase_train_runtime(gen, card, inproc):
    """Phase 19: the 7B LoRA step of phase 7 through the port's Train plane.
    ``TorchTrainer.fit()`` on ``ray_tpu_torch.init(num_gpus=1)`` runs it in
    one GPU worker (NCCL group of one): 1 + 3 steps as phase 7, a checkpoint
    of the state (LoRA params, AdamW moments, step) after step 4, step 5;
    a second ``fit`` resumes from that checkpoint and runs step 5 again;
    ``ParamsPredictor`` runs the checkpoint's adapters in the driver. Then
    the runtime shuts down and its processes and memory must be gone.
    ``inproc`` is phase 7's run. Returns the worker's (K1, K2, K3) launches
    over both fits and the predictor's K1 launches."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch._private import lifecycle
    from ray_tpu_torch.train import (
        CheckpointConfig, FailureConfig, ParamsPredictor, RunConfig,
        ScalingConfig, TorchTrainer, load_pytree)

    cfg, lcfg, _ = train_setup(gen)
    on_card = DEVICE == "cuda"

    def loop(config):
        """The worker: phase 7's step on the worker's card, each step
        reported with its loss, grad norm, wall ms, K1-K3 launches; the
        state checkpointed after step ``checkpoint_at``."""
        import dataclasses
        import os
        import shutil
        import tempfile
        import time

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import resolve_device, train
        from ray_tpu_torch.models.llama import (
            init_llama, init_lora, llama_lora_loss)
        from ray_tpu_torch.ops.cuda import _build
        from ray_tpu_torch.ops.cuda import flash_attention as fa
        from ray_tpu_torch.parallel import (
            adamw, create_train_state, load_train_state, make_train_step,
            train_state_tree)

        t_start = time.time()
        dev = resolve_device(config["device"])
        on = dev.type == "cuda"
        # the kernels phase 2 built into the checkout: loaded, not rebuilt;
        # a failure to load fails the loop, and with it fit()
        prebuilt = {}
        if on:
            for name in config["kernels"]:
                prebuilt[name] = _build._target(name)[1].exists()
                _build.load(name)
        cfg, lcfg = config["cfg"], config["lcfg"]
        tok = torch.tensor(config["tokens"], device=dev)
        batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
        # the frozen base as LlamaGenerator draws it (serve/llm.py)
        base_cfg = config["base_cfg"]
        g = torch.Generator(device=dev).manual_seed(0)
        base = init_llama(dataclasses.replace(
            base_cfg, param_dtype=base_cfg.dtype), g, dev)
        tx = adamw(1e-4)
        ckpt = train.get_checkpoint()
        read_s = rebuild_s = None
        if ckpt is None:
            state = create_train_state(
                lambda gg: init_lora(cfg, lcfg, gg, gg.device), tx,
                device=dev, seed=1)
        else:
            t0 = time.perf_counter()
            with ckpt.as_directory() as d:
                tree = train.load_pytree(d, "state")
            read_s = time.perf_counter() - t0
            # the process's first optimizer: torch imports its compiler
            # stack here, as create_train_state does in the first fit
            state = load_train_state(tree, tx, device=dev)
            rebuild_s = time.perf_counter() - t0 - read_s
            del tree
        step = make_train_step(
            lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg), tx,
            frozen=base)
        info = {"pid": os.getpid(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "backend": dist.get_backend(), "prebuilt": prebuilt,
                "device": torch.cuda.get_device_name(0) if on else "cpu",
                "read_s": read_s, "rebuild_s": rebuild_s,
                "t_start": t_start, "t_ready": time.time()}
        if on:
            torch.cuda.reset_peak_memory_stats()
        history = []
        for _ in range(config["steps"]):
            before = (fa.launches, fa.dq_launches, fa.dkv_launches)
            if on:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, gnorm = m["loss"].item(), m["grad_norm"].item()
            ms = (time.perf_counter() - t0) * 1e3
            history.append({
                "step": m["step"], "loss": loss, "grad_norm": gnorm,
                "ms": ms, "t": time.time(),
                "launches": [a - b for a, b in zip(
                    (fa.launches, fa.dq_launches, fa.dkv_launches),
                    before)]})
            d = None
            if m["step"] == config["checkpoint_at"]:
                t0 = time.perf_counter()
                d = tempfile.mkdtemp(prefix="lora_state_")
                train.save_pytree(train_state_tree(state), d, "state")
                info["save_s"] = time.perf_counter() - t0
                info["ckpt_bytes"] = sum(
                    os.path.getsize(os.path.join(d, f))
                    for f in os.listdir(d))
            info["max_mem"] = torch.cuda.max_memory_allocated() if on else 0
            train.report(dict(info, history=history),
                         checkpoint=train.Checkpoint(d) if d else None)
            if d:
                shutil.rmtree(d)

    shm = shutil.disk_usage("/dev/shm")
    df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True,
                        text=True, timeout=30).stdout.strip()
    # the object store lives in /dev/shm: keep it within half of what is
    # free there, and it must hold a disk checkpoint's in-store copies
    store_bytes = min(16 << 30, shm.free // 2)
    log(f"[19] df -h /dev/shm:\n{df}\n[19] object store "
        f"{store_bytes / 2**30:.2f} GiB")
    if store_bytes < 2 << 30:
        raise AssertionError(f"/dev/shm has {shm.free / 2**30:.2f} GiB free: "
                             f"too little for the 7B state's checkpoint")
    storage = tempfile.mkdtemp(prefix="chip_smoke_train_")
    loop_cfg = {"cfg": cfg, "lcfg": lcfg, "base_cfg": gen._cfg,
                "tokens": train_tokens(cfg), "device": DEVICE,
                "kernels": TENSOR_CORE_LIBS,
                "steps": 1 + TRAIN_STEPS + 1,
                "checkpoint_at": 1 + TRAIN_STEPS}
    scaling = ScalingConfig(num_workers=1, use_gpu=on_card)

    def run_config(name):
        return RunConfig(
            name=name, storage_path=storage,
            failure_config=FailureConfig(max_failures=0),
            checkpoint_config=CheckpointConfig(num_to_keep=2))

    avail_before = _device_available() if on_card else 0
    ray_tpu_torch.init(num_cpus=4, num_gpus=1 if on_card else 0,
                       object_store_memory=store_bytes)
    session_dir = ray_tpu_torch._global_node.session_dir
    try:
        t_fit = time.time()
        result = TorchTrainer(
            loop, train_loop_config=loop_cfg, scaling_config=scaling,
            run_config=run_config("lora_7b")).fit()
        fit_s = time.time() - t_fit
        if result.error is not None or result.restarts != 0:
            raise AssertionError(f"fit: error {result.error!r}, restarts "
                                 f"{result.restarts}")
        m = result.metrics
        hist = m["history"]
        t_resume = time.time()
        resumed = TorchTrainer(
            loop, train_loop_config=dict(loop_cfg, steps=1),
            scaling_config=scaling, run_config=run_config("lora_7b_resumed"),
            resume_from_checkpoint=result.checkpoint).fit()
        resume_s = time.time() - t_resume
        if resumed.error is not None or resumed.restarts != 0:
            raise AssertionError(f"resumed fit: error {resumed.error!r}, "
                                 f"restarts {resumed.restarts}")
        rm = resumed.metrics

        # the predictor, in the driver, on the checkpoint's adapters
        fwd_cfg = gen._cfg
        prompts = np.random.default_rng(19).integers(
            0, fwd_cfg.vocab_size, (4, 128))
        reset_counts()
        pred = ParamsPredictor.from_checkpoint(
            result.checkpoint, name="state", device=DEVICE,
            apply_fn=lambda lo, x: llama_forward(
                gen._params, x, fwd_cfg, lora=lo, lora_cfg=lcfg))
        got = pred.predict({"features": prompts})["predictions"]
        pred_launches = counts()
        with result.checkpoint.as_directory() as d:
            lora = load_pytree(d, "state", device=DEVICE)["params"]
        with torch.no_grad():
            want = llama_forward(
                gen._params, torch.from_numpy(prompts).to(DEVICE), fwd_cfg,
                lora=lora, lora_cfg=lcfg).cpu().numpy()
        del pred, lora
    except BaseException:
        _log_tail(session_dir, tag="19")
        raise
    finally:
        # every process the session started: head, agent, forkserver and
        # the train workers of both fits
        procs = lifecycle.list_registered(session_dir)
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)

    # what the worker reported
    L = cfg.num_layers
    per_step = (2 * L, L, L) if on_card else (0, 0, 0)
    worker_ms = statistics.mean(h["ms"] for h in hist[1:1 + TRAIN_STEPS])
    log(f"[19] TorchTrainer.fit: worker pid {m['pid']} (driver "
        f"{os.getpid()}), CUDA_VISIBLE_DEVICES={m['visible']}, "
        f"{m['device']}, backend {m['backend']}, kernels already built "
        f"{m['prebuilt']}; first report {hist[0]['t'] - t_fit:.2f} s after "
        f"fit() began (the loop began at {m['t_start'] - t_fit:.2f} s, had "
        f"its base and state at {m['t_ready'] - t_fit:.2f} s), fit "
        f"{fit_s:.2f} s; (step, loss, grad_norm, ms) "
        f"{[(h['step'], round(h['loss'], 5), round(h['grad_norm'], 5), round(h['ms'], 1)) for h in hist]}; "
        f"launches per step {[tuple(h['launches']) for h in hist]}; max "
        f"memory allocated {m['max_mem'] / 2**30:.2f} GiB")
    if m["pid"] == os.getpid():
        raise AssertionError("the train worker runs in the driver's process")
    if [h["step"] for h in hist] != list(range(1, 2 + TRAIN_STEPS + 1)):
        raise AssertionError(f"steps {[h['step'] for h in hist]}")
    if any(tuple(h["launches"]) != per_step for h in hist + rm["history"]):
        raise AssertionError(f"worker launches per step != {per_step}")
    if on_card and (m["visible"] != "0" or m["backend"] != "nccl"
                    or not all(m["prebuilt"].values())):
        raise AssertionError("the worker did not hold the card through NCCL "
                             "with the prebuilt kernels")
    # phase 7's (loss, grad_norm) per step, in process, on the same card
    errs = [abs(a - b) / abs(b) for h, pair in zip(hist, inproc["metrics"])
            for a, b in zip((h["loss"], h["grad_norm"]), pair)]
    log(f"[19] the worker's losses and grad norms against phase 7's: "
        f"largest relative difference {max(errs):.3e} (tol "
        f"{TOL_TRAINER_REL:g}); ms/step {worker_ms:.1f} in the worker (steps "
        f"2-{1 + TRAIN_STEPS}, each synchronised) vs {inproc['ms_step']:.1f} "
        f"in process (phase 7)")
    if len(errs) != 2 * (1 + TRAIN_STEPS) or max(errs) > TOL_TRAINER_REL:
        raise AssertionError("the worker's steps disagree with phase 7's")
    cont, res = hist[-1], rm["history"][0]
    res_err = abs(res["loss"] - cont["loss"]) / abs(cont["loss"])
    log(f"[19] checkpoint after step {1 + TRAIN_STEPS}: "
        f"{m['ckpt_bytes'] / 1e6:.1f} MB, saved in {m['save_s']:.2f} s; "
        f"resumed fit {resume_s:.2f} s (loop began at "
        f"{rm['t_start'] - t_resume:.2f} s; checkpoint read in "
        f"{rm['read_s']:.2f} s, state rebuilt in {rm['rebuild_s']:.2f} s): "
        f"step {res['step']} loss "
        f"{res['loss']:.6f} vs {cont['loss']:.6f} continued (relative "
        f"difference {res_err:.3e}, tol {TOL_TRAINER_REL:g}), grad norm "
        f"{res['grad_norm']:.6f} vs {cont['grad_norm']:.6f}")
    if res["step"] != cont["step"] or res_err > TOL_TRAINER_REL:
        raise AssertionError("the resumed step differs from the continued")
    pred_err = float(np.abs(got - want).max())
    log(f"[19] ParamsPredictor in the driver, 4 prompts x 128 tokens: "
        f"logits {got.shape}, max|predictor - llama_forward| {pred_err:.3e} "
        f"(max|logit| {float(np.abs(want).max()):.2f}); K1 launches "
        f"{pred_launches[0]} = {L} x 1 call")
    if got.shape != want.shape or not np.isfinite(got).all() or \
            pred_err > 1e-5 * float(np.abs(want).max()):
        raise AssertionError("the predictor disagrees with llama_forward")
    if on_card and pred_launches != (L, 0, 0):
        raise AssertionError(f"predictor launches {pred_launches}")
    _check_session_gone("19", session_dir, procs, avail_before, m["pid"],
                        "train worker")
    log(f"[19] {card}: first report {hist[0]['t'] - t_fit:.2f} s after "
        f"fit(); {worker_ms:.1f} ms/step in the worker vs "
        f"{inproc['ms_step']:.1f} in process; checkpoint "
        f"{m['ckpt_bytes']} bytes in {m['save_s']:.2f} s; resumed fit "
        f"{resume_s:.2f} s")
    worker_launches = [sum(h["launches"][i] for h in hist + rm["history"])
                       for i in range(3)]
    return worker_launches, pred_launches[0]


def phase_collective(on_card):
    """Phase 21 (the runtime is up): a ``num_gpus=1`` actor runs
    ``init_collective_group(1, 0, backend="nccl")`` and sends a CUDA tensor
    through allreduce, broadcast, allgather, reducescatter, barrier and
    ``allreduce_sharded`` over a one-rank mesh (``local_mesh()``); each
    result against numpy. The same call in an actor that sees no card
    must raise."""
    import ray_tpu_torch

    class Member:
        def run(self, hide_card):
            import os

            if hide_card:  # before torch loads: this process sees no card
                os.environ["CUDA_VISIBLE_DEVICES"] = ""
            import numpy as np
            import torch

            from ray_tpu_torch.parallel.mesh import local_mesh
            from ray_tpu_torch.util import collective as col

            out = {"cuda": torch.cuda.is_available(), "pid": os.getpid(),
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
            try:
                col.init_collective_group(1, 0, backend="nccl",
                                          group_name="smoke")
            except RuntimeError as e:
                out["raised"] = str(e)
                return out
            dev = torch.device("cuda", torch.cuda.current_device())
            x = torch.arange(8, dtype=torch.float32, device=dev) + 1
            res = {}

            def host(t):
                return (t.device.type, t.cpu().numpy())

            y = x.clone()
            res["allreduce"] = (col.allreduce(y, "smoke") is y, host(y))
            y = x.clone()
            res["broadcast"] = (col.broadcast(y, 0, "smoke") is y, host(y))
            res["allgather"] = [host(t) for t in col.allgather(x, "smoke")]
            shards = [x.clone()]
            res["reducescatter"] = (
                col.reducescatter(shards, "smoke") is shards[0],
                host(shards[0]))
            col.barrier("smoke")
            mesh = local_mesh()
            res["mesh"] = (mesh.mesh_dim_names, tuple(map(int, mesh.shape)),
                           mesh.device_type)
            res["allreduce_sharded"] = host(col.allreduce_sharded(
                x, mesh, "data", "smoke"))
            res["allreduce_sharded_tensor_axis"] = host(
                col.allreduce_sharded(x, mesh, "tensor", "smoke"))
            out["results"] = res
            out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
            col.destroy_collective_group("smoke")
            return out

    t0 = time.perf_counter()
    gpu = ray_tpu_torch.remote(num_gpus=1 if on_card else 0)(Member).remote()
    cpu = ray_tpu_torch.remote(num_gpus=0)(Member).remote()
    got, hidden = ray_tpu_torch.get(
        [gpu.run.remote(False), cpu.run.remote(True)], timeout=300)
    secs = time.perf_counter() - t0
    ray_tpu_torch.kill(gpu)
    ray_tpu_torch.kill(cpu)
    want = np.arange(8, dtype=np.float32) + 1
    log(f"[21] collective group in a num_gpus=1 actor (pid {got['pid']}, "
        f"CUDA_VISIBLE_DEVICES={got['visible']}, NCCL {got.get('nccl')}): "
        f"{got.get('results', got.get('raised'))}; the same call where no "
        f"card is visible (cuda {hidden['cuda']}): "
        f"{hidden.get('raised', 'did not raise')!r}; {secs:.2f} s")
    if not on_card:
        return
    r = got.get("results")
    if r is None:
        raise AssertionError(f"the NCCL group did not form: {got}")
    ok = (all(r[k][0] and r[k][1][0] == "cuda"
              and np.array_equal(r[k][1][1], want)
              for k in ("allreduce", "broadcast", "reducescatter"))
          and len(r["allgather"]) == 1 and r["allgather"][0][0] == "cuda"
          and np.array_equal(r["allgather"][0][1], want)
          and r["allreduce_sharded"][0] == "cuda"
          and np.array_equal(r["allreduce_sharded"][1], want)
          and np.array_equal(r["allreduce_sharded_tensor_axis"][1], want)
          and r["mesh"] == (("data",), (1,), "cuda"))
    if not ok:
        raise AssertionError(f"a collective disagrees with numpy: {r}")
    if hidden["cuda"] or "raised" not in hidden:
        raise AssertionError(f"the NCCL backend did not raise without a "
                             f"card: {hidden}")


def phase_mesh_train(gen, card, inproc):
    """Phase 22 (the runtime is up): ``TorchTrainer.fit()`` with one GPU
    worker whose loop builds ``create_mesh(MeshConfig(data=-1))`` over the
    trainer's NCCL group and runs phase 7's Llama-2-7B LoRA step on it: the
    adapters placed by ``lora_logical_axes``, the frozen bf16 base (seed 0)
    by ``frozen_logical_axes=llama_logical_axes(cfg)``, 3 steps with
    ``attn_impl="flash"``, then 3 from the same state seed with
    ``attn_impl="ring_seq"`` (one diagonal hop at world size 1). Losses and
    grad norms against phase 7's first 3 within TOL_MESH_REL; K1 = 64 and
    K2 = K3 = 32 a step on both; the step's wall (step 2) and device time
    (step 3, profiled) beside phase 7's; the worker's peak memory; the
    placements of a LoRA leaf, a base leaf and an AdamW moment. Returns
    the worker's (K1, K2, K3) launches over both runs."""
    import shutil
    import tempfile

    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchTrainer)

    cfg, lcfg, _ = train_setup(gen)
    on_card = DEVICE == "cuda"

    def loop(config):
        import dataclasses
        import os
        import time

        import torch
        import torch.distributed as dist
        from torch.profiler import ProfilerActivity, profile

        from ray_tpu_torch import resolve_device, train
        from ray_tpu_torch.models.llama import (
            init_llama, init_lora, llama_logical_axes, llama_lora_loss,
            lora_logical_axes)
        from ray_tpu_torch.ops.cuda import _build
        from ray_tpu_torch.ops.cuda import flash_attention as fa
        from ray_tpu_torch.parallel import (
            MeshConfig, adamw, create_mesh, create_train_state,
            make_train_step)

        dev = resolve_device(config["device"])
        on = dev.type == "cuda"
        if on:
            for name in config["kernels"]:
                _build.load(name)
        mesh = create_mesh(MeshConfig(data=-1), device=dev)
        tok = torch.tensor(config["tokens"], device=dev)
        batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
        base_cfg = config["base_cfg"]
        g = torch.Generator(device=dev).manual_seed(0)
        base = init_llama(dataclasses.replace(
            base_cfg, param_dtype=base_cfg.dtype), g, dev)
        lcfg = config["lcfg"]
        info = {"pid": os.getpid(), "backend": dist.get_backend(),
                "mesh": [list(mesh.mesh_dim_names),
                         list(map(int, mesh.shape)), mesh.device_type]}
        if on:
            torch.cuda.reset_peak_memory_stats()
        for impl in ("flash", "ring_seq"):
            cfg = dataclasses.replace(config["cfg"], attn_impl=impl)
            tx = adamw(1e-4)
            state = create_train_state(
                lambda gg: init_lora(cfg, lcfg, gg, gg.device), tx, mesh,
                lora_logical_axes(cfg, lcfg), device=dev, seed=1)
            step = make_train_step(
                lambda lo, b, fz, cfg=cfg: llama_lora_loss(
                    fz, lo, b, cfg, lcfg), tx, mesh,
                batch_logical_axes=("batch", "seq"), frozen=base,
                frozen_logical_axes=llama_logical_axes(cfg))
            hist = []
            for i in range(config["steps"]):
                before = (fa.launches, fa.dq_launches, fa.dkv_launches)
                prof = None
                if on:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == config["steps"] - 1 and on:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        state, m = step(state, batch)
                        torch.cuda.synchronize()
                else:
                    state, m = step(state, batch)
                loss, gnorm = m["loss"].item(), m["grad_norm"].item()
                ms = (time.perf_counter() - t0) * 1e3
                device_ms = None if prof is None else sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / 1e3
                hist.append({"loss": loss, "grad_norm": gnorm, "ms": ms,
                             "device_ms": device_ms, "launches": [
                                 a - b for a, b in zip(
                                     (fa.launches, fa.dq_launches,
                                      fa.dkv_launches), before)]})
            leaf = state.params["layers"]["wq"]["a"]
            info[impl] = {
                "history": hist,
                "placements": {
                    "lora wq.a": str(tuple(leaf.placements)),
                    "base wq": str(tuple(
                        step.frozen["layers"]["wq"].placements)),
                    "adamw exp_avg of wq.a": str(tuple(
                        state.opt_state.state[leaf]["exp_avg"].placements))}}
            del state, step
        info["max_mem"] = torch.cuda.max_memory_allocated() if on else 0
        train.report(info)

    loop_cfg = {"cfg": cfg, "lcfg": lcfg, "base_cfg": gen._cfg,
                "tokens": train_tokens(cfg), "device": DEVICE,
                "kernels": TENSOR_CORE_LIBS, "steps": TRAIN_STEPS}
    storage = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t_fit = time.time()
    try:
        result = TorchTrainer(
            loop, train_loop_config=loop_cfg,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
            run_config=RunConfig(
                name="lora_7b_mesh", storage_path=storage,
                failure_config=FailureConfig(max_failures=0))).fit()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    fit_s = time.time() - t_fit
    if result.error is not None or result.restarts != 0:
        raise AssertionError(f"fit: error {result.error!r}, restarts "
                             f"{result.restarts}")
    m = result.metrics
    L = cfg.num_layers
    per_step = (2 * L, L, L) if on_card else (0, 0, 0)
    want = inproc["metrics"][:TRAIN_STEPS]
    launches = [0, 0, 0]
    for impl in ("flash", "ring_seq"):
        hist = m[impl]["history"]
        errs = [abs(a - b) / abs(b) for h, pair in zip(hist, want)
                for a, b in zip((h["loss"], h["grad_norm"]), pair)]
        log(f"[22] meshed 7B LoRA step, attn_impl={impl}, mesh "
            f"{m['mesh']}, backend {m['backend']}: (loss, grad_norm) "
            f"{[(round(h['loss'], 5), round(h['grad_norm'], 5)) for h in hist]}"
            f" against phase 7's {[(round(a, 5), round(b, 5)) for a, b in want]}"
            f": largest relative difference {max(errs):.3e} (tol "
            f"{TOL_MESH_REL:g}); wall ms per step "
            f"{[round(h['ms'], 1) for h in hist]} (step 1 fills DTensor's "
            f"sharding caches, step {TRAIN_STEPS} is profiled), step 2 "
            f"{hist[1]['ms']:.1f} ms against phase 7's "
            f"{inproc['ms_step']:.1f}; device kernels "
            f"{_ms_or_none(hist[-1]['device_ms'])} ms against phase 9's "
            f"{_ms_or_none(inproc.get('device_ms'))}; launches per "
            f"step {[tuple(h['launches']) for h in hist]}; placements "
            f"{m[impl]['placements']}")
        if len(errs) != 2 * TRAIN_STEPS or max(errs) > TOL_MESH_REL:
            raise AssertionError(f"the meshed {impl} steps disagree with "
                                 f"phase 7's")
        if any(tuple(h["launches"]) != per_step for h in hist):
            raise AssertionError(f"meshed {impl} launches per step != "
                                 f"{per_step}")
        for i in range(3):
            launches[i] += sum(h["launches"][i] for h in hist)
    log(f"[22] {card}: fit {fit_s:.2f} s; worker max memory allocated "
        f"{m['max_mem'] / 2**30:.2f} GiB (phase 19's worker held the same "
        f"step without the mesh)")
    return launches, m


def _ms_or_none(ms):
    return "not measured" if ms is None else f"{ms:.1f}"


def phase_mesh_runtime(gen, card, inproc):
    """Phases 21 and 22 in one session of the port's runtime, then the
    shutdown checks (every process gone, the card's memory back)."""
    import ray_tpu_torch
    from ray_tpu_torch._private import lifecycle

    on_card = DEVICE == "cuda"
    avail_before = _device_available() if on_card else 0
    ray_tpu_torch.init(num_cpus=4, num_gpus=1 if on_card else 0)
    session_dir = ray_tpu_torch._global_node.session_dir
    try:
        phase_collective(on_card)
        launches, m = phase_mesh_train(gen, card, inproc)
    except BaseException:
        _log_tail(session_dir, tag="22")
        raise
    finally:
        procs = lifecycle.list_registered(session_dir)
        ray_tpu_torch.shutdown()
    _check_session_gone("22", session_dir, procs, avail_before, m["pid"],
                        "train worker")
    return launches


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
    return device_ms


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
    launches over the warm-up and timed steps, the params, the (loss, grad
    norm) of the warm-up and timed steps)."""
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
    return dict(launches=launches, params=state.params, metrics=metrics)


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


# phase 23: the MoE step on a world-size-1 (data, expert) mesh against phase
# 16's in-process steps. Every placement is replicated at world size 1, so
# DTensor runs the same kernels on the same local tensors as phase 16 (phase
# 22 saw bit-equal losses for the Llama step): equal up to the order of
# floating-point sums, where DTensor's decomposition or a new cuBLAS
# algorithm choice could differ
TOL_MOE_EP_REL = 1e-5
# phase 24: the GPipe pipeline of 4 Llama-2-7B decoder layers (one a stage),
# 4 microbatches of B=1 x PIPE_S, bf16 activations, fp32 params, adamw(1e-3)
PIPE_STAGES, PIPE_M, PIPE_S, PIPE_STEPS = 4, 4, 2048, 3
PIPE_CFG = dataclasses.replace(LlamaConfig.llama2_7b(),
                               num_layers=PIPE_STAGES, max_seq_len=PIPE_S)
# the pipeline's output and grads against the same 4 layers applied in
# sequence to each microbatch through the same kernels: the same operations
# on the same inputs (bit-equal expected); the grads of the fp32 params sum
# the 4 microbatches' contributions, which autograd may add in another order
# (1e-6 relative in fp32). A wrong stage order or a lost microbatch moves
# entries by their own size
TOL_PIPE_Y_REL, TOL_PIPE_GRAD_REL = 1e-2, 1e-4
# phase 25: PPOLearner on the card (fp32, TF32 off) against the CPU learner
# from the same params and batch: sums in other orders (~1e-6), as the CPU
# tests hold the port to JAX; scalars of cancelling terms against 0.1
TOL_PPO, TOL_PPO_UPDATE = 1e-5, 1e-3


def phase_moe_ep(inproc_metrics):
    """Phase 23: expert parallelism at Mixtral-8x7B width (MOE_CFG: 2
    layers), after phase 16's state is freed: a world-size-1 NCCL group in
    this process (``local_mesh()``), ``create_mesh(MeshConfig(data=-1,
    expert=1))`` over it, the params drawn as phase 16 draws them (seed 0,
    on the card) and placed by ``moe_logical_axes``, the batch by
    ("batch", "seq"); 3 AdamW steps whose (loss, grad norm) must equal phase
    16's first 3 within TOL_MOE_EP_REL. One card runs none of the expert
    collectives: their multi-rank proof is the CPU tests
    (tests/test_torch_moe_ep.py, 4 and 8 gloo ranks). Returns the K1-K3
    launches (0: the MoE's attention is the reference)."""
    import torch.distributed as dist

    from ray_tpu_torch.models.moe import moe_logical_axes
    from ray_tpu_torch.parallel import local_mesh
    from ray_tpu_torch.parallel.mesh import MeshConfig, create_mesh

    cfg = MOE_CFG
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_B, MOE_S + 1))
    tok = torch.from_numpy(tok).to(DEVICE)
    batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    local_mesh(device=DEVICE)
    try:
        mesh = create_mesh(MeshConfig(data=-1, expert=1), device=DEVICE)
        tx = adamw(1e-3)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        state = create_train_state(lambda g: init_moe(cfg, g, g.device), tx,
                                   mesh, moe_logical_axes(cfg), seed=0)
        step = make_train_step(lambda p, b: moe_loss(p, b, cfg), tx, mesh,
                               batch_logical_axes=("batch", "seq"))
        metrics, walls = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = counts()
        placements = {k: [str(p) for p in v.placements]
                      for k, v in state.params["layers"].items()
                      if k in ("we_gate", "router", "wq")}
        max_mem = torch.cuda.max_memory_allocated() / 2**30
        del state, step
    finally:
        dist.destroy_process_group()
    want = inproc_metrics[:3]
    errs = [max(abs(a - c) / abs(c), abs(b - d) / abs(d))
            for (a, b), (c, d) in zip(metrics, want)]
    log(f"[23] MoE on a world-size-1 mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (MoE widths as phase 16, {cfg.num_layers} layers, B={MOE_B} "
        f"S={MOE_S}, adamw(1e-3), moe_logical_axes): (loss, grad_norm) "
        f"{[(round(a, 6), round(b, 6)) for a, b in metrics]} against phase "
        f"16's {[(round(a, 6), round(b, 6)) for a, b in want]}, max "
        f"relative difference {max(errs):.2e} (tol {TOL_MOE_EP_REL:g}); "
        f"wall per step {[round(w, 1) for w in walls]} ms (host clock, "
        f"step 1 with the first DTensor dispatch); placements {placements}; "
        f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}; "
        f"max memory allocated {max_mem:.2f} GiB")
    if not all(np.isfinite(v) for pair in metrics for v in pair) or \
            max(errs) > TOL_MOE_EP_REL:
        raise AssertionError("the MoE step on the mesh disagrees with "
                             "phase 16's")
    if launches != (0, 0, 0):
        raise AssertionError(f"the MoE step launched flash kernels "
                             f"{launches}")
    return launches


def pipeline_setup():
    """The pipeline's 4 stages: 4 Llama-2-7B decoder layers (fp32 params,
    bf16 activations) drawn on the card from seed 3, stacked on the stage
    dim; the stage function (``_layer`` at positions 0..PIPE_S-1); inputs
    [PIPE_M, PIPE_S, hidden] in the activation type and fp32 targets from
    numpy seed 4."""
    from ray_tpu_torch.models.llama import _layer

    cfg = PIPE_CFG
    gen_ = torch.Generator(device=DEVICE).manual_seed(3)
    params = init_llama(cfg, gen_, torch.device(DEVICE))["layers"]
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    positions = torch.arange(PIPE_S, device=DEVICE).expand(1, PIPE_S)

    def stage_fn(p, h):
        return _layer(cfg, h, p, positions)

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(
        (PIPE_M, PIPE_S, cfg.hidden), dtype=np.float32)).to(
        DEVICE, cfg.dtype)
    tgt = torch.from_numpy(rng.standard_normal(
        (PIPE_M, PIPE_S, cfg.hidden), dtype=np.float32)).to(DEVICE)
    return cfg, params, stage_fn, x, tgt


def _pipe_loss(y, t):
    return torch.mean((y.float() - t) ** 2)


def phase_pipeline():
    """Phase 24: ``make_pipeline_train_step`` over 4 stages of Llama-2-7B
    decoder layers, every stage's ticks in this process (no mesh: the card
    holds every stage), 4 microbatches of B=1 x 2048, bf16 activations,
    adamw(1e-3). (a) ``pipeline_apply``'s output and the grads of the loss
    against the 4 layers applied in sequence to each microbatch through the
    same kernels; K1 = 16 a forward (4 stages x 4 microbatches: the idle
    ticks are skipped). (b) 1 + PIPE_STEPS steps: finite losses, K1 = K2 =
    K3 = 16 a step (no remat), ms per step (host clock and CUDA events),
    and one profiled step's device time by kind of kernel. Returns the
    K1-K3 launches of the counted steps."""
    from ray_tpu_torch.parallel.pipeline import (
        gpipe_ticks, make_pipeline_train_step, pipeline_apply)

    cfg, params, stage_fn, x, tgt = pipeline_setup()
    n_params = sum(v.numel() for v in params.values())
    torch.cuda.reset_peak_memory_stats()
    # (a) against the stages in sequence
    reset_counts()
    y = pipeline_apply(stage_fn, params, x, None, num_microbatches=PIPE_M)
    fwd_launches = counts()
    _pipe_loss(y, tgt).backward()
    grads = {k: v.grad.clone() for k, v in params.items()}
    for v in params.values():
        v.grad = None
    ys = []
    for m in range(PIPE_M):
        h = x[m:m + 1]
        for s in range(PIPE_STAGES):
            h = stage_fn({k: v[s] for k, v in params.items()}, h)
        ys.append(h)
    y_seq = torch.cat(ys)
    _pipe_loss(y_seq, tgt).backward()
    y_err = ((y.float() - y_seq.float()).abs().max()
             / y_seq.float().abs().max()).item()
    g_err = max(((grads[k] - v.grad).norm() / v.grad.norm()).item()
                for k, v in params.items())
    for v in params.values():
        v.grad = None
    del y, y_seq, ys, grads
    log(f"[24] pipeline of {PIPE_STAGES} Llama layers (hidden {cfg.hidden}, "
        f"mlp {cfg.mlp_hidden}, {cfg.num_heads} heads of {cfg.head_dim}; "
        f"{n_params / 1e6:.1f} M fp32 params), {PIPE_M} microbatches of B=1 x {PIPE_S}, "
        f"{len(gpipe_ticks(PIPE_STAGES, PIPE_M))} ticks: output against the "
        f"layers in sequence, max|dy| / max|y| {y_err:.3e} (tol "
        f"{TOL_PIPE_Y_REL:g}); grads, largest |dg| / |g| over the leaves "
        f"{g_err:.3e} (tol {TOL_PIPE_GRAD_REL:g}); K1 launches a forward "
        f"{fwd_launches[0]}")
    if not (y_err <= TOL_PIPE_Y_REL and g_err <= TOL_PIPE_GRAD_REL):
        raise AssertionError("the pipeline disagrees with the layers in "
                             "sequence")
    if fwd_launches != (PIPE_STAGES * PIPE_M, 0, 0):
        raise AssertionError(f"pipeline forward launches {fwd_launches}, "
                             f"want ({PIPE_STAGES * PIPE_M}, 0, 0)")
    # (b) the train step
    tx = adamw(1e-3)
    step = make_pipeline_train_step(stage_fn, _pipe_loss, tx, None, params,
                                    num_microbatches=PIPE_M)
    carry = (params, tx(params))
    reset_counts()
    t0 = time.perf_counter()
    carry, m = step(carry, (x, tgt))
    losses = [m["loss"].item()]
    warm_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    timed = []
    for _ in range(PIPE_STEPS):
        carry, m = step(carry, (x, tgt))
        timed.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PIPE_STEPS * 1e3
    event_ms = start.elapsed_time(end) / PIPE_STEPS
    launches = counts()
    losses += [t.item() for t in timed]
    max_mem = torch.cuda.max_memory_allocated() / 2**30
    per_step = tuple(n / (1 + PIPE_STEPS) for n in launches)
    # one more step under the profiler (its launches are not counted)
    kinds, device_ms, kernels, _ = step_profile(
        {"step": step, "state": carry, "batch": (x, tgt)})
    log(f"[24] pipeline train step, adamw(1e-3): losses "
        f"{[round(v, 6) for v in losses]}; first step {warm_s:.2f} s; "
        f"{wall:.1f} ms/step (host clock), {event_ms:.1f} ms/step (CUDA "
        f"events), {PIPE_M * PIPE_S / wall * 1e3:.0f} tokens/s through "
        f"the {PIPE_STAGES} layers; launches a step K1 {per_step[0]:g}, K2 "
        f"{per_step[1]:g}, K3 {per_step[2]:g}; max memory allocated "
        f"{max_mem:.2f} GiB; a profiled step's device time {device_ms:.1f} "
        f"ms (busy {min(device_ms / wall, 1.0):.1%} of the timed wall) in "
        f"{kernels} launches: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in kinds.items()))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite pipeline loss: {losses}")
    want = (PIPE_STAGES * PIPE_M,) * 3
    if per_step != tuple(float(n) for n in want):
        raise AssertionError(f"pipeline launches a step {per_step}, want "
                             f"{want}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the pipeline loss did not fall: {losses}")
    return launches


def phase_ppo():
    """Phase 25: ``PPOLearner`` on the card (fp32, TF32 off) against the
    CPU learner with the same params (the card's, copied) on the same batch:
    the dry run's obs_dim=8, action_dim=4, B=16; the first minibatch's loss
    metrics, one update's metrics and the params after it."""
    from ray_tpu_torch.rllib.core.learner import PPOLearner
    from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec

    spec = RLModuleSpec(obs_dim=8, action_dim=4, discrete=True)
    cfg = {"lr": 3e-4, "num_epochs": 1, "seed": 0}
    rng = np.random.default_rng(0)
    B = 16
    batch = {"obs": rng.normal(size=(B, 8)).astype(np.float32),
             "actions": rng.integers(0, 4, B).astype(np.int32),
             "logp": np.full(B, -1.3, np.float32),
             "advantages": rng.normal(size=B).astype(np.float32),
             "value_targets": rng.normal(size=B).astype(np.float32)}
    card = PPOLearner(spec, dict(cfg), device=DEVICE)
    host = PPOLearner(spec, dict(cfg), device="cpu")
    host.set_weights(card.get_weights())
    first = {}
    for name, lrn in (("card", card), ("cpu", host)):
        m = lrn.compute_grads(lrn._batch(batch))
        first[name] = {k: float(v) for k, v in m.items()}
    w0 = card.get_weights()
    upd = {"card": card.update(batch), "cpu": host.update(batch)}
    errs = {k: abs(first["card"][k] - v) / max(abs(v), 0.1)
            for k, v in first["cpu"].items()}
    errs.update({f"update {k}": abs(upd["card"][k] - v) / max(abs(v), 0.1)
                 for k, v in upd["cpu"].items()})
    # each leaf's distance from the CPU's against the norm of its update
    # (Adam's first step is about lr * sign(g): an entry whose gradient is
    # near 0 can step another way on the two, as in the CPU tests)
    p_err = max(((a - b).norm() / (b - c).norm()).item() for a, b, c in zip(
        tree_leaves(card.get_weights()), tree_leaves(host.get_weights()),
        tree_leaves(w0)))
    log(f"[25] PPOLearner (obs 8, 4 actions, B={B}) on {card.device} "
        f"against the CPU: first minibatch {first['card']} vs "
        f"{first['cpu']}; update {upd['card']} vs {upd['cpu']}; largest "
        f"relative difference {max(errs.values()):.2e} (tol {TOL_PPO:g}); "
        f"params after the update, largest |p_card - p_cpu| / |update| over "
        f"the leaves {p_err:.2e} (tol {TOL_PPO_UPDATE:g})")
    if max(errs.values()) > TOL_PPO or not all(
            np.isfinite(v) for v in upd["card"].values()):
        raise AssertionError("PPOLearner on the card disagrees with the CPU")
    if p_err > TOL_PPO_UPDATE:
        raise AssertionError(f"the params after the update differ by "
                             f"{p_err} of the update")


def phase_dryrun():
    """Phase 26: the port's multichip entry at one rank on the card,
    ``dryrun_multichip(1)``: its tiny-mesh section (a full train step of the
    tiny Llama on a one-rank NCCL mesh in a spawned rank process), then the
    two process gates over gloo on the CPU (4 rank processes each)."""
    from ray_tpu_torch.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    names = [n for n, _ in dryrun_multichip(1, device=DEVICE)["sections"]]
    log(f"[26] dryrun_multichip(1): sections {names} in "
        f"{time.perf_counter() - t0:.1f} s")
    if names != ["tiny-4d-mesh", "two-process-mesh", "two-slice-dcn"]:
        raise AssertionError(f"dryrun_multichip(1) ran {names}")


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
    ring = phase_ring_schedule()
    reset_counts()
    serve_launches, gen, inproc = phase_main_path()
    if counts()[1:] != (0, 0):
        raise AssertionError(f"the serving path ran backward kernels: "
                             f"{counts()}")
    phase_slice_check(gen)
    phase_profile(gen)
    deploy_launches, _ = phase_serve_deployment(gen, inproc)
    train = phase_train(gen)
    phase_grad_check(gen)
    train_device_ms = phase_train_profile(train)
    train_launches = train["launches"]
    inproc_train = {k: train[k] for k in ("metrics", "ms_step")}
    del train  # the LoRA state and its step
    trainer_launches, predictor_launches = phase_train_runtime(
        gen, card, inproc_train)
    mesh_launches = phase_mesh_runtime(
        gen, card, dict(inproc_train, device_ms=train_device_ms))
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
    gc.collect()  # phase 16's params: phase 23 draws them anew
    torch.cuda.empty_cache()
    moe_ep_launches = phase_moe_ep(moe_run["metrics"])
    gc.collect()
    torch.cuda.empty_cache()
    pipe_launches = phase_pipeline()
    gc.collect()
    torch.cuda.empty_cache()
    phase_ppo()
    phase_dryrun()

    # K1 at the serving path's B=4, S=128 (its headline numbers) and at the
    # training paths' B=1 and B=4, S=2048; K2 and K3 at the training shapes
    k1 = {r["key"]: r for r in records}
    k23 = {r["key"]: r for r in bwd}
    head, k1t, tb = k1[SERVE_SHAPE], k1[TRAIN_SHAPE], k23[TRAIN_SHAPE]
    k1_train, k1_dense = train_launches[0], dense["launches"][0]
    ring_launches = ring["launches"]
    hop = k23[RING_HOP_SHAPE]
    timing_keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/ops/cuda/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/pallas/flash_attention.py:110",
        "launches": (serve_launches + deploy_launches + k1_train
                     + trainer_launches[0] + predictor_launches + k1_dense
                     + ring_launches[0] + mesh_launches[0]
                     + pipe_launches[0]),
        "launches_by_path": {"serve": serve_launches,
                             "serve_deployment": deploy_launches,
                             "train": k1_train,
                             "trainer": trainer_launches[0],
                             "predictor": predictor_launches,
                             "dense": k1_dense,
                             "moe": moe_launches[0],
                             "ring_schedule": ring_launches[0],
                             "mesh_train": mesh_launches[0],
                             "moe_expert_mesh": moe_ep_launches[0],
                             "pipeline": pipe_launches[0]},
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
        "ring_hop_shape": {key: k1[RING_HOP_SHAPE][key]
                           for key in timing_keys},
        "ring_schedule": {"ms": ring["ms"], "whole_sequence_ms":
                          ring["whole_ms"], "errs": ring["errs"]},
    }]
    for i, kern, name, line in ((1, "dq", "flash_attention_dq", 275),
                                (2, "dkv", "flash_attention_dkv", 303)):
        r = tb[kern]
        n = (train_launches[i] + trainer_launches[i] + dense["launches"][i]
             + ring_launches[i] + mesh_launches[i] + pipe_launches[i])
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
                                 "trainer": trainer_launches[i],
                                 "dense": dense["launches"][i],
                                 "moe": moe_launches[i],
                                 "ring_schedule": ring_launches[i],
                                 "mesh_train": mesh_launches[i],
                                 "moe_expert_mesh": moe_ep_launches[i],
                                 "pipeline": pipe_launches[i]},
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
            "ring_hop_shape": dict(
                {key: hop[kern][key] for key in timing_keys
                 if key in hop[kern]}, shape=hop["shape"],
                library_ms=hop["library_ms"]),
        })
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
