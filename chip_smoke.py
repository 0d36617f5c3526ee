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
    base leaf and an AdamW moment.
27. (The same session.) ``TorchTrainer(datasets={"train": ds}).fit()``
    with one GPU worker running phase 7's 7B LoRA step (1 + 3 steps), each
    batch from ``get_dataset_shard("train").iter_torch_batches()`` on the
    card; ``ds`` is ``range -> map_batches(tokenize)``, rows as
    ``bench.py``'s ``_tokenize_rows`` makes them. The same step fed the
    same tokens directly in that worker: losses bit-equal, K1 = 64 and K2
    = K3 = 32 a step on both. The shard's first batch again with
    ``sharding=`` a ``NamedSharding`` over the trainer's group: DTensors on
    the card.
28. (The same session.) ``bench.py``'s data-fed dense series in the
    driver: the dense 1B rung (below, phase 10) fed through
    ``streaming_split(1)`` and ``iter_torch_batches``, 1 + 3 steps; the
    first loss bit-equal to phase 10's step on the same tokens; tokens/s,
    MFU and the device's busy share, printed beside phase 10's once it has
    run.
29. (The same session.) ``BatchPredictor.from_checkpoint(<phase 19's
    checkpoint>, ParamsPredictor).predict(ds, num_gpus=1, concurrency=1)``
    over phase 19's 4 prompts: the 7B with the checkpoint's adapters in a
    GPU actor, its logits equal to phase 19's ``ParamsPredictor`` in the
    driver, its K1 launches counted in the actor (32).
40. (The same session.) The compiled DAG over two GPU actor stages of the
    generator's Llama-2-7B (full width and depth, bf16, LoRA off), each
    ``num_gpus=0.5`` and drawing the base from seed 0 in its constructor,
    keeping its half: stage A the embedding and layers 0-15, stage B
    layers 16-31, the final norm and ``lm_head`` (the last position's fp32
    logits, as numpy), then a CPU function node's argmax (numpy: its
    process never imports torch); ``InputNode`` -> A -> B ->
    argmax through ``experimental_compile()``, the residual stream ([4,
    128, 4096] bf16, 4 MiB) crossing a channel between the stages. 8
    executions over phase 19's 4 prompts x 128 tokens, then one
    uncompiled (``dag.execute``): the logits bit-equal to the driver's
    ``llama_forward`` each time, K1 = 16 a call in each stage (counted in
    the stage), the stages two processes apart from the driver on one
    ``CUDA_VISIBLE_DEVICES``, their memory back after the teardown. Then
    ``util.client.serve`` in the driver and ``init(address="ray://...")``:
    a ``num_gpus=1`` task through the client runs ``attention`` at the
    serving shape on seeded inputs, bit-equal to the driver's call, K1 = 1.
    Prints ms an execution compiled and uncompiled, the first execution's
    s, the hop from A to B and the card. Then the session's shutdown
    checks cover phases 21, 22, 27-29 and 40's processes.
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
    process gates over gloo on the CPU; then its ``moe-expert-mesh``
    section (data, expert=4) on 4 gloo ranks on this machine's CPU, which
    holds the MoE to this torch's rule for views of sharded DTensors.
30. Tune over the Train plane (after 26, in a new session of the port's
    runtime, ``init(num_gpus=1)``): phase 7's LoRA step (rank 16 on all
    seven projections, remat "full", ``loss_chunk=256``, B=1, S=2048) at
    Llama-2-7B widths, **depth cut 32 -> 4** (each trial draws its own
    frozen base). ``Tuner(TorchTrainer(loop, ScalingConfig(num_workers=1,
    use_gpu=True)))`` sweeps ``train_loop_config.lr`` over
    ``grid_search([3e-3, 1e-3, 3e-4])`` (the largest first, so that a
    later trial can fall behind an earlier one; 3 trials, not 4, for the
    script's time) with ``ASHAScheduler(max_t=4, grace_period=1,
    reduction_factor=2)``, one trial at a time; each trial's GPU worker loads phase 2's kernels and
    reports loss, grad norm and its K1-K3 launches every step. Every
    trial's steps must be bit-equal to an in-driver replay at its lr, K1 =
    8 and K2 = K3 = 4 a step, and ASHA must stop at least one trial before
    max_t; the best lr is printed.
31. (The same session.) PBT over 2 function trainables that hold
    ``{"CPU": 1, "GPU": 0.5}`` each, so that both share the card at once:
    ``PopulationBasedTraining(perturbation_interval=2,
    hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3, 3e-3]}, seed=0)``, 6
    iterations of one LoRA step and one checkpoint of the state (LoRA
    params, AdamW moments, step) each; the two first trials start stepping
    together (each waits for the other's process). At least one exploit;
    the restored trial's steps bit-equal to an in-driver replay from its
    donor's checkpoint at the mutated lr, the others' to their replays;
    K1-K3 in both actors.
32. (The same session.) RLlib's PPO with the learner on the card
    (``learners()`` at its default device) and 2 CPU env runner actors of
    4 envs each, on ``_CartPole``, gymnasium's CartPole-v1 in numpy (the
    chip machine has no gymnasium; the env class travels to the runners by
    value from ``__main__``): ``PPOConfig().env_runners(num_env_runners=2,
    num_envs_per_env_runner=4, rollout_fragment_length=64).training(
    train_batch_size=512, minibatch_size=128, num_epochs=4)``, 5
    iterations. The learner's params on ``cuda``, no runner with a GPU
    lease or CUDA initialized; iteration 1's training batch replayed on a
    CPU ``PPOLearner`` from the same starting weights within phase 25's
    tolerances; exact env-step counts, finite metrics, a checkpoint loaded
    into a fresh ``PPO`` with equal weights, ``compute_single_action`` in
    {0, 1}; each iteration's wall, the runners' sample s, the learner's
    update ms (CUDA events) and the mean return, logged.
33. (The same session.) APPO (IMPALA's async loop, V-trace, the clipped
    surrogate) with the learner on the card and 2 CPU runners, 4
    fragments a step, 3 steps: the first fragment's update against a CPU
    ``APPOLearner`` from the same weights within phase 25's tolerances,
    ``vtrace`` on that fragment on the card against the CPU (1e-5), 4
    fragments consumed every step. Then the session's shutdown checks
    cover phases 30-35's workers and actors. Neither phase launches
    K1-K3: RLlib's modules are MLPs.
34. (The same session.) RLlib's DQN (double Q, dueling, prioritized
    replay) with the learner on the card and 2 CPU env runners of 4
    ``_CartPole`` each, 16 steps a fragment, batch 64, 2 updates an
    iteration once 256 valid steps are stored, a hard target sync every 256
    steps, 5 iterations: the first update's replay batch replayed on a CPU
    ``DQNLearner`` from the same weights and target net within phase 25's
    tolerances (and its td errors within 1e-5); every target sync leaves
    the target net equal to the online one; a checkpoint loaded into a
    fresh ``DQN`` restores the weights and the target net;
    ``compute_single_action`` in {0, 1}; no runner with a GPU lease or CUDA
    initialized.
35. (The same session.) SAC (twin Q, auto-tuned alpha, polyak targets,
    (256, 256) towers) with the learner on the card and 2 CPU env runners
    of 4 ``_Pendulum`` each (gymnasium's Pendulum-v1 in numpy), batch 128,
    4 iterations: the first update replayed on a CPU ``SACLearner`` from
    the same weights and target critics with the card's random draws,
    within phase 25's tolerances; then on a batch of 256 from SAC's replay
    buffer, two TD3 updates (the second steps the delayed actor) and one
    CQL update on the card against the CPU with the same draws. Each
    iteration's wall, the learner's update ms (CUDA events) and the phase's
    seconds are logged; K1-K3 are counted at 0 around phases 34-35.
36. (The same session.) DreamerV3 at the reference's defaults (deter 128,
    8 x 8 latents, hidden 128, horizon 10, batch 8 x 16, train_ratio 64)
    with the learner on the card and 1 CPU env runner of 4 numpy
    ``_Chain``s (the reference tests' corridor), 16 steps a fragment, 3
    iterations (32 updates in each of the last two): every update timed
    with CUDA events (median, min, max), one profiled for its kernel
    launches and device time; the first update replayed on a CPU
    ``DreamerLearner`` from the card's state with its batch and Gumbel
    draws (metrics within 1e-4, params and slow critic within phase 25's
    update tolerance); the return scale, the slow critic and a checkpoint
    round trip checked.
37. (The same session.) QMIX on a numpy CoordGame and MADDPG on a numpy
    CoopTarget, their state on the card, collecting in the driver until
    learning starts; AlphaZero (50 simulations) with its learner on the
    card and 2 CPU self-play workers, 1 iteration. Each family's first
    update replayed on a CPU twin from the same state and batch within
    phase 25's tolerances; update ms by CUDA events.
38. (The same session.) LinUCB and LinTS with ``A`` and ``b`` on the card,
    2 iterations of 64 pulls, against CPU twins fed the same contexts and
    draws (the same arms; ``A``, ``b`` within 1e-5); ES and ARS at the
    reference's population (32 candidates of 48 steps x 2 envs, the
    reference test's fragment), one iteration each on 2 CPU runners
    (nothing of theirs runs on the card: no allocation on it while they
    run).
    K1-K3 are counted at 0 around phases 36-38; each phase's seconds are
    logged on a line of its own.
39. (After 38, in a session of its own.) The Train plane's failover path
    on a two-node ``cluster_utils.Cluster`` in this host: a head with 2
    CPUs and no GPU, a second node with 2 CPUs and the GPU; the head must
    advertise 0 GPUs and the second node 1. Two ``{"GPU": 0.5}`` actors in
    one ``{"GPU": 1}`` placement-group bundle land on the second node, see
    one card as ``CUDA_VISIBLE_DEVICES`` and read back a tensor on
    ``cuda:0``. Then ``TorchTrainer(ScalingConfig(num_workers=1,
    use_gpu=True))``, whose worker must be on the second node, runs phase
    7's LoRA step at Llama-2-7B widths, **depth cut 32 -> 4**, on
    ``MeshConfig(data=-1)`` with ``attn_impl="flash"``: 4 steps, the
    trainable state (LoRA leaves, AdamW moments, step; not the frozen base)
    saved after step 2 with ``save_pytree_orbax``, and while steps 3-4 run
    the driver captures a ``torch.profiler`` trace of the worker through
    ``util.state.capture_torch_trace``, which must hold K1, K2 and K3
    (``flash_fwd_kernel_tc``, ``flash_dq_kernel_tc``,
    ``flash_dkv_kernel_tc``). A second fit resumes from the checkpoint with
    ``load_pytree_orbax`` and runs steps 3-4, whose losses and grad norms
    must equal the first fit's within 1e-3 relative; K1 = 8 and K2 = K3 = 4
    a step in both fits. The second node is removed, the cluster shut down,
    and the session must be gone and the card's memory back. Prints the
    checkpoint's bytes, save and load seconds, each fit's first report and
    the phase's seconds.

It prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside it, it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import threading
import time
import types

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
from ray_tpu_torch.rllib.env.multi_agent_env import MultiAgentEnv
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


def _check_session_gone(tag, session_dir, procs, avail_before, workers):
    """After ``ray_tpu_torch.shutdown()``: every process the session
    registered (``procs``, read before the shutdown) and every worker of
    ``workers`` ({role: pid}) are gone, the card gives back what it gave
    before ``init`` (within 512 MiB) and the session's directory is
    removed."""
    from ray_tpu_torch._private import lifecycle

    def alive():
        return [f"{r['role']}:{r['pid']}" for r in procs
                if lifecycle._pid_alive(r["pid"], r.get("create_time"))] + [
            f"{role}:{pid}" for role, pid in workers.items()
            if lifecycle._pid_alive(pid)]

    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and alive():
        time.sleep(0.2)
    on_card = DEVICE == "cuda"
    avail_after = _device_available() if on_card else 0
    left = [s for s in lifecycle.list_sessions()
            if os.path.normpath(s["path"]) == os.path.normpath(session_dir)]
    log(f"[{tag}] after shutdown: {len(procs)} processes of the session "
        f"and {workers}, alive {alive()}; the card gives "
        f"{(avail_before - avail_after) / 2**20:.0f} MiB less than before "
        f"init; sessions left {[s['path'] for s in left]}")
    if alive():
        raise AssertionError(f"{alive()} outlived the shutdown")
    if on_card and avail_before - avail_after > 512 * 2**20:
        raise AssertionError(f"the memory of {sorted(workers)} did not come "
                             f"back")
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
                        {"replica": pr["pid"]})
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
    over both fits, the predictor's K1 launches, and for phase 29 a copy of
    the checkpoint (a directory the caller removes), the prompts and the
    predictor's outputs."""
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
        # phase 29 maps the same checkpoint over a Dataset in an actor
        kept = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        shutil.copytree(result.checkpoint.path, kept, dirs_exist_ok=True)
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
    _check_session_gone("19", session_dir, procs, avail_before,
                        {"train worker": m["pid"]})
    log(f"[19] {card}: first report {hist[0]['t'] - t_fit:.2f} s after "
        f"fit(); {worker_ms:.1f} ms/step in the worker vs "
        f"{inproc['ms_step']:.1f} in process; checkpoint "
        f"{m['ckpt_bytes']} bytes in {m['save_s']:.2f} s; resumed fit "
        f"{resume_s:.2f} s")
    worker_launches = [sum(h["launches"][i] for h in hist + rm["history"])
                       for i in range(3)]
    return worker_launches, pred_launches[0], {
        "checkpoint": kept, "prompts": prompts, "predictions": got}


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


def _tokenizer(seq, vocab):
    """``bench.py``'s ``_tokenize_rows`` (bench.py:133-141) as a map_batches
    function over a ``range`` block: row id -> seq + 1 tokens, as inputs
    [:, :-1] and targets [:, 1:]. Made here, so that it travels to the
    workers by value (it needs numpy only)."""

    def tokenize(tbl):
        import numpy as np

        ids = np.asarray(tbl["id"], dtype=np.int64).reshape(-1, 1)
        pos = np.arange(seq + 1, dtype=np.int64)[None, :]
        tok = ((ids * 1000003 + pos * 7919 + 17) % vocab).astype(np.int32)
        return {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
    return tokenize


def _token_dataset(n_rows, batch, seq, vocab):
    """``range(n_rows) -> map_batches(tokenize)`` in blocks of ``batch``
    rows, and the same tokens computed here."""
    from ray_tpu_torch import data as rdata

    tokenize = _tokenizer(seq, vocab)
    ds = rdata.range(n_rows, parallelism=2).map_batches(
        tokenize, batch_size=batch)
    return ds, tokenize({"id": np.arange(n_rows)})


def phase_train_data(gen, card):
    """Phase 27 (the runtime is up): ``TorchTrainer(datasets={"train":
    ds}).fit()`` with one GPU worker running phase 7's 7B LoRA step (B=1,
    S=2048, 1 + 3 steps), each batch from ``get_dataset_shard("train")
    .iter_torch_batches()`` on the card; ``ds`` is ``range -> map_batches
    (tokenize)``, rows as ``bench.py``'s ``_tokenize_rows`` makes them.
    Then, in the same worker, the same step from the same seed fed the same
    tokens directly: the batches equal and the losses and grad norms bit-
    equal, K1 = 64 and K2 = K3 = 32 a step on both. Last, the shard's first
    batch again with ``sharding=`` a ``NamedSharding`` on a mesh over the
    trainer's group: DTensors on the card equal to those tokens. Returns
    the fed run's (K1, K2, K3) launches and the worker's pid."""
    import shutil
    import tempfile

    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchTrainer)

    cfg, lcfg, _ = train_setup(gen)
    on_card = DEVICE == "cuda"
    n_steps = 1 + TRAIN_STEPS
    ds, want_tok = _token_dataset(TRAIN_B * n_steps, TRAIN_B, TRAIN_S,
                                  cfg.vocab_size)

    def loop(config):
        import dataclasses
        import os
        import time

        import torch

        from ray_tpu_torch import resolve_device, train
        from ray_tpu_torch.models.llama import (
            init_llama, init_lora, llama_lora_loss)
        from ray_tpu_torch.ops.cuda import _build
        from ray_tpu_torch.ops.cuda import flash_attention as fa
        from ray_tpu_torch.parallel import (
            MeshConfig, adamw, create_mesh, create_train_state,
            make_train_step)
        from ray_tpu_torch.parallel.sharding import (
            NamedSharding, logical_to_spec)

        dev = resolve_device(config["device"])
        if dev.type == "cuda":
            for name in config["kernels"]:
                _build.load(name)
        cfg, lcfg, B = config["cfg"], config["lcfg"], config["batch"]
        base_cfg = config["base_cfg"]
        base = init_llama(dataclasses.replace(
            base_cfg, param_dtype=base_cfg.dtype),
            torch.Generator(device=dev).manual_seed(0), dev)

        def run(batches):
            tx = adamw(1e-4)
            state = create_train_state(
                lambda g: init_lora(cfg, lcfg, g, g.device), tx,
                device=dev, seed=1)
            step = make_train_step(
                lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg), tx,
                frozen=base)
            hist, seen = [], []
            for batch in batches:
                seen.append({k: v.cpu().numpy() for k, v in batch.items()})
                before = (fa.launches, fa.dq_launches, fa.dkv_launches)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                loss, gnorm = m["loss"].item(), m["grad_norm"].item()
                hist.append({"loss": loss, "grad_norm": gnorm,
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "launches": [a - b for a, b in zip(
                                 (fa.launches, fa.dq_launches,
                                  fa.dkv_launches), before)]})
                if len(hist) == config["steps"]:
                    break
            return hist, seen

        shard = train.get_dataset_shard("train")
        fed, seen = run(shard.iter_torch_batches(
            batch_size=B, device=dev, prefetch_batches=2,
            dtypes={"inputs": torch.long, "targets": torch.long}))
        tok = {k: torch.from_numpy(v).long().to(dev)
               for k, v in config["tokens"].items()}
        direct, _ = run({k: v[i:i + B] for k, v in tok.items()}
                        for i in range(0, B * config["steps"], B))
        # the shard again (a new pass over the dataset), its first batch as
        # DTensors on a mesh over the trainer's group
        mesh = create_mesh(MeshConfig(data=-1), device=dev)
        placed = next(iter(shard.iter_torch_batches(
            batch_size=B, prefetch_batches=2, sharding=NamedSharding(
                mesh, logical_to_spec(("batch", "seq"))),
            dtypes={"inputs": torch.long, "targets": torch.long})))
        sharded = {k: {"type": type(v).__name__,
                       "placements": [repr(p) for p in v.placements],
                       "device": str(v.to_local().device),
                       "equal": bool(torch.equal(v.full_tensor(),
                                                 tok[k][:B]))}
                   for k, v in placed.items()}
        train.report({"pid": os.getpid(), "fed": fed, "direct": direct,
                      "batches": seen, "sharded": sharded,
                      "device": str(next(iter(base.values())).device)})

    loop_cfg = {"cfg": cfg, "lcfg": lcfg, "base_cfg": gen._cfg,
                "tokens": want_tok, "batch": TRAIN_B, "device": DEVICE,
                "kernels": TENSOR_CORE_LIBS, "steps": n_steps}
    storage = tempfile.mkdtemp(prefix="chip_smoke_data_")
    t_fit = time.time()
    try:
        result = TorchTrainer(
            loop, train_loop_config=loop_cfg,
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
            run_config=RunConfig(
                name="lora_7b_data", storage_path=storage,
                failure_config=FailureConfig(max_failures=0)),
            datasets={"train": ds}).fit()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    fit_s = time.time() - t_fit
    if result.error is not None or result.restarts != 0:
        raise AssertionError(f"fit: error {result.error!r}, restarts "
                             f"{result.restarts}")
    m = result.metrics
    fed, direct = m["fed"], m["direct"]
    L = cfg.num_layers
    per_step = (2 * L, L, L) if on_card else (0, 0, 0)
    pairs = [(h["loss"], h["grad_norm"]) for h in fed]
    log(f"[27] TorchTrainer(datasets=) 7B LoRA step B={TRAIN_B} "
        f"S={TRAIN_S}, worker pid {m['pid']} on {m['device']}: fed from "
        f"get_dataset_shard (loss, grad_norm) "
        f"{[(round(a, 5), round(b, 5)) for a, b in pairs]}, ms "
        f"{[round(h['ms'], 1) for h in fed]}; fed directly "
        f"{[(round(h['loss'], 5), round(h['grad_norm'], 5)) for h in direct]}"
        f", ms {[round(h['ms'], 1) for h in direct]}; launches per step "
        f"{[tuple(h['launches']) for h in fed]} fed, "
        f"{[tuple(h['launches']) for h in direct]} direct; fit {fit_s:.2f} "
        f"s; the shard's first batch with sharding= {m['sharded']}")
    if any(v["type"] != "DTensor" or not v["equal"]
           or not v["device"].startswith(DEVICE)
           for v in m["sharded"].values()):
        raise AssertionError("iter_torch_batches(sharding=) in the worker: "
                             f"{m['sharded']}")
    if len(m["batches"]) != n_steps or not all(
            np.array_equal(b[k], want_tok[k][i * TRAIN_B:(i + 1) * TRAIN_B])
            for i, b in enumerate(m["batches"]) for k in want_tok):
        raise AssertionError("the worker's dataset shard gave other tokens "
                             "than bench.py's tokenizer")
    if pairs != [(h["loss"], h["grad_norm"]) for h in direct] or \
            len(pairs) != n_steps:
        raise AssertionError("the data-fed steps are not bit-equal to the "
                             "directly fed ones")
    if not all(np.isfinite(v) for pair in pairs for v in pair):
        raise AssertionError(f"non-finite loss or grad norm: {pairs}")
    if any(tuple(h["launches"]) != per_step for h in fed + direct):
        raise AssertionError(f"launches per step != {per_step}")
    log(f"[27] {card}: fit {fit_s:.2f} s; {len(fed)} data-fed steps "
        f"bit-equal to the directly fed ones")
    return [sum(h["launches"][i] for h in fed) for i in range(3)], m["pid"]


def phase_dense_data(card):
    """Phase 28 (the runtime is up): ``bench.py``'s data-fed series
    (bench.py:144-207) at the dense 1B rung in the driver: ``range ->
    map_batches(tokenize) -> streaming_split(1)``, batches through
    ``iter_torch_batches`` (prefetch 2) to the card, phase 10's step
    (``adafactor(1e-3)``, remat "dots", params from seed 0), B=4, S=2048,
    one warm-up and DENSE_STEPS timed steps under torch.profiler (the
    device's busy share of the window). Then phase 10's step from a fresh
    state fed the first batch's tokens directly: its loss bit-equal to the
    data-fed first loss. Returns the timed steps' (K1, K2, K3) launches,
    tokens/s, MFU and the busy share."""
    cfg = DENSE_CFG
    n_rows = DENSE_B * (DENSE_STEPS + 2)  # as bench.py's total_rows
    ds, want_tok = _token_dataset(n_rows, DENSE_B, DENSE_S, cfg.vocab_size)
    it = ds.streaming_split(1)[0]

    def new_step():
        tx = adafactor(1e-3)
        state = create_train_state(lambda g: init_llama(cfg, g, g.device),
                                   tx, device=DEVICE, seed=0)
        return state, make_train_step(lambda p, b: llama_loss(p, b, cfg), tx)

    t0 = time.perf_counter()
    state, step = new_step()
    batches = it.iter_torch_batches(
        batch_size=DENSE_B, device=DEVICE, prefetch_batches=2,
        dtypes={"inputs": torch.long, "targets": torch.long})
    first = next(batches)
    state, m = step(state, first)
    first_loss = m["loss"].item()
    warm_s = time.perf_counter() - t0
    reset_counts()
    metrics = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, m = step(state, batch)
            metrics.append((m["loss"], m["grad_norm"]))
            if len(metrics) == DENSE_STEPS:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counts()
    device_ms = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)) / 1e3
    metrics = [(a.item(), b.item()) for a, b in metrics]
    del state, step, batches, first
    gc.collect()
    # phase 10's step on the first batch's tokens, fed directly
    state, step = new_step()
    tok = {k: torch.from_numpy(v[:DENSE_B]).long().to(DEVICE)
           for k, v in want_tok.items()}
    _, m = step(state, tok)
    direct_loss = m["loss"].item()
    del state, step
    gc.collect()
    L = cfg.num_layers
    want = ((2 * L * DENSE_STEPS, L * DENSE_STEPS, L * DENSE_STEPS)
            if DEVICE == "cuda" else (0, 0, 0))
    tok_s = DENSE_B * DENSE_S * len(metrics) / wall
    mfu = tok_s * cfg.flops_per_token(DENSE_S) / PEAK_FLOPS["bfloat16"]
    busy = device_ms / (wall * 1e3)
    log(f"[28] data-fed dense 1B B={DENSE_B} S={DENSE_S} through "
        f"streaming_split(1) and iter_torch_batches: warm-up {warm_s:.1f} s "
        f"(init, first batch, first step), first loss {first_loss!r} vs "
        f"{direct_loss!r} fed directly; (loss, grad_norm) per timed step "
        f"{[(round(a, 5), round(b, 5)) for a, b in metrics]}; "
        f"{wall / len(metrics) * 1e3:.1f} ms/step, {tok_s:.0f} tokens/s, "
        f"MFU {mfu:.1%}, device kernels {device_ms:.1f} ms in "
        f"{wall * 1e3:.1f} ms of wall (busy {busy:.1%}); launches K1 "
        f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]} over "
        f"{len(metrics)} steps; {card}")
    if first_loss != direct_loss:
        raise AssertionError("the data-fed first loss differs from phase "
                             "10's step on the same tokens")
    if len(metrics) != DENSE_STEPS or not all(
            np.isfinite(v) for pair in metrics for v in pair):
        raise AssertionError(f"data-fed steps: {metrics}")
    if launches != want:
        raise AssertionError(f"data-fed launches {launches} != {want}")
    return dict(launches=launches, tok_s=tok_s, mfu=mfu, busy=busy)


def phase_batch_predict(gen, card, phase19):
    """Phase 29 (the runtime is up): ``BatchPredictor.from_checkpoint(
    <phase 19's checkpoint>, ParamsPredictor).predict(ds, num_gpus=1,
    concurrency=1)`` over a Dataset of phase 19's 4 prompts of 128 tokens:
    the 7B base (seed 0, as ``LlamaGenerator`` draws it, made in the actor
    at its first batch) with the checkpoint's adapters, in a GPU actor of
    the pool. The logits equal ``ParamsPredictor``'s in the driver (phase
    19), and the actor counts its own K1 launches (32 a call). Returns the
    actor's K1 launches and its pid."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.train import BatchPredictor, Checkpoint, ParamsPredictor

    on_card = DEVICE == "cuda"
    fwd_cfg, lcfg = gen._cfg, LoraConfig(rank=16)
    prompts = phase19["prompts"]

    class CountingPredictor(ParamsPredictor):
        """``ParamsPredictor``, its K1 launches and process id added as
        columns."""

        def predict(self, batch):
            import os

            from ray_tpu_torch.ops.cuda import flash_attention as fa

            before = fa.launches
            out = super().predict(batch)
            n = len(batch[self.feature_column])
            out["k1_launches"] = np.full(n, fa.launches - before)
            out["pid"] = np.full(n, os.getpid())
            return out

    def apply(lo, x, _base={}):
        import dataclasses

        import torch

        from ray_tpu_torch.models.llama import init_llama, llama_forward

        if "params" not in _base:  # the base as LlamaGenerator draws it
            _base["params"] = init_llama(dataclasses.replace(
                fwd_cfg, param_dtype=fwd_cfg.dtype),
                torch.Generator(device=x.device).manual_seed(0), x.device)
        return llama_forward(_base["params"], x, fwd_cfg, lora=lo,
                             lora_cfg=lcfg)

    ds = rdata.from_numpy(prompts, column="features")
    t0 = time.perf_counter()
    rows = BatchPredictor.from_checkpoint(
        Checkpoint(phase19["checkpoint"]), CountingPredictor, name="state",
        apply_fn=apply, device=DEVICE).predict(
        ds, batch_size=len(prompts), concurrency=1,
        num_gpus=1 if on_card else None).take_all()
    secs = time.perf_counter() - t0
    got = np.stack([r["predictions"] for r in rows])
    want = phase19["predictions"]
    launches = {int(r["k1_launches"]) for r in rows}
    pids = {int(r["pid"]) for r in rows}
    L = fwd_cfg.num_layers
    log(f"[29] BatchPredictor over {len(prompts)} prompts x "
        f"{prompts.shape[1]} tokens in a GPU actor (pid {sorted(pids)}, "
        f"driver {os.getpid()}): logits {got.shape}, max|actor - driver's "
        f"ParamsPredictor| {float(np.abs(got - want).max()):.3e}; K1 "
        f"launches in the actor {sorted(launches)} = {L} x 1 call; "
        f"{secs:.2f} s from predict() to the rows (the actor's start, the "
        f"base's init, the checkpoint's read); {card}")
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("the batch predictor's logits differ from "
                             "ParamsPredictor's in the driver")
    if not np.array_equal(np.stack([r["features"] for r in rows]), prompts):
        raise AssertionError("the rows came back in another order")
    if len(pids) != 1 or os.getpid() in pids:
        raise AssertionError(f"predicted in processes {pids}")
    if launches != ({L} if on_card else {0}):
        raise AssertionError(f"actor K1 launches {launches} != {L}")
    return L if on_card else 0, pids.pop()


DAG_SPLIT = 16        # phase 40: stage A holds the embedding and layers
#                       [0, 16), stage B layers [16, 32), the norm and head
DAG_EXECS = 8         # phase 40: the compiled graph's executions
CLIENT_SEED = 40      # phase 40: the client task's attention inputs


def _dag_stage_class():
    """Phase 40's stage of the Llama, a class made here so that it travels
    to its actors by value."""

    class LlamaStage:
        """Layers [lo, hi) of the Llama, with the embedding when lo is 0
        and the final norm and ``lm_head`` when hi is the last layer. The
        whole base is drawn on the device from seed 0 as ``LlamaGenerator``
        draws it, in the constructor (the first execution must not wait on
        it), and only this stage's part is kept. ``forward`` runs the
        layers as ``llama_hidden`` does (``_layer`` per layer, no LoRA) and
        returns the residual stream (on the device; its channel brings it
        to the host), or the last position's fp32 logits of
        ``llama_forward``'s product as a numpy array. Each call logs its
        host times: entry, input on the device, output ready."""

        def __init__(self, cfg, lo, hi, device):
            import dataclasses

            import torch

            from ray_tpu_torch.models.llama import init_llama
            from ray_tpu_torch.ops.cuda import flash_attention as fa

            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("a GPU stage sees no card")
            self.cfg = cfg
            params = init_llama(
                dataclasses.replace(cfg, param_dtype=cfg.dtype),
                torch.Generator(device=self.device).manual_seed(0),
                self.device)
            stacked = params.pop("layers")
            kept = {}
            for name in list(stacked):  # one leaf at a time: a low peak
                kept[name] = stacked.pop(name)[lo:hi].clone()
            self.layers = [{name: w[i] for name, w in kept.items()}
                           for i in range(hi - lo)]
            self.embed = params["embed"] if lo == 0 else None
            last = hi == cfg.num_layers
            self.final_norm = params["final_norm"] if last else None
            self.lm_head = params["lm_head"] if last else None
            del params, stacked
            self._sync()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            self.k1_at_start = fa.launches
            self.times = []

        def _sync(self):
            import torch

            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def info(self):
            import os

            import torch

            return {"pid": os.getpid(),
                    "cuda_visible_devices": os.environ.get(
                        "CUDA_VISIBLE_DEVICES"),
                    "allocated": (torch.cuda.memory_allocated(self.device)
                                  if self.device.type == "cuda" else 0)}

        def forward(self, x):
            import time

            import numpy as np
            import torch
            import torch.nn.functional as F

            from ray_tpu_torch.models.llama import _layer, _proj, _rms_norm

            cfg = self.cfg
            t_in = time.time()
            with torch.no_grad():
                if self.embed is not None:  # the token ids, [B, S]
                    tokens = torch.from_numpy(np.array(x)).to(self.device)
                    h = F.embedding(tokens, self.embed).to(cfg.dtype)
                else:  # the residual stream, on the host after its channel
                    h = x.to(self.device)
                self._sync()
                t_dev = time.time()
                B, S = h.shape[:2]
                positions = torch.arange(S, device=self.device).expand(B, S)
                for lp in self.layers:
                    h = _layer(cfg, h, lp, positions, {}, 0.0)
                if self.lm_head is not None:
                    h = _rms_norm(h, self.final_norm, cfg.rms_eps)
                    logits = _proj("bsh,hv->bsv", h,
                                   self.lm_head.to(cfg.dtype)).float()
                    # numpy: the CPU node that reads it needs no torch
                    h = logits[:, -1].cpu().numpy()
                self._sync()
            self.times.append((t_in, t_dev, time.time()))
            return h

        def k1_launches(self):
            from ray_tpu_torch.ops.cuda import flash_attention as fa

            return fa.launches - self.k1_at_start

        def call_times(self):
            return list(self.times)

    return LlamaStage


def phase_compiled_dag(gen, card, prompts):
    """Phase 40a (the runtime is up): a compiled DAG of two GPU actor
    stages of the generator's model at full width and depth, LoRA off.
    Stage A (``num_gpus=0.5``) holds the embedding and layers 0-15, stage B
    (``num_gpus=0.5``) layers 16-31, the final norm and ``lm_head``; a CPU
    function node takes the argmax. ``InputNode`` -> A -> B -> argmax, with
    B's logits and the argmax both read by the driver
    (``MultiOutputNode``), is compiled with ``experimental_compile()``: the
    residual stream, [4, 128, 4096] bf16, crosses a channel between the
    stages. ``DAG_EXECS`` executions over ``prompts``, then the same graph
    once uncompiled (``dag.execute``). The logits must be bit-equal to the
    driver's ``llama_forward`` on the generator's base each time, the
    argmax their argmax, each stage's K1 launches ``DAG_SPLIT`` a call, the
    stages two processes apart from the driver on one
    ``CUDA_VISIBLE_DEVICES``, and the card's memory back after the DAG's
    teardown and the stages' end. Returns both stages' K1 launches and
    their pids."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import InputNode, MultiOutputNode

    on_card = DEVICE == "cuda"
    cfg = gen._cfg
    L = cfg.num_layers
    with torch.no_grad():
        want = llama_forward(gen._params,
                             torch.from_numpy(prompts).to(DEVICE),
                             cfg)[:, -1].cpu().numpy()
    want_ids = want.argmax(-1)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    avail_before = _device_available() if on_card else 0

    Stage = ray_tpu_torch.remote(_dag_stage_class())
    if on_card:
        Stage = Stage.options(num_gpus=0.5)

    @ray_tpu_torch.remote
    def argmax(logits):
        return logits.argmax(-1)  # numpy: this stage never imports torch

    t0 = time.perf_counter()
    a = Stage.remote(cfg, 0, DAG_SPLIT, DEVICE)
    b = Stage.remote(cfg, DAG_SPLIT, L, DEVICE)
    infos = ray_tpu_torch.get([a.info.remote(), b.info.remote()], timeout=600)
    build_s = time.perf_counter() - t0
    pids = [i["pid"] for i in infos]
    cvds = [i["cuda_visible_devices"] for i in infos]
    with InputNode() as inp:
        logits = b.forward.bind(a.forward.bind(inp))
        dag = MultiOutputNode([logits, argmax.bind(logits)])

    def check(tag, out):
        got, ids = out
        if got.shape != want.shape or not np.array_equal(got, want):
            err = (float(np.abs(got - want).max())
                   if got.shape == want.shape else None)
            raise AssertionError(f"{tag}: the DAG's logits differ from the "
                                 f"driver's llama_forward (max|d| {err})")
        if not np.array_equal(ids, want_ids):
            raise AssertionError(f"{tag}: argmax {ids} != {want_ids}")

    compiled = dag.experimental_compile()
    try:
        ms, submits = [], []
        for i in range(DAG_EXECS):
            t = time.perf_counter()
            submits.append(time.time())
            out = compiled.execute(prompts).get(timeout=600)
            ms.append((time.perf_counter() - t) * 1e3)
            check(f"compiled execution {i}", out)
    finally:
        compiled.teardown()
    compiled_launches = ray_tpu_torch.get(
        [a.k1_launches.remote(), b.k1_launches.remote()], timeout=120)
    t = time.perf_counter()
    submits.append(time.time())
    out = ray_tpu_torch.get(dag.execute(prompts), timeout=600)
    eager_ms = (time.perf_counter() - t) * 1e3
    check("uncompiled execution", out)
    launches = ray_tpu_torch.get(
        [a.k1_launches.remote(), b.k1_launches.remote()], timeout=120)
    times_a, times_b = ray_tpu_torch.get(
        [a.call_times.remote(), b.call_times.remote()], timeout=120)
    infos = ray_tpu_torch.get([a.info.remote(), b.info.remote()], timeout=120)
    ray_tpu_torch.kill(a)
    ray_tpu_torch.kill(b)
    # the hop: A's output ready -> B's entry (A's serialization to the host,
    # the channel's slot, B's read); then B's copy to its card
    hops = [(tb[0] - ta[2]) * 1e3 for ta, tb in zip(times_a, times_b)]
    h2d = [(tb[1] - tb[0]) * 1e3 for tb in times_b]
    stage_ms = [[(t[2] - t[1]) * 1e3 for t in ts] for ts in (times_a,
                                                              times_b)]

    def split(i):
        """Execution i's host times from its submission: A's entry, B's
        output ready (the rest is B -> argmax -> the driver)."""
        return (f"A entered +{(times_a[i][0] - submits[i]) * 1e3:.1f} ms, "
                f"B done +{(times_b[i][2] - submits[i]) * 1e3:.1f} ms")

    avail_after = avail_before
    if on_card:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            avail_after = _device_available()
            if avail_before - avail_after <= 512 * 2**20:
                break
            time.sleep(0.5)
    med = statistics.median
    log(f"[40] compiled DAG, InputNode -> A (embedding, layers 0-"
        f"{DAG_SPLIT - 1}) -> B (layers {DAG_SPLIT}-{L - 1}, norm, lm_head) "
        f"-> argmax, {len(prompts)} prompts x {prompts.shape[1]} tokens, "
        f"{str(cfg.dtype).removeprefix('torch.')}, LoRA off: stages in pids "
        f"{pids} (driver {os.getpid()}), CUDA_VISIBLE_DEVICES {cvds}, "
        f"{[i['allocated'] / 2**30 for i in infos]} GiB allocated, "
        f"{build_s:.2f} s to draw both halves; first execution "
        f"{ms[0] / 1e3:.3f} s ({split(0)}), then {med(ms[1:]):.2f} ms an "
        f"execution (min {min(ms[1:]):.2f}, max {max(ms[1:]):.2f}) "
        f"compiled, {eager_ms:.2f} ms uncompiled ({split(-1)}); stage A "
        f"{med(stage_ms[0]):.2f} ms, stage B {med(stage_ms[1]):.2f} ms a "
        f"call (host wall, synced), "
        f"hop A -> B {med(hops):.2f} ms (min {min(hops):.2f}), B's copy to "
        f"the card {med(h2d):.2f} ms (medians over {len(hops)} calls); K1 "
        f"launches by stage {compiled_launches} after the compiled "
        f"executions, {launches} after the uncompiled one; logits bit-equal "
        f"to the driver's llama_forward; the card gives "
        f"{(avail_before - avail_after) / 2**20:.0f} MiB less after the "
        f"stages' end than before; {card}")
    per_call = DAG_SPLIT if on_card else 0
    if compiled_launches != [per_call * DAG_EXECS] * 2 or \
            launches != [per_call * (DAG_EXECS + 1)] * 2:
        raise AssertionError(f"stage K1 launches {compiled_launches} / "
                             f"{launches}, not {per_call} a call")
    if len(set(pids)) != 2 or os.getpid() in pids:
        raise AssertionError(f"the stages ran in processes {pids}")
    if on_card and (cvds[0] is None or cvds[0] != cvds[1]):
        raise AssertionError(f"the stages see CUDA_VISIBLE_DEVICES {cvds}")
    if on_card and avail_before - avail_after > 512 * 2**20:
        raise AssertionError("the stages' memory did not come back")
    return sum(launches), pids


def phase_ray_client(card):
    """Phase 40b (the runtime is up): ``util.client.serve`` in the driver
    and ``init(address="ray://...")``; through the client, a ``num_gpus=1``
    task runs the port's ``attention`` at the serving shape (B=4, H=32,
    S=128, D=128, bf16, causal) on inputs drawn from ``CLIENT_SEED`` and
    returns the output, its K1 launches and its pid. The output must be
    bit-equal to the driver's same call and the launches 1. Returns the
    task's K1 launches and its pid."""
    import ray_tpu_torch
    from ray_tpu_torch.util.client import serve

    on_card = DEVICE == "cuda"
    B, H, KVH, S, D, causal, dt = SERVE_SHAPE
    seed = CLIENT_SEED

    def attend(device):
        import os

        import torch

        from ray_tpu_torch.ops.attention import attention
        from ray_tpu_torch.ops.cuda import flash_attention as fa

        g = torch.Generator(device=device).manual_seed(seed)
        q, k, v = (torch.randn(B, S, n, D, generator=g, device=device,
                               dtype=getattr(torch, dt))
                   for n in (H, KVH, KVH))
        before = fa.launches
        o = attention(q, k, v, causal=causal)
        if o.device.type == "cuda":
            torch.cuda.synchronize()
        return o, fa.launches - before, os.getpid()

    server = serve(host="127.0.0.1", port=0)
    try:
        t0 = time.perf_counter()
        ctx = ray_tpu_torch.init(address=f"ray://127.0.0.1:{server.port}")
        connect_s = time.perf_counter() - t0
        try:
            task = ctx.remote(attend)
            if on_card:
                task = task.options(num_gpus=1)
            t0 = time.perf_counter()
            got, launches, pid = ctx.get(task.remote(DEVICE), timeout=600)
            task_s = time.perf_counter() - t0
        finally:
            ctx.disconnect()
    finally:
        server.stop()
    want, _, _ = attend(DEVICE)
    want = want.cpu()
    log(f"[40] ray:// client on port {server.port}: connected in "
        f"{connect_s:.3f} s; a num_gpus=1 task (pid {pid}, driver "
        f"{os.getpid()}) ran attention at B={B} H={H} S={S} D={D} {dt} "
        f"causal in {task_s:.2f} s from submit to result (the worker's start "
        f"and the kernel's load included): output {tuple(got.shape)} "
        f"{got.dtype} on {got.device}, bit-equal to the driver's: "
        f"{torch.equal(got, want)}; K1 launches in the task {launches}; "
        f"{card}")
    if pid == os.getpid():
        raise AssertionError("the client's task ran in the driver")
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError("the client task's attention differs from the "
                             "driver's")
    if launches != (1 if on_card else 0):
        raise AssertionError(f"client task K1 launches {launches} != 1")
    return launches, pid


def _ms_or_none(ms):
    return "not measured" if ms is None else f"{ms:.1f}"


def phase_mesh_runtime(gen, card, inproc, phase19):
    """Phases 21, 22, the Data phases 27-29 and phase 40 (the compiled DAG
    and the ``ray://`` client) in one session of the port's runtime, then
    the shutdown checks (every process gone, the phases' workers and actors
    among them, the card's memory back). Removes phase 19's kept
    checkpoint. Returns the (K1, K2, K3) launches of phase 22, of phase
    27's data-fed steps and of phase 28's timed steps, phase 28's figures,
    phase 29's K1 launches and phase 40's (both stages', the client
    task's)."""
    import shutil

    import ray_tpu_torch
    from ray_tpu_torch._private import lifecycle

    on_card = DEVICE == "cuda"
    avail_before = _device_available() if on_card else 0
    ray_tpu_torch.init(num_cpus=4, num_gpus=1 if on_card else 0)
    session_dir = ray_tpu_torch._global_node.session_dir
    tag = "22"
    try:
        phase_collective(on_card)
        launches, m = phase_mesh_train(gen, card, inproc)
        tag = "27"
        data_launches, data_pid = phase_train_data(gen, card)
        tag = "28"
        dense_data = phase_dense_data(card)
        tag = "29"
        predict_launches, predict_pid = phase_batch_predict(
            gen, card, phase19)
        tag = "40"
        t40 = time.perf_counter()
        dag_launches, stage_pids = phase_compiled_dag(
            gen, card, phase19["prompts"])
        client_launches, client_pid = phase_ray_client(card)
        log(f"[40] phase 40: {time.perf_counter() - t40:.1f} s; {card}")
    except BaseException:
        _log_tail(session_dir, tag=tag)
        raise
    finally:
        procs = lifecycle.list_registered(session_dir)
        ray_tpu_torch.shutdown()
        shutil.rmtree(phase19["checkpoint"], ignore_errors=True)
    _check_session_gone("40", session_dir, procs, avail_before, {
        "phase 22 train worker": m["pid"],
        "phase 27 train worker": data_pid,
        "phase 29 predictor actor": predict_pid,
        "phase 40 stage A": stage_pids[0], "phase 40 stage B": stage_pids[1],
        "phase 40 client task worker": client_pid})
    return dict(mesh=launches, trainer_data=data_launches,
                dense_data=dense_data, batch_predictor=predict_launches,
                compiled_dag=dag_launches, ray_client=client_launches)


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
    steps, then one profiled step. Returns the (K1, K2, K3) launches over
    the timed steps, ms/step, tokens/s, MFU and the busy share (the
    profiled step's device time over the timed steps' wall)."""
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
    return dict(launches=launches, ms_step=ms_step, tok_s=tok_s,
                mfu=tok_s * flops_tok / PEAK_FLOPS["bfloat16"],
                busy=min(device_ms / ms_step, 1.0))


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
# phase 33: V-trace's recursion on the card against the CPU on the same
# inputs, relative to the largest entry (sums in other orders)
TOL_VTRACE = 1e-5


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


def _rel_err(got, want):
    """A metric's error: relative to the value, or to 0.1 where it is
    smaller (scalars of cancelling terms)."""
    return abs(got - want) / max(abs(want), 0.1)


def _update_err(got, want, init):
    """Each leaf's distance from ``want`` against the norm of its update
    from ``init``, the largest over the leaves (Adam's first step is about
    lr * sign(g): an entry whose gradient is near 0 can step another way on
    the two, as in the CPU tests)."""
    return max(((a - b).norm() / (b - c).norm()).item() for a, b, c in zip(
        tree_leaves(got), tree_leaves(want), tree_leaves(init)))


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
    errs = {k: _rel_err(first["card"][k], v) for k, v in first["cpu"].items()}
    errs.update({f"update {k}": _rel_err(upd["card"][k], v)
                 for k, v in upd["cpu"].items()})
    p_err = _update_err(card.get_weights(), host.get_weights(), w0)
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
    two process gates over gloo on the CPU (4 rank processes each); then
    its ``moe-expert-mesh`` section on 4 gloo ranks on the CPU."""
    from ray_tpu_torch.dryrun import _run_ranks, dryrun_multichip

    t0 = time.perf_counter()
    names = [n for n, _ in dryrun_multichip(1, device=DEVICE)["sections"]]
    log(f"[26] dryrun_multichip(1): sections {names} in "
        f"{time.perf_counter() - t0:.1f} s")
    if names != ["tiny-4d-mesh", "two-process-mesh", "two-slice-dcn"]:
        raise AssertionError(f"dryrun_multichip(1) ran {names}")
    # the expert mesh (data, expert=4) on 4 gloo ranks on this machine's
    # CPU: the smallest run that holds the MoE to this torch's rule for
    # views of sharded DTensors
    t0 = time.perf_counter()
    sections = _run_ranks(4, "cpu", ("moe",))
    log(f"[26] the dry run's MoE section on 4 gloo ranks (CPU, torch "
        f"{torch.__version__}): {sections} in "
        f"{time.perf_counter() - t0:.1f} s")
    if [n for n, _ in sections] != ["moe-expert-mesh"]:
        raise AssertionError(f"the 4-rank MoE section ran {sections}")


# phases 30-31: Tune over phase 7's LoRA step on a Llama-2-7B base cut from
# 32 to 4 layers (each trial draws its own frozen base)
TUNE_BASE_CFG = dataclasses.replace(LlamaConfig.llama2_7b(), num_layers=4)
TUNE_LRS = [1e-4, 3e-4, 1e-3, 3e-3]
# phase 30 sweeps them from the largest down: with one trial at a time, ASHA
# compares each trial with the ones before it, and the loss after one AdamW
# step falls as lr grows on this grid, so in rising order each trial would
# beat the ones before it at every rung and none would be stopped
ASHA_LRS = TUNE_LRS[::-1][:3]  # 3 trials, not 4: a trial takes ~35 s
TUNE_MAX_T = 4       # ASHA's max_t: steps of a trial that is not stopped
PBT_ITERS = 6        # PBT's iterations, one step each


def tune_setup():
    """Phases 30-31's step: phase 7's LoRA configuration (rank 16 on all
    seven projections, remat "full", loss_chunk 256, B=TRAIN_B,
    S=TRAIN_S) on ``TUNE_BASE_CFG``, drawn as ``LlamaGenerator`` draws its
    base. Returns (the base's config, the step's config, the LoRA
    config)."""
    cfg = dataclasses.replace(
        TUNE_BASE_CFG, max_seq_len=TRAIN_S, remat=True,
        remat_policy="full", loss_chunk=256)
    return TUNE_BASE_CFG, cfg, LoraConfig(rank=16)


def replay_steps(base, cfg, lcfg, batch, lr, n, tree=None):
    """Phases 30-31's in-driver replay: ``n`` steps of phase 7's machinery
    at ``lr`` from the LoRA drawn from seed 1, or from a checkpoint's state
    ``tree``. Returns [(loss, grad_norm, step)]."""
    from ray_tpu_torch.parallel import load_train_state

    tx = adamw(lr)
    state = (create_train_state(
        lambda g: init_lora(cfg, lcfg, g, g.device), tx, device=DEVICE,
        seed=1) if tree is None
        else load_train_state(tree, tx, device=DEVICE))
    step = make_train_step(
        lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg), tx,
        frozen=base)
    out = []
    for _ in range(n):
        state, m = step(state, batch)
        out.append((m["loss"].item(), m["grad_norm"].item(), m["step"]))
    return out


def phase_tune(card, in_session=None):
    """Phases 30 and 31 in one session of the port's runtime
    (``ray_tpu_torch.init(num_gpus=1)``), then ``in_session(card)`` in the
    same session (phases 32-33), then the shutdown checks. Phase
    30: ``Tuner(TorchTrainer(...))`` sweeps ``lr`` over ASHA_LRS with ASHA,
    one trial at a time, each trial's GPU worker running ``lora_trial``.
    Phase 31: PBT over 2 function trainables of ``lora_trial`` that hold
    half the card each. Every trial's losses are held bit-equal against an
    in-driver replay (a PBT trial restored from a donor's checkpoint from
    that checkpoint at its mutated lr). Returns the (K1, K2, K3) launches
    of each phase's trials and what ``in_session`` returned."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch._private import lifecycle
    from ray_tpu_torch.air.config import FailureConfig, RunConfig
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer, load_pytree

    def lora_trial(config):
        """One trial of phases 30-31, in its own process: phase 7's LoRA step at
        ``config["lr"]`` on the card (the kernels phase 2 built, loaded, not
        rebuilt: a failure to load fails the trial), the frozen base drawn from
        seed 0 and the LoRA from seed 1, or the state restored from Tune's
        checkpoint. Steps up to ``config["iters"]``, each reported with its
        loss, grad norm, wall ms and K1-K3 launches: through ``train.report``
        in a ``TorchTrainer`` worker (``config["api"] == "train"``), or through
        ``tune.report`` with a checkpoint of the state (LoRA params, AdamW
        moments, step) in a function trainable. Self-contained: it travels to
        the trial's process by value."""
        import dataclasses
        import os
        import pickle
        import shutil
        import tempfile
        import time

        import torch

        from ray_tpu_torch import resolve_device, train, tune
        from ray_tpu_torch.models.llama import (
            init_llama, init_lora, llama_lora_loss)
        from ray_tpu_torch.ops.cuda import _build
        from ray_tpu_torch.ops.cuda import flash_attention as fa
        from ray_tpu_torch.parallel import (
            adamw, create_train_state, load_train_state, make_train_step,
            train_state_tree)

        t_start = time.time()
        # when this process began (it may have waited in a warm pool)
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(ln.split()[1]) for ln in f
                         if ln.startswith("btime"))
        t_proc = btime + ticks / os.sysconf("SC_CLK_TCK")
        dev = resolve_device(config["device"])  # no card: the trial fails
        prebuilt = {}
        for name in config["kernels"]:
            prebuilt[name] = _build._target(name)[1].exists()
            _build.load(name)
        cfg, lcfg, base_cfg = pickle.loads(config["cfgs"])
        tok = torch.tensor(config["tokens"], device=dev)
        batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
        g = torch.Generator(device=dev).manual_seed(0)
        base = init_llama(dataclasses.replace(
            base_cfg, param_dtype=base_cfg.dtype), g, dev)
        tx = adamw(config["lr"])
        pbt = config["api"] == "tune"
        ckpt = tune.get_checkpoint() if pbt else None
        if ckpt is None:
            state = create_train_state(
                lambda gg: init_lora(cfg, lcfg, gg, gg.device), tx, device=dev,
                seed=1)
        else:
            state = load_train_state(train.load_pytree(ckpt.path, "state"), tx,
                                     device=dev)
        step = make_train_step(
            lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg), tx,
            frozen=base)
        info = {"pid": os.getpid(), "lr": config["lr"],
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "prebuilt": prebuilt, "t_start": t_start, "t_proc": t_proc,
                "restored_from": ckpt.path if ckpt is not None else None,
                "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                           else "cpu")}
        if pbt and ckpt is None:
            # PBT's first trials start stepping together: a trial whose
            # process came up late could reach its perturbation points only
            # after the other had finished, with no one left to exploit
            open(os.path.join(config["barrier"], str(os.getpid())),
                 "w").close()
            deadline = time.time() + 300
            while len(os.listdir(config["barrier"])) < 2:
                if time.time() > deadline:
                    raise TimeoutError("the other PBT trial never started")
                time.sleep(0.05)
        while state.step < config["iters"]:
            before = (fa.launches, fa.dq_launches, fa.dkv_launches)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            metrics = dict(info, step=m["step"], loss=m["loss"].item(),
                           grad_norm=m["grad_norm"].item(),
                           ms=(time.perf_counter() - t0) * 1e3, t=time.time(),
                           launches=[a - b for a, b in zip(
                               (fa.launches, fa.dq_launches, fa.dkv_launches),
                               before)])
            if not pbt:
                train.report(metrics)
                continue
            d = tempfile.mkdtemp(prefix="lora_trial_")
            train.save_pytree(train_state_tree(state), d, "state")
            tune.report(metrics, checkpoint=train.Checkpoint(d))
            shutil.rmtree(d)  # report copied it into the trial's directory

    base_cfg, cfg, lcfg = tune_setup()
    on_card = DEVICE == "cuda"
    L = cfg.num_layers
    per_step = (2 * L, L, L) if on_card else (0, 0, 0)
    # the configs travel pickled: a trainer trial's actor unpickles its
    # trainer's loop config, and a LlamaConfig there would make it import
    # torch (seconds a process) for nothing
    common = {"cfgs": pickle.dumps((cfg, lcfg, base_cfg)),
              "tokens": train_tokens(cfg), "device": DEVICE,
              "kernels": TENSOR_CORE_LIBS if on_card else ()}

    class Recorder(tune.Callback):
        """Every trial's results, in the order the driver saw them, and when
        the driver started and completed each trial."""

        def __init__(self):
            self.results, self.started, self.completed = [], {}, {}

        def on_trial_start(self, iteration, trials, trial):
            self.started.setdefault(trial.trial_id, time.time())

        def on_trial_result(self, iteration, trials, trial, result):
            self.results.append((trial.trial_id, dict(result)))

        def on_trial_complete(self, iteration, trials, trial):
            self.completed[trial.trial_id] = time.time()

    storage = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    avail_before = _device_available() if on_card else 0
    ray_tpu_torch.init(num_cpus=4, num_gpus=1 if on_card else 0)
    session_dir = ray_tpu_torch._global_node.session_dir
    tag = "30"
    try:
        asha = tune.ASHAScheduler(max_t=TUNE_MAX_T, grace_period=1,
                                  reduction_factor=2)
        rec30 = Recorder()
        t0 = time.time()
        grid30 = tune.Tuner(
            TorchTrainer(lora_trial, train_loop_config=dict(
                common, api="train", iters=TUNE_MAX_T, lr=None),
                scaling_config=ScalingConfig(num_workers=1,
                                             use_gpu=on_card)),
            param_space={"train_loop_config": {
                "lr": tune.grid_search(ASHA_LRS)}},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        scheduler=asha,
                                        max_concurrent_trials=1),
            run_config=RunConfig(
                name="asha", storage_path=storage, callbacks=[rec30],
                failure_config=FailureConfig(max_failures=0)),
        ).fit()
        s30 = time.time() - t0
        tag = "31"
        pbt = tune.PopulationBasedTraining(
            perturbation_interval=2, seed=0,
            hyperparam_mutations={"lr": TUNE_LRS})
        rec31 = Recorder()
        t0 = t31 = time.time()
        grid31 = tune.Tuner(
            lora_trial,
            param_space=dict(common, api="tune", iters=PBT_ITERS,
                             barrier=tempfile.mkdtemp(dir=storage),
                             lr=tune.grid_search([TUNE_LRS[0],
                                                  TUNE_LRS[-1]])),
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        scheduler=pbt),
            run_config=RunConfig(
                name="pbt", storage_path=storage, callbacks=[rec31],
                stop={"training_iteration": PBT_ITERS},
                failure_config=FailureConfig(max_failures=0)),
            resources_per_trial=(dict(CPU=1, GPU=0.5) if on_card
                                 else dict(CPU=1)),
        ).fit()
        s31 = time.time() - t0
        # the in-driver replays, on a base drawn as the trials draw theirs
        tok = torch.from_numpy(common["tokens"]).to(DEVICE)
        batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
        g = torch.Generator(device=DEVICE).manual_seed(0)
        base = init_llama(dataclasses.replace(
            base_cfg, param_dtype=base_cfg.dtype), g, torch.device(DEVICE))
        replay30 = {lr: replay_steps(base, cfg, lcfg, batch, lr, TUNE_MAX_T)
                    for lr in ASHA_LRS}
        # each restored incarnation of a trial (its own actor), replayed
        # from its donor's checkpoint at its mutated lr
        restarts = {}
        for tid, r in rec31.results:
            if r["restored_from"]:
                restarts.setdefault((tid, r["pid"], r["restored_from"]),
                                    []).append(r)
        replays31 = {}
        for key, rs in restarts.items():
            tree = load_pytree(key[2], "state", device=DEVICE)
            replays31[key] = replay_steps(base, cfg, lcfg, batch,
                                          rs[0]["lr"], len(rs), tree)
            del tree
        replay31_plain = {lr: replay_steps(base, cfg, lcfg, batch, lr,
                                           PBT_ITERS)
                          for lr in (TUNE_LRS[0], TUNE_LRS[-1])}
        del base
        session_out = None
        if in_session is not None:
            tag = "32-35"
            session_out = in_session(card)
    except BaseException:
        _log_tail(session_dir, tag=tag)
        raise
    finally:
        procs = lifecycle.list_registered(session_dir)
        ray_tpu_torch.shutdown()
        shutil.rmtree(storage, ignore_errors=True)

    # phase 30: every trial's steps against its replay; ASHA's stops
    by_trial = {}
    for tid, r in rec30.results:
        by_trial.setdefault(tid, []).append(r)
    lines, stopped = [], 0
    for tid, rs in by_trial.items():
        lr = rs[0]["lr"]
        got = [(r["loss"], r["grad_norm"], r["step"]) for r in rs]
        want = replay30[lr][:len(got)]
        t_in = rec30.started[tid]
        lines.append(f"lr {lr:g}: {len(got)} steps, losses "
                     f"{[round(x[0], 6) for x in got]}, worker pid "
                     f"{rs[0]['pid']}; from the trial's start: worker "
                     f"process {rs[0]['t_proc'] - t_in:.2f} s, loop "
                     f"{rs[0]['t_start'] - t_in:.2f} s, first report "
                     f"{rs[0]['t'] - t_in:.2f} s, last "
                     f"{rs[-1]['t'] - t_in:.2f} s, complete "
                     f"{rec30.completed[tid] - t_in:.2f} s; ms/step "
                     f"{[round(r['ms'], 1) for r in rs]}")
        stopped += len(got) < TUNE_MAX_T
        if got != want:
            raise AssertionError(f"[30] trial lr {lr:g}: {got} != the "
                                 f"in-driver replay {want}")
        if any(tuple(r["launches"]) != per_step for r in rs):
            raise AssertionError(f"[30] trial lr {lr:g}: launches "
                                 f"{[r['launches'] for r in rs]} != "
                                 f"{per_step} a step")
        if on_card and (rs[0]["visible"] != "0"
                        or not all(rs[0]["prebuilt"].values())):
            raise AssertionError(f"[30] trial lr {lr:g} did not hold the "
                                 f"card with the prebuilt kernels")
    best = grid30.get_best_result()
    log(f"[30] Tuner(TorchTrainer) with ASHA(max_t={TUNE_MAX_T}, "
        f"grace_period=1, reduction_factor=2), 7B widths cut to {L} layers, "
        f"B={TRAIN_B} S={TRAIN_S}, one trial at a time: {len(by_trial)} "
        f"trials in {s30:.1f} s, {stopped} stopped before max_t; "
        + "; ".join(lines) + f"; every step bit-equal to its in-driver "
        f"replay, launches {per_step} a step; best: lr "
        f"{best.config['train_loop_config']['lr']:g}, loss "
        f"{best.metrics['loss']:.6f}; {card}")
    if grid30.num_errors or len(by_trial) != len(ASHA_LRS):
        raise AssertionError(f"[30] {grid30.num_errors} errors, "
                             f"{len(by_trial)} trials: {grid30.errors}")
    if stopped < 1:
        raise AssertionError("[30] ASHA stopped no trial before max_t")

    # phase 31: the exploits, the restored trials against their replays
    if grid31.num_errors or pbt._exploits < 1 or not restarts:
        raise AssertionError(f"[31] {grid31.num_errors} errors "
                             f"{grid31.errors}, {pbt._exploits} exploits, "
                             f"restarts {list(restarts)}")
    pids = {r["pid"] for _, r in rec31.results}
    lines = []
    for key, rs in restarts.items():
        got = [(r["loss"], r["grad_norm"], r["step"]) for r in rs]
        lines.append(f"trial {key[0]} restored from "
                     f"{os.path.basename(os.path.dirname(key[2]))}/"
                     f"{os.path.basename(key[2])} at lr {rs[0]['lr']:g}: "
                     f"steps {[x[2] for x in got]}, losses "
                     f"{[round(x[0], 6) for x in got]}")
        if got != replays31[key]:
            raise AssertionError(f"[31] the restored trial's steps {got} != "
                                 f"the replay from its donor's checkpoint "
                                 f"{replays31[key]}")
    for tid, r in rec31.results:
        if r["restored_from"] is None:
            want = replay31_plain[r["lr"]][r["step"] - 1]
            if (r["loss"], r["grad_norm"], r["step"]) != want:
                raise AssertionError(f"[31] trial {tid} step {r['step']}: "
                                     f"{r['loss']} != the replay {want}")
        if tuple(r["launches"]) != per_step:
            raise AssertionError(f"[31] trial {tid} launches "
                                 f"{r['launches']} != {per_step}")
        if on_card and r["visible"] != "0":
            raise AssertionError(f"[31] a trial actor saw "
                                 f"CUDA_VISIBLE_DEVICES={r['visible']}")
    # the two first actors held the card at once
    firsts = [min((r for _, r in rec31.results if r["pid"] == pid),
                  key=lambda r: r["t"]) for pid in pids]
    spans = {pid: (min(r["t_start"] for _, r in rec31.results
                       if r["pid"] == pid),
                   max(r["t"] for _, r in rec31.results if r["pid"] == pid))
             for pid in pids}
    overlap = any(a != b and spans[a][0] < spans[b][1]
                  and spans[b][0] < spans[a][1]
                  for a in pids for b in pids)
    log(f"[31] PBT(perturbation_interval=2, lr in {TUNE_LRS}, seed=0), 2 "
        f"function trainables with {{'CPU': 1, 'GPU': 0.5}}, "
        f"{PBT_ITERS} iterations: {s31:.1f} s (trials started at "
        f"{[round(t - t31, 2) for t in sorted(rec31.started.values())]} s, "
        f"completed at "
        f"{[round(t - t31, 2) for t in sorted(rec31.completed.values())]} "
        f"s), {pbt._exploits} exploits, "
        f"{len(pids)} trial actors (pids {sorted(pids)}), two on the card at "
        f"once: {overlap}; " + "; ".join(lines) + "; each bit-equal to the "
        f"replay from the donor's checkpoint at the mutated lr; the other "
        f"steps bit-equal to their replays; launches {per_step} a step in "
        f"every actor; first reports "
        f"{[round(f['t'] - f['t_start'], 2) for f in firsts]} s after the "
        f"actors' loops began; {card}")
    if not overlap:
        raise AssertionError("[31] no two trial actors held the card at "
                             "once")
    workers = {f"phase 30 worker {r['lr']:g}": r["pid"]
               for _, r in rec30.results}
    workers.update({f"phase 31 actor {pid}": pid for pid in pids})
    _check_session_gone("31", session_dir, procs, avail_before, workers)
    n30 = [sum(r["launches"][i] for _, r in rec30.results) for i in range(3)]
    n31 = [sum(r["launches"][i] for _, r in rec31.results) for i in range(3)]
    return n30, n31, session_out


# phases 32-33: RLlib's on-policy family with the learner on the card and
# CPU env runners, on a numpy CartPole (the chip machine has no gymnasium)
class _CartPole:
    """gymnasium's ``CartPole-v1`` in numpy, step for step: its dynamics
    (Euler, tau 0.02), its limits (|x| > 2.4 or |theta| > 12 degrees
    terminates, 500 steps truncate, as ``gymnasium.make`` wraps it), reward
    1 up to and including the step the pole falls, the start state drawn
    uniform in [-0.05, 0.05] from ``np.random.default_rng(seed)`` (which is
    ``gymnasium.utils.seeding.np_random(seed)``'s stream). Its spaces are
    read by duck typing: ``n`` actions; ``low``, ``high``, ``shape`` and
    ``dtype`` of the observations."""

    MAX_STEPS = 500
    gravity, masscart, masspole, length = 9.8, 1.0, 0.1, 0.5
    force_mag, tau = 10.0, 0.02
    total_mass = masspole + masscart
    polemass_length = masspole * length
    theta_threshold = 12 * 2 * np.pi / 360
    x_threshold = 2.4

    def __init__(self, config=None):
        high = np.array([self.x_threshold * 2, np.inf,
                         self.theta_threshold * 2, np.inf], np.float32)
        self.observation_space = types.SimpleNamespace(
            low=-high, high=high, shape=high.shape, dtype=np.float32)
        self.action_space = types.SimpleNamespace(n=2)
        self._rng = np.random.default_rng()
        self.state = None
        self._steps = 0
        self._fell = False

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(low=-0.05, high=0.05, size=(4,))
        self._steps, self._fell = 0, False
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot)
                * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta)
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)
        terminated = bool(x < -self.x_threshold or x > self.x_threshold
                          or theta < -self.theta_threshold
                          or theta > self.theta_threshold)
        reward = 0.0 if self._fell else 1.0
        self._fell = self._fell or terminated
        self._steps += 1
        return (np.array(self.state, dtype=np.float32), reward, terminated,
                self._steps >= self.MAX_STEPS, {})

    def close(self):
        pass


class _Pendulum:
    """gymnasium's ``Pendulum-v1`` in numpy, step for step: its dynamics
    (g 10, m = l = 1, dt 0.05, speed clipped to 8, torque to 2), its reward
    -(angle_normalize(th)^2 + 0.1 thdot^2 + 0.001 u^2), never terminated,
    200 steps truncate (as ``gymnasium.make`` wraps it), the start state
    (th, thdot) drawn uniform in [-pi, pi] x [-1, 1] from
    ``np.random.default_rng(seed)``. Its spaces are read by duck typing:
    ``low``, ``high``, ``shape`` and ``dtype``."""

    MAX_STEPS = 200
    max_speed, max_torque, dt, g, m, l = 8.0, 2.0, 0.05, 10.0, 1.0, 1.0

    def __init__(self, config=None):
        high = np.array([1.0, 1.0, self.max_speed], np.float32)
        self.observation_space = types.SimpleNamespace(
            low=-high, high=high, shape=high.shape, dtype=np.float32)
        self.action_space = types.SimpleNamespace(
            low=np.array([-self.max_torque], np.float32),
            high=np.array([self.max_torque], np.float32), shape=(1,),
            dtype=np.float32)
        self._rng = np.random.default_rng()
        self.state = None
        self._steps = 0

    def _obs(self):
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        high = np.array([np.pi, 1.0])
        self.state = self._rng.uniform(low=-high, high=high)
        self._steps = 0
        return self._obs(), {}

    def step(self, u):
        th, thdot = self.state
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        th_norm = ((th + np.pi) % (2 * np.pi)) - np.pi
        costs = th_norm ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (3 * self.g / (2 * self.l) * np.sin(th)
                            + 3.0 / (self.m * self.l ** 2) * u) * self.dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * self.dt
        self.state = np.array([newth, newthdot])
        self._steps += 1
        return self._obs(), -costs, False, self._steps >= self.MAX_STEPS, {}

    def close(self):
        pass


RL_ITERS = 5          # phase 32's PPO iterations
APPO_STEPS = 3        # phase 33's APPO steps


def _rl_learner_device():
    """The learners' device as a user asks for it: the default (None, the
    card) on the card, the CPU in a CPU rehearsal."""
    return None if DEVICE == "cuda" else DEVICE


def _timed(fn):
    """(fn(), ms): CUDA events around the call on the card, the host clock
    on the CPU."""
    if DEVICE != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _rl_runner_check(tag, algo):
    """Every env runner of ``algo`` is a CPU actor: no GPU lease (no
    ``CUDA_VISIBLE_DEVICES`` of its own) and CUDA never initialized in it;
    the learner's params on the learners' device."""
    import ray_tpu_torch

    reports = ray_tpu_torch.get([r.device_report.remote()
                                 for r in algo.env_runners], timeout=60)
    learner = algo.learner_group.local_learner()
    devices = {str(p.device) for p in tree_leaves(learner.params)}
    want = "cuda:0" if DEVICE == "cuda" else "cpu"
    if devices != {want}:
        raise AssertionError(f"[{tag}] the learner's params on {devices}, "
                             f"want {want}")
    for r in reports:
        if r["cuda_visible_devices"] not in (None, "") or \
                r["cuda_initialized"]:
            raise AssertionError(f"[{tag}] an env runner touched CUDA: {r}")
    return devices, reports


def phase_rl_ppo(card):
    """Phase 32: PPO with the learner on the card (``learners()`` left at
    its default device) and 2 CPU env runners of 4 numpy CartPoles each,
    64 steps a fragment, train batch 512, minibatch 128, 4 epochs; 5
    iterations in the port's runtime session of phases 30-31. Iteration
    1's training batch (``_postprocess``'s output) replayed on a CPU
    ``PPOLearner`` from the same starting weights: its metrics within
    TOL_PPO, its params within TOL_PPO_UPDATE. Exact env-step counts,
    finite metrics, a checkpoint loaded into a fresh ``PPO`` with equal
    weights, ``compute_single_action`` in {0, 1}."""
    import shutil
    import tempfile

    from ray_tpu_torch.rllib import PPO, PPOConfig
    from ray_tpu_torch.rllib.core.learner import PPOLearner

    cfg = (PPOConfig()
           .environment(_CartPole)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=64)
           .training(train_batch_size=512, minibatch_size=128, num_epochs=4)
           .learners(device=_rl_learner_device())
           .debugging(seed=0))
    t0 = time.perf_counter()
    algo = cfg.build()
    t_build = time.perf_counter() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ppo_")
    try:
        devices, reports = _rl_runner_check("32", algo)
        w0 = algo.get_weights()
        batches, samples_of, update_ms = [], [], []
        post, update = algo._postprocess, algo.learner_group.update

        def record_post(samples):
            samples_of.append(samples)
            batches.append(post(samples))
            return batches[-1]

        def timed_update(batch):
            out, ms = _timed(lambda: update(batch))
            update_ms.append(ms)
            return out

        algo._postprocess = record_post
        algo.learner_group.update = timed_update
        results, walls = [], []
        for i in range(RL_ITERS):
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
            if i == 0:
                w1 = algo.get_weights()
        for i, r in enumerate(results):
            steps = r["env_steps_this_iter"]
            bad = [k for k, v in r.items() if isinstance(v, float)
                   and not np.isfinite(v)]
            if steps != 512 or \
                    r["num_env_steps_sampled_lifetime"] != 512 * (i + 1) or \
                    bad:
                raise AssertionError(f"[32] iteration {i + 1}: {steps} env "
                                     f"steps, lifetime "
                                     f"{r['num_env_steps_sampled_lifetime']}"
                                     f", not finite {bad}")
        # iteration 1's batch on a CPU learner from the same weights
        host = PPOLearner(algo._module_spec, cfg.learner_config_dict(),
                          device="cpu")
        host.set_weights(w0)
        want = host.update(batches[0])
        errs = {k: _rel_err(results[0][k], v) for k, v in want.items()}
        p_err = _update_err(w1, host.get_weights(), w0)
        # the checkpoint into a fresh PPO (no runners: only the learner)
        algo.save_checkpoint(ckpt)
        fresh = PPO(config=cfg.copy().env_runners(num_env_runners=0))
        try:
            fresh.load_checkpoint(ckpt)
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(fresh.get_weights()),
                tree_leaves(algo.get_weights())))
        finally:
            fresh.stop()
        action = algo.compute_single_action(np.zeros(4, np.float32))
    finally:
        algo.stop()
        shutil.rmtree(ckpt, ignore_errors=True)
    sample_s = [[round(s["sample_time_s"], 3) for s in ss]
                for ss in samples_of]
    log(f"[32] PPO on the numpy CartPole, learner on {sorted(devices)}, 2 "
        f"CPU env runners x 4 envs x 64 steps (runners {reports}); build "
        f"{t_build:.2f} s; per iteration: wall "
        f"{[round(w, 3) for w in walls]} s, sample_time_s {sample_s}, "
        f"learner update {[round(m, 2) for m in update_ms]} ms (16 "
        f"minibatch steps), episode_return_mean "
        f"{[round(r['episode_return_mean'], 2) for r in results]}; "
        f"iteration 1 replayed on a CPU PPOLearner: {results[0]['total_loss']:.6f} "
        f"against {want['total_loss']:.6f} total loss, largest relative "
        f"difference {max(errs.values()):.2e} (tol {TOL_PPO:g}), params "
        f"{p_err:.2e} of the update (tol {TOL_PPO_UPDATE:g}); checkpoint "
        f"round trip equal: {same}; compute_single_action {action}; {card}")
    if max(errs.values()) > TOL_PPO:
        raise AssertionError(f"[32] iteration 1 on the card disagrees with "
                             f"the CPU replay: {errs}")
    if p_err > TOL_PPO_UPDATE:
        raise AssertionError(f"[32] the params after iteration 1 differ by "
                             f"{p_err} of the update")
    if not same:
        raise AssertionError("[32] the checkpoint did not restore the "
                             "weights")
    if int(action) not in (0, 1):
        raise AssertionError(f"[32] compute_single_action gave {action}")
    return {"walls": walls, "update_ms": update_ms}


def phase_rl_appo(card):
    """Phase 33: APPO (IMPALA's async loop, V-trace, the clipped surrogate)
    with the learner on the card and 2 CPU env runners (4 numpy CartPoles,
    64 steps a fragment), 4 fragments a step, 3 steps. The first fragment's
    update against a CPU ``APPOLearner`` from the same weights (metrics
    within TOL_PPO, params within TOL_PPO_UPDATE); ``vtrace`` on that
    fragment on the card against the CPU (1e-5); 4 fragments consumed every
    step."""
    from ray_tpu_torch.rllib import APPOConfig
    from ray_tpu_torch.rllib.algorithms.appo.appo import APPOLearner
    from ray_tpu_torch.rllib.utils.vtrace import vtrace

    cfg = (APPOConfig()
           .environment(_CartPole)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=64)
           .training(num_fragments_per_step=4)
           .learners(device=_rl_learner_device())
           .debugging(seed=0))
    t0 = time.perf_counter()
    algo = cfg.build()
    t_build = time.perf_counter() - t0
    try:
        devices, _ = _rl_runner_check("33", algo)
        learner = algo.learner_group.local_learner()
        first, update_ms = {}, []
        update = learner.update

        def recorded_update(batch):
            if not first:
                first.update(w0=learner.get_weights(), batch=batch)
            out, ms = _timed(lambda: update(batch))
            update_ms.append(ms)
            if "metrics" not in first:
                first.update(metrics=out, w1=learner.get_weights())
            return out

        learner.update = recorded_update
        results, walls = [], []
        for _ in range(APPO_STEPS):
            t0 = time.perf_counter()
            results.append(algo.step())
            walls.append(time.perf_counter() - t0)
    finally:
        algo.stop()
    consumed = [r["num_fragments_consumed"] for r in results]
    host = APPOLearner(algo._module_spec, cfg.learner_config_dict(),
                       device="cpu")
    host.set_weights(first["w0"])
    want = host.update(first["batch"])
    errs = {k: _rel_err(first["metrics"][k], v) for k, v in want.items()}
    p_err = _update_err(first["w1"], host.get_weights(), first["w0"])
    # vtrace on the first fragment's inputs (the CPU forward at w0), on the
    # card and on the CPU
    b = {k: torch.as_tensor(np.asarray(v)) for k, v in first["batch"].items()}
    with torch.no_grad():
        out = host.module.forward(first["w0"], b["obs"].transpose(0, 1))
        target_logp = host.module.dist.logp(out["logits"],
                                            b["actions"].long().T)
    args = (b["logp"].T, target_logp, b["rewards"].T, out["vf"],
            b["dones"].T, b["bootstrap"])
    want_vt = vtrace(*args, gamma=cfg.gamma)
    got_vt = vtrace(*(a.to(DEVICE) for a in args), gamma=cfg.gamma)
    vt_err = max(_rel_max(g.cpu(), w) for g, w in zip(got_vt, want_vt))
    log(f"[33] APPO on the numpy CartPole, learner on {sorted(devices)}, 2 "
        f"CPU env runners x 4 envs x 64 steps, 4 fragments a step: build "
        f"{t_build:.2f} s; per step: wall {[round(w, 3) for w in walls]} s, "
        f"fragments consumed {consumed}, env steps "
        f"{[r['env_steps_this_iter'] for r in results]}, learner update "
        f"{[round(m, 2) for m in update_ms]} ms; the first fragment's "
        f"update against a CPU APPOLearner: largest relative difference "
        f"{max(errs.values()):.2e} (tol {TOL_PPO:g}), params {p_err:.2e} of "
        f"the update (tol {TOL_PPO_UPDATE:g}); vtrace (T=64, B=4) on "
        f"{DEVICE} against the CPU {vt_err:.2e} (tol {TOL_VTRACE:g}); {card}")
    if consumed != [4] * APPO_STEPS or any(
            r["env_steps_this_iter"] != 4 * 4 * 64 for r in results):
        raise AssertionError(f"[33] fragments consumed {consumed}")
    if max(errs.values()) > TOL_PPO or p_err > TOL_PPO_UPDATE:
        raise AssertionError(f"[33] the first update on the card disagrees "
                             f"with the CPU: {errs}, params {p_err}")
    if vt_err > TOL_VTRACE:
        raise AssertionError(f"[33] vtrace on the card disagrees: {vt_err}")
    return {"walls": walls, "update_ms": update_ms}


DQN_ITERS = 5         # phase 34's DQN iterations
SAC_ITERS = 4         # phase 35's SAC iterations


def _moved_update_err(got, want, init):
    """``_update_err`` over the leaves that moved from ``init``; a leaf
    that did not move in ``want`` (DQN's epsilon) must equal it in
    ``got``."""
    moving = []
    for a, b, c in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(init)):
        if torch.equal(b, c):
            if not torch.equal(a, b):
                raise AssertionError("a leaf moved on one side only")
        else:
            moving.append(((a - b).norm() / (b - c).norm()).item())
    return max(moving)


def _check_replay(tag, got, want, w1, host_w, w0, what, tol=TOL_PPO):
    """A card update's metrics and params against the CPU's replay of it:
    (largest metric error, params error), raising beyond ``tol`` and
    TOL_PPO_UPDATE."""
    errs = {k: _rel_err(got[k], v) for k, v in want.items()}
    p_err = _moved_update_err(w1, host_w, w0)
    if max(errs.values()) > tol or p_err > TOL_PPO_UPDATE:
        raise AssertionError(f"[{tag}] {what} on the card disagrees with the "
                             f"CPU: {errs}, params {p_err}")
    return max(errs.values()), p_err


def _record_first(obj, state_fn, **draws):
    """Wrap ``obj.update`` to keep the first update's batch, the state
    before and after it (``state_fn()``, CPU copies) and its metrics, and
    every update's ms (CUDA events on the card). ``draws`` names a method
    of ``obj`` that makes the update's random draws: the first call's
    result is kept too."""
    first, update_ms = {}, []
    update = obj.update
    for name in draws.values():
        make = getattr(obj, name)

        def recorded_draws(*a, _make=make):
            out = _make(*a)
            first.setdefault("draws", {k: v.cpu() for k, v in out.items()})
            return out

        setattr(obj, name, recorded_draws)

    def recorded(batch, **kw):
        if "batch" not in first:
            first.update(batch=dict(batch), s0=state_fn())
        out, ms = _timed(lambda: update(batch, **kw))
        update_ms.append(ms)
        if "metrics" not in first:
            first.update(metrics=dict(out), s1=state_fn())
        return out

    obj.update = recorded
    return first, update_ms


def phase_rl_dqn(card):
    """Phase 34: DQN (double Q, dueling, prioritized replay) with the
    learner on the card and 2 CPU env runners of 4 numpy CartPoles, 16
    steps a fragment; 128 env steps an iteration, learning once 256 valid
    steps are stored, then 2 updates of batch 64 an iteration, a hard
    target sync every 256 steps; 5 iterations. The first update's replay
    batch replayed on a CPU ``DQNLearner`` from the same weights and
    target net (metrics within TOL_PPO, params within TOL_PPO_UPDATE);
    each target sync leaves the target net equal to the online one; a
    checkpoint into a fresh ``DQN`` restores the weights and the target
    net; no runner touches CUDA."""
    import shutil
    import tempfile

    from ray_tpu_torch.rllib import DQN, DQNConfig
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import DQNLearner, load_tree
    from ray_tpu_torch.rllib.core.learner import cpu_snapshot

    cfg = (DQNConfig()
           .environment(_CartPole)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=16)
           .training(lr=1e-3, train_batch_size=64,
                     num_steps_sampled_before_learning_starts=256,
                     target_network_update_freq=256,
                     training_intensity=1.0, prioritized_replay=True)
           .learners(device=_rl_learner_device())
           .debugging(seed=0))
    t0 = time.perf_counter()
    algo = cfg.build()
    t_build = time.perf_counter() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_dqn_")
    try:
        devices, _ = _rl_runner_check("34", algo)
        learner = algo.learner_group.local_learner()
        first, update_ms = _record_first(learner, lambda: {
            "params": learner.get_weights(),
            "target": cpu_snapshot(learner.target_params)})
        sync, syncs = learner.sync_target, []

        def checked_sync(tau=1.0):
            sync(tau)
            syncs.append(all(torch.equal(t, p) for t, p in zip(
                tree_leaves(learner.target_params),
                tree_leaves(learner.params))))

        learner.sync_target = checked_sync
        results, walls = [], []
        for _ in range(DQN_ITERS):
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
        algo.save_checkpoint(ckpt)
        fresh = DQN(config=cfg.copy().env_runners(num_env_runners=0))
        try:
            fresh.load_checkpoint(ckpt)
            got = fresh.learner_group.local_learner()
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(got.get_state()["target_params"]) +
                tree_leaves(got.get_weights()),
                tree_leaves(learner.get_state()["target_params"]) +
                tree_leaves(learner.get_weights())))
        finally:
            fresh.stop()
        action = algo.compute_single_action(np.zeros(4, np.float32))
    finally:
        algo.stop()
        shutil.rmtree(ckpt, ignore_errors=True)
    host = DQNLearner(algo._module_spec, cfg.learner_config_dict(),
                      device="cpu")
    host.set_weights(first["s0"]["params"])
    load_tree(host.target_params, first["s0"]["target"])
    want = host.update(first["batch"])
    want.pop("_batch_indexes")
    want_td = want.pop("_td_error")
    got = dict(first["metrics"])
    got.pop("_batch_indexes")
    td_err = _rel_max(torch.as_tensor(got.pop("_td_error")),
                      torch.as_tensor(want_td))
    m_err, p_err = _check_replay("34", got, want, first["s1"]["params"],
                                 host.get_weights(), first["s0"]["params"],
                                 "the first DQN update")
    steps = [r["env_steps_this_iter"] for r in results]
    log(f"[34] DQN on the numpy CartPole, learner on {sorted(devices)}, 2 "
        f"CPU env runners x 4 envs x 16 steps: build {t_build:.2f} s; per "
        f"iteration: wall {[round(w, 3) for w in walls]} s, env steps "
        f"{steps}, td_error_mean "
        f"{[round(r.get('td_error_mean', float('nan')), 4) for r in results]}"
        f"; {len(update_ms)} learner updates (batch 64) "
        f"{[round(m, 2) for m in update_ms]} ms; the first update on a CPU "
        f"DQNLearner: largest metric difference {m_err:.2e} (tol "
        f"{TOL_PPO:g}), td errors {td_err:.2e}, params {p_err:.2e} of the "
        f"update (tol {TOL_PPO_UPDATE:g}); target syncs {len(syncs)}, equal "
        f"to the online net {syncs}; checkpoint round trip equal: {same}; "
        f"compute_single_action {action}; {card}")
    # learning starts once the replay holds 256 valid steps (the runners'
    # autoreset steps are not stored): 2 updates an iteration from then on
    learned = sum("td_error_mean" in r for r in results)
    if steps != [128] * DQN_ITERS or learned < 2 or \
            len(update_ms) != 2 * learned:
        raise AssertionError(f"[34] env steps {steps}, {len(update_ms)} "
                             f"updates in {learned} iterations")
    if td_err > TOL_PPO:
        raise AssertionError(f"[34] td errors differ by {td_err}")
    if not syncs or not all(syncs):
        raise AssertionError(f"[34] target syncs {syncs}")
    if not same:
        raise AssertionError("[34] the checkpoint did not restore the "
                             "weights and the target net")
    if int(action) not in (0, 1):
        raise AssertionError(f"[34] compute_single_action gave {action}")
    return {"walls": walls, "update_ms": update_ms}


def _fixed_batch_replay(tag, name, learner_cls, spec, lcfg, batch, n):
    """``n`` updates of ``learner_cls`` on ``batch`` on the card and on the
    CPU from the card's weights and target net, the CPU fed the card's
    draws: (largest metric error, params error, the card's update ms)."""
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import load_tree

    card_l = learner_cls(spec, dict(lcfg), device=_rl_learner_device())
    host = learner_cls(spec, dict(lcfg), device="cpu")
    w0 = card_l.get_weights()
    host.set_weights(w0)
    load_tree(host.target_params, card_l.get_state()["target_params"])
    errs, ms = [], []
    for _ in range(n):
        draws = card_l._draws(len(batch["obs"]))
        got, t = _timed(lambda: card_l.update(batch, draws=draws))
        want = host.update(batch, draws={k: v.cpu()
                                         for k, v in draws.items()})
        ms.append(t)
        errs.append(max(_rel_err(got[k], v) for k, v in want.items()))
    p_err = _moved_update_err(card_l.get_weights(), host.get_weights(), w0)
    if max(errs) > TOL_PPO or p_err > TOL_PPO_UPDATE:
        raise AssertionError(f"[{tag}] {name} on the card disagrees with the "
                             f"CPU: metrics {errs}, params {p_err}")
    return max(errs), p_err, ms


def phase_rl_sac(card):
    """Phase 35: SAC (twin Q, auto-tuned alpha, polyak targets; the
    default (256, 256) towers) with the learner on the card and 2 CPU env
    runners of 4 numpy Pendulums, 16 steps a fragment; 128 env steps an
    iteration, learning once 256 valid steps are stored, then one update
    of batch 128 an iteration; 4 iterations. The first update replayed on
    a CPU ``SACLearner`` from the same weights and target critics with the
    card's draws (metrics within TOL_PPO, params within TOL_PPO_UPDATE);
    then, on a batch of 256 from SAC's replay buffer, two TD3 updates (the
    second steps the delayed actor) and one CQL update on the card against
    the CPU with the same draws; no runner touches CUDA."""
    from ray_tpu_torch.rllib import CQLConfig, SACConfig, TD3Config
    from ray_tpu_torch.rllib.algorithms.cql.cql import CQLLearner
    from ray_tpu_torch.rllib.algorithms.ddpg.ddpg import (
        DDPGLearner, DDPGModuleSpec)
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import load_tree
    from ray_tpu_torch.rllib.algorithms.sac.sac import SACLearner
    from ray_tpu_torch.rllib.core.learner import cpu_snapshot

    cfg = (SACConfig()
           .environment(_Pendulum)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=16)
           .training(train_batch_size=128,
                     num_steps_sampled_before_learning_starts=256)
           .learners(device=_rl_learner_device())
           .debugging(seed=0))
    t0 = time.perf_counter()
    algo = cfg.build()
    t_build = time.perf_counter() - t0
    try:
        devices, _ = _rl_runner_check("35", algo)
        learner = algo.learner_group.local_learner()
        first, update_ms = _record_first(learner, lambda: {
            "params": learner.get_weights(),
            "target": cpu_snapshot(learner.target_params)}, draws="_draws")
        results, walls = [], []
        for _ in range(SAC_ITERS):
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
        fixed = algo.replay.sample(256)
    finally:
        algo.stop()
    spec = algo._module_spec
    host = SACLearner(spec, cfg.learner_config_dict(), device="cpu")
    host.set_weights(first["s0"]["params"])
    load_tree(host.target_params, first["s0"]["target"])
    want = host.update(first["batch"], draws=first["draws"])
    m_err, p_err = _check_replay("35", first["metrics"], want,
                                 first["s1"]["params"], host.get_weights(),
                                 first["s0"]["params"],
                                 "the first SAC update")
    td3 = TD3Config()
    td3_spec = DDPGModuleSpec(obs_dim=spec.obs_dim,
                              action_dim=spec.action_dim)
    td3_m, td3_p, td3_ms = _fixed_batch_replay(
        "35", "TD3", DDPGLearner, td3_spec, td3.learner_config_dict(),
        fixed, 2)
    cql = CQLConfig()
    cql_m, cql_p, cql_ms = _fixed_batch_replay(
        "35", "CQL", CQLLearner, spec, cql.learner_config_dict(), fixed, 1)
    steps = [r["env_steps_this_iter"] for r in results]
    log(f"[35] SAC on the numpy Pendulum, learner on {sorted(devices)}, 2 "
        f"CPU env runners x 4 envs x 16 steps: build {t_build:.2f} s; per "
        f"iteration: wall {[round(w, 3) for w in walls]} s, env steps "
        f"{steps}, critic_loss "
        f"{[round(r.get('critic_loss', float('nan')), 4) for r in results]},"
        f" alpha {[round(r.get('alpha', float('nan')), 5) for r in results]}"
        f"; {len(update_ms)} learner updates (batch 128) "
        f"{[round(m, 2) for m in update_ms]} ms; the first update on a CPU "
        f"SACLearner with the card's draws: largest metric difference "
        f"{m_err:.2e} (tol {TOL_PPO:g}), params {p_err:.2e} of the update "
        f"(tol {TOL_PPO_UPDATE:g}); on a fixed batch of 256: TD3 x 2 "
        f"{[round(m, 2) for m in td3_ms]} ms, metrics {td3_m:.2e}, params "
        f"{td3_p:.2e}; CQL {[round(m, 2) for m in cql_ms]} ms, metrics "
        f"{cql_m:.2e}, params {cql_p:.2e}; {card}")
    learned = sum("critic_loss" in r for r in results)
    if steps != [128] * SAC_ITERS or learned < 2 or \
            len(update_ms) != learned:
        raise AssertionError(f"[35] env steps {steps}, {len(update_ms)} "
                             f"updates in {learned} iterations")
    return {"walls": walls, "update_ms": update_ms, "td3_ms": td3_ms,
            "cql_ms": cql_ms}


# phases 36-38: RLlib's last seven families. The chip machine has no
# gymnasium: the envs are numpy, their spaces read by duck typing
class _Chain:
    """``tests/test_rllib_breadth.py``'s ChainEnv in numpy: a corridor of 8
    cells from the left end, +1 for reaching the right end (terminated), a
    cost of 0.01 a step, 24 steps truncate; ``get_state`` / ``set_state``
    so that AlphaZero's search can use it as its own model."""

    N = 8
    MAX_STEPS = 24

    def __init__(self, config=None):
        self.observation_space = types.SimpleNamespace(
            low=np.zeros(self.N, np.float32), high=np.ones(self.N,
                                                           np.float32),
            shape=(self.N,), dtype=np.float32)
        self.action_space = types.SimpleNamespace(n=2)
        self._pos = 0
        self._t = 0

    def _obs(self):
        obs = np.zeros(self.N, np.float32)
        obs[self._pos] = 1.0
        return obs

    def reset(self, *, seed=None, options=None):
        self._pos, self._t = 0, 0
        return self._obs(), {}

    def step(self, action):
        self._t += 1
        self._pos = min(max(self._pos + (1 if action == 1 else -1), 0),
                        self.N - 1)
        done = self._pos == self.N - 1
        trunc = self._t >= self.MAX_STEPS
        reward = 1.0 if done else -0.01
        return self._obs(), reward, done, trunc, {}

    def get_state(self):
        return (self._pos, self._t)

    def set_state(self, state):
        self._pos, self._t = state

    def close(self):
        pass


class _CoordGame(MultiAgentEnv):
    """``tests/test_rllib_qmix_models.py``'s CoordGame in numpy: two agents,
    3 actions, one step; both picking 2 pays 10, both picking 0 pays 4,
    any mismatch 0."""

    possible_agents = ["a0", "a1"]

    def __init__(self, config=None):
        self._obs_space = types.SimpleNamespace(
            low=np.zeros(2, np.float32), high=np.ones(2, np.float32),
            shape=(2,), dtype=np.float32)
        self._act_space = types.SimpleNamespace(n=3)

    @property
    def observation_spaces(self):
        return {a: self._obs_space for a in self.possible_agents}

    @property
    def action_spaces(self):
        return {a: self._act_space for a in self.possible_agents}

    def reset(self, *, seed=None):
        obs = np.asarray([1.0, 0.0], np.float32)
        return {a: obs.copy() for a in self.possible_agents}, {}

    def step(self, action_dict):
        a0, a1 = action_dict["a0"], action_dict["a1"]
        team = 10.0 if a0 == a1 == 2 else 4.0 if a0 == a1 == 0 else 0.0
        obs = {a: np.asarray([0.0, 1.0], np.float32)
               for a in self.possible_agents}
        rewards = {a: team / 2 for a in self.possible_agents}
        return (obs, rewards, {"__all__": True, "a0": True, "a1": True},
                {"__all__": False}, {})


class _CoopTarget(MultiAgentEnv):
    """``tests/test_rllib_maddpg_bandit.py``'s CoopTargetEnv in numpy: two
    agents each see a private target in [-1, 1]^2 and act in [-1, 1]; the
    team reward is -sum((a_i - target_i)^2) a step, 8 steps truncate."""

    HORIZON = 8
    possible_agents = ["a0", "a1"]

    def __init__(self, config=None):
        self._box = types.SimpleNamespace(
            low=-np.ones(2, np.float32), high=np.ones(2, np.float32),
            shape=(2,), dtype=np.float32)
        self._act = types.SimpleNamespace(
            low=-np.ones(1, np.float32), high=np.ones(1, np.float32),
            shape=(1,), dtype=np.float32)
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._obs = {}

    @property
    def observation_spaces(self):
        return {a: self._box for a in self.possible_agents}

    @property
    def action_spaces(self):
        return {a: self._act for a in self.possible_agents}

    def _sample_obs(self):
        return {a: self._rng.uniform(-1, 1, 2).astype(np.float32)
                for a in self.possible_agents}

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = 0
        self._obs = self._sample_obs()
        return self._obs, {}

    def step(self, action_dict):
        self._t += 1
        err = sum((float(np.asarray(action_dict[a]).reshape(-1)[0])
                   - (0.7 * self._obs[a][0] - 0.4 * self._obs[a][1])) ** 2
                  for a in self.possible_agents)
        self._obs = self._sample_obs()
        done = self._t >= self.HORIZON
        rewards = {a: -err / 2 for a in self.possible_agents}
        terms = {a: False for a in self.possible_agents}
        terms["__all__"] = False
        truncs = {a: done for a in self.possible_agents}
        truncs["__all__"] = done
        return self._obs, rewards, terms, truncs, {}


class _ContextBandit:
    """``tests/test_rllib_maddpg_bandit.py``'s ContextBanditEnv in numpy: 5
    arms, a context uniform in [-1, 1]^4 a pull, reward ctx . theta_arm +
    N(0, 0.05) noise, one-step episodes."""

    def __init__(self, config=None):
        self.observation_space = types.SimpleNamespace(
            low=-np.ones(4, np.float32), high=np.ones(4, np.float32),
            shape=(4,), dtype=np.float32)
        self.action_space = types.SimpleNamespace(n=5)
        self._thetas = np.random.default_rng(7).normal(0, 0.5, (5, 4))
        self._rng = np.random.default_rng(0)
        self._ctx = np.zeros(4, np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = self._rng.uniform(-1, 1, 4).astype(np.float32)
        return self._ctx, {}

    def step(self, action):
        mean = float(self._thetas[int(action)] @ self._ctx)
        return (self._ctx, mean + float(self._rng.normal(0, 0.05)), True,
                False, {})

    def close(self):
        pass


DREAMER_ITERS = 3     # phase 36: 4 sequences an iteration; the buffer
#                       needs 8, so iterations 2 and 3 run 32 updates each
TOL_DREAMER_REL = 1e-4  # one update's metrics, card against CPU: a chain
#                         of 26 fp32 steps (the CPU test's tolerance)
QMIX_ITERS, MADDPG_ITERS, AZ_ITERS = 3, 4, 1   # phase 37
BANDIT_ITERS = 2      # phase 38: 64 pulls an iteration


def _state_equal(a, b):
    """Two state trees equal leaf for leaf (tensors bit for bit)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _update_profile(fn):
    """(kernel launches, device ms) of one call of ``fn`` from
    torch.profiler: (None, None) off the card."""
    if DEVICE != "cuda":
        fn()
        return None, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches, device_ms = 0, 0.0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        launches += e.count
        device_ms += e.self_device_time_total / 1e3
    if device_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    return launches, device_ms


def phase_rl_dreamer(card):
    """Phase 36: DreamerV3 at the reference's defaults (deter 128, 8 x 8
    latents, hidden 128, 41 bins, horizon 10, batch 8 x 16, train_ratio
    64) with the learner on the card and 1 CPU env runner of 4 numpy
    ``_Chain``s, 16 steps a fragment; 3 iterations, the last two of 32
    updates each (the buffer holds 8 sequences from iteration 2). Every
    update timed with CUDA events; one more profiled for its kernel
    launches and device time. The first update replayed on a CPU
    ``DreamerLearner`` from the card's state before it, with its batch and
    its Gumbel draws: metrics within TOL_DREAMER_REL, params and slow
    critic within TOL_PPO_UPDATE of their update, the return scale within
    TOL_DREAMER_REL. The return scale after the run equals the last
    update's metric, the slow critic differs from the critic, and a
    checkpoint loaded into a fresh ``DreamerV3`` restores the learner's
    whole state; no runner touches CUDA."""
    import shutil
    import tempfile

    from ray_tpu_torch.rllib import DreamerV3, DreamerV3Config
    from ray_tpu_torch.rllib.algorithms.dreamerv3.dreamerv3 import (
        DreamerLearner)

    cfg = (DreamerV3Config()
           .environment(_Chain)
           .env_runners(num_env_runners=1, num_envs_per_env_runner=4,
                        rollout_fragment_length=16)
           .learners(device=_rl_learner_device())
           .debugging(seed=0))
    t0 = time.perf_counter()
    algo = cfg.build()
    t_build = time.perf_counter() - t0
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_dreamer_")
    try:
        devices, _ = _rl_runner_check("36", algo)
        learner = algo.learner_group.local_learner()
        update = learner.update
        first, update_ms = _record_first(learner, learner.get_state,
                                         draws="draws")
        results, walls = [], []
        for _ in range(DREAMER_ITERS):
            t0 = time.perf_counter()
            results.append(algo.train())
            walls.append(time.perf_counter() - t0)
        last_scale = results[-1]["return_scale"]
        scale = float(learner.ret_scale)
        slow_moved = not _state_equal(learner.slow_critic,
                                      learner.params["critic"])
        launches, device_ms = _update_profile(
            lambda: update(first["batch"]))
        algo.save_checkpoint(ckpt)
        fresh = DreamerV3(config=cfg.copy().env_runners(num_env_runners=0))
        try:
            fresh.load_checkpoint(ckpt)
            same = _state_equal(
                fresh.learner_group.local_learner().get_state(),
                learner.get_state())
        finally:
            fresh.stop()
    finally:
        algo.stop()
        shutil.rmtree(ckpt, ignore_errors=True)
    host = DreamerLearner(algo._module_spec, cfg.learner_config_dict(),
                          device="cpu")
    host.set_state(first["s0"])
    want = host.update(first["batch"], draws=first["draws"])
    s1 = first["s1"]
    m_err, p_err = _check_replay(
        "36", first["metrics"], want, s1["params"], host.get_weights(),
        first["s0"]["params"], "the first DreamerV3 update",
        tol=TOL_DREAMER_REL)
    slow_err = _moved_update_err(s1["slow_critic"],
                                 host.get_state()["slow_critic"],
                                 first["s0"]["slow_critic"])
    scale_err = _rel_err(float(s1["ret_scale"]), float(host.ret_scale))
    med = statistics.median(update_ms)
    busy = None if device_ms is None else device_ms / med
    steps = [r["env_steps_this_iter"] for r in results]
    n_upd = [r.get("updates_this_iter", 0) for r in results]
    log(f"[36] DreamerV3 (deter 128, 8x8 latents, hidden 128, horizon 10, "
        f"batch 8x16, train_ratio 64) on the numpy chain, learner on "
        f"{sorted(devices)}, 1 CPU env runner x 4 envs x 16 steps: build "
        f"{t_build:.2f} s; per iteration: wall {[round(w, 3) for w in walls]}"
        f" s, env steps {steps}, updates {n_upd}; {len(update_ms)} updates: "
        f"median {med:.2f} ms, min {min(update_ms):.2f}, max "
        f"{max(update_ms):.2f} (CUDA events); one update profiled: "
        f"{launches} kernel launches, {device_ms} ms of kernels, busy "
        f"{busy if busy is None else round(busy, 4)} of the median update; "
        f"wm_loss {[round(r.get('wm_loss', float('nan')), 4) for r in results]}"
        f"; the first update on a CPU DreamerLearner with the card's draws: "
        f"largest metric difference {m_err:.2e} (tol {TOL_DREAMER_REL:g}), "
        f"params {p_err:.2e} and slow critic {slow_err:.2e} of the update "
        f"(tol {TOL_PPO_UPDATE:g}), return scale {scale_err:.2e}; return "
        f"scale {scale:.6g} (last metric {last_scale:.6g}); checkpoint round "
        f"trip equal: {same}; {card}")
    if steps != [64] * DREAMER_ITERS or n_upd != [0] + [32] * (
            DREAMER_ITERS - 1) or len(update_ms) != 32 * (DREAMER_ITERS - 1):
        raise AssertionError(f"[36] env steps {steps}, updates {n_upd}, "
                             f"{len(update_ms)} timed")
    if slow_err > TOL_PPO_UPDATE or scale_err > TOL_DREAMER_REL:
        raise AssertionError(f"[36] the card's update disagrees with the "
                             f"CPU's: slow critic {slow_err}, return scale "
                             f"{scale_err}")
    if scale == 1.0 or abs(scale - last_scale) > 1e-6 * abs(scale) or \
            not slow_moved or not same:
        raise AssertionError(f"[36] return scale {scale} (metric "
                             f"{last_scale}), slow critic moved "
                             f"{slow_moved}, checkpoint equal {same}")
    return {"walls": walls, "update_ms": update_ms, "launches": launches,
            "device_ms": device_ms, "busy": busy}


def _cpu_twin_update(tag, what, twin, load, first, params_of):
    """``first``'s update replayed on ``twin`` (a CPU copy of the
    algorithm or learner), loaded by ``load(twin, first["s0"])``: (metric
    error, params error), raising beyond TOL_PPO and TOL_PPO_UPDATE."""
    load(twin, first["s0"])
    want = twin.update(first["batch"])
    return _check_replay(tag, first["metrics"], want, first["s1"]["params"],
                         params_of(twin), first["s0"]["params"],
                         f"the first {what} update")


def phase_rl_multi_az(card):
    """Phase 37: QMIX (mixing embed 32, hidden 64) on the numpy
    ``_CoordGame`` and MADDPG (hidden 64) on the numpy ``_CoopTarget``,
    their params, targets and Adam state on the card, collecting in the
    driver (128 steps an iteration) until learning starts (200 and 300
    stored steps) and then 4 updates an iteration; and AlphaZero (50
    simulations a move) with its learner on the card and 2 CPU self-play
    workers on ``_Chain``, 1 iteration of 8 SGD steps. For each family the
    first update replayed on a CPU twin from the card's state before it,
    with its batch: metrics within TOL_PPO, params within TOL_PPO_UPDATE
    of the update; every update timed with CUDA events."""
    from ray_tpu_torch.rllib import (
        MADDPG, QMIX, AlphaZeroConfig, MADDPGConfig, QMIXConfig)
    from ray_tpu_torch.rllib.algorithms.alpha_zero.alpha_zero import (
        AlphaZeroLearner)
    from ray_tpu_torch.rllib.algorithms.dqn.dqn import load_tree
    from ray_tpu_torch.rllib.core.learner import cpu_snapshot

    out = {}
    # ---- QMIX
    qcfg = QMIXConfig().environment(_CoordGame).learners(
        device=_rl_learner_device()).debugging(seed=0)
    qmix = qcfg.build()
    first, q_ms = _record_first(qmix, lambda: {
        "params": cpu_snapshot(qmix.params),
        "target": cpu_snapshot(qmix.target_params),
        "opt": cpu_snapshot(qmix.opt.state_dict())})
    t0 = time.perf_counter()
    q_res = [qmix.train() for _ in range(QMIX_ITERS)]
    q_wall = time.perf_counter() - t0
    q_dev = {str(p.device) for p in tree_leaves(qmix.params)}
    qmix.stop()

    def load_qmix(twin, s):
        load_tree(twin.params, s["params"])
        load_tree(twin.target_params, s["target"])
        twin.opt.load_state_dict(s["opt"])

    q_m, q_p = _cpu_twin_update(
        "37", "QMIX", QMIX(qcfg.copy().learners(device="cpu")), load_qmix,
        first, lambda t: cpu_snapshot(t.params))
    # ---- MADDPG
    mcfg = MADDPGConfig().environment(_CoopTarget).learners(
        device=_rl_learner_device()).debugging(seed=0)
    maddpg = mcfg.build()
    first, m_ms = _record_first(maddpg, lambda: {
        "params": cpu_snapshot(maddpg.params),
        "target": cpu_snapshot(maddpg.target_params),
        "opt_a": cpu_snapshot(maddpg.opt_actor.state_dict()),
        "opt_c": cpu_snapshot(maddpg.opt_critic.state_dict())})
    t0 = time.perf_counter()
    m_res = [maddpg.train() for _ in range(MADDPG_ITERS)]
    m_wall = time.perf_counter() - t0
    m_dev = {str(p.device) for p in tree_leaves(maddpg.params)}
    maddpg.stop()

    def load_maddpg(twin, s):
        load_tree(twin.params, s["params"])
        load_tree(twin.target_params, s["target"])
        twin.opt_actor.load_state_dict(s["opt_a"])
        twin.opt_critic.load_state_dict(s["opt_c"])

    m_m, m_p = _cpu_twin_update(
        "37", "MADDPG", MADDPG(mcfg.copy().learners(device="cpu")),
        load_maddpg, first, lambda t: cpu_snapshot(t.params))
    # ---- AlphaZero
    acfg = (AlphaZeroConfig().environment(_Chain)
            .env_runners(num_env_runners=2)
            .learners(device=_rl_learner_device()).debugging(seed=0))
    t0 = time.perf_counter()
    az = acfg.build()
    a_build = time.perf_counter() - t0
    try:
        first, a_ms = _record_first(az.learner, az.learner.get_state)
        t0 = time.perf_counter()
        a_res = [az.train() for _ in range(AZ_ITERS)]
        a_wall = time.perf_counter() - t0
        a_dev = {str(p.device) for p in tree_leaves(az.learner.params)}
        action = az.compute_single_action(_Chain()._obs())
    finally:
        az.stop()
    a_m, a_p = _cpu_twin_update(
        "37", "AlphaZero", AlphaZeroLearner(
            az._module_spec, {"lr": acfg.lr, "seed": acfg.seed,
                              "vf_coeff": acfg.vf_coeff}, device="cpu"),
        lambda t, s: t.set_state(s), first, lambda t: t.get_weights())
    want_dev = {"cuda:0" if DEVICE == "cuda" else "cpu"}
    q_learned = sum("qmix_loss" in r for r in q_res)
    m_learned = sum("critic_loss" in r for r in m_res)
    for name, ms in (("QMIX", q_ms), ("MADDPG", m_ms), ("AlphaZero", a_ms)):
        out[name] = ms
    log(f"[37] QMIX on the numpy CoordGame, params on {sorted(q_dev)}: "
        f"{QMIX_ITERS} iterations {q_wall:.2f} s, {len(q_ms)} updates "
        f"(batch 64) median {statistics.median(q_ms):.2f} ms, min "
        f"{min(q_ms):.2f}, max {max(q_ms):.2f}; the first on a CPU twin: "
        f"metrics {q_m:.2e}, params {q_p:.2e}; {card}")
    log(f"[37] MADDPG on the numpy CoopTarget, params on {sorted(m_dev)}: "
        f"{MADDPG_ITERS} iterations {m_wall:.2f} s, {len(m_ms)} updates "
        f"(batch 128) median {statistics.median(m_ms):.2f} ms, min "
        f"{min(m_ms):.2f}, max {max(m_ms):.2f}; the first on a CPU twin: "
        f"metrics {m_m:.2e}, params {m_p:.2e}; {card}")
    log(f"[37] AlphaZero (50 simulations) on the numpy chain, learner on "
        f"{sorted(a_dev)}, 2 CPU self-play workers: build {a_build:.2f} s, "
        f"iterations {AZ_ITERS} in {a_wall:.2f} s, env steps "
        f"{[r['env_steps_this_iter'] for r in a_res]}, {len(a_ms)} updates "
        f"median {statistics.median(a_ms):.2f} ms, min {min(a_ms):.2f}, max "
        f"{max(a_ms):.2f}; the first on a CPU AlphaZeroLearner: metrics "
        f"{a_m:.2e}, params {a_p:.2e}; compute_single_action {action}; "
        f"{card}")
    if q_dev != want_dev or m_dev != want_dev or a_dev != want_dev:
        raise AssertionError(f"[37] params on {q_dev}, {m_dev}, {a_dev}")
    if q_learned != QMIX_ITERS - 1 or len(q_ms) != 4 * q_learned or \
            m_learned != MADDPG_ITERS - 2 or len(m_ms) != 4 * m_learned or \
            len(a_ms) != 8 * AZ_ITERS:
        raise AssertionError(f"[37] updates: QMIX {len(q_ms)} in "
                             f"{q_learned} iterations, MADDPG {len(m_ms)} "
                             f"in {m_learned}, AlphaZero {len(a_ms)}")
    if int(action) not in (0, 1):
        raise AssertionError(f"[37] compute_single_action gave {action}")
    return out


def phase_rl_bandit_es(card):
    """Phase 38: LinUCB and LinTS with ``A`` and ``b`` on the card, 2
    iterations of 64 pulls on the numpy ``_ContextBandit``, each against a
    CPU twin fed the same contexts (the same seed) and, for LinTS, the
    card's normal draws: the same arms pull for pull, ``A`` and ``b``
    within 1e-5 relative. Then ES and ARS at the reference's population
    (16 antithetic pairs; a candidate's fragment cut from 512 steps x 4
    envs to 48 x 2) one iteration each on 2 CPU env runners on
    ``_Chain``: exact env-step counts, theta
    moved, ARS's filter counting every observation. Nothing of ES or ARS
    runs on the card: their params live in the driver, the driver makes
    no allocation on the card while they run, and no runner touches
    CUDA."""
    import ray_tpu_torch
    from ray_tpu_torch.rllib import (
        ARSConfig, BanditLinTSConfig, BanditLinUCBConfig, ESConfig)

    out = {}
    for kind, cfg_cls in (("LinUCB", BanditLinUCBConfig),
                          ("LinTS", BanditLinTSConfig)):
        runs = []
        drawn = []
        for twin, dev in ((False, _rl_learner_device()), (True, "cpu")):
            algo = cfg_cls().environment(_ContextBandit).learners(
                device=dev).build()
            arms, step = [], algo._env.step

            def recorded(action, _arms=arms, _step=step):
                _arms.append(int(action))
                return _step(action)

            algo._env.step = recorded
            if kind == "LinTS":
                if twin:
                    algo._draws = lambda: drawn.pop(0)
                else:
                    make = algo._draws

                    def kept(_make=make):
                        d = _make()
                        drawn.append(d.cpu())
                        return d

                    algo._draws = kept
            t0 = time.perf_counter()
            res = [algo.train() for _ in range(BANDIT_ITERS)]
            wall = time.perf_counter() - t0
            runs.append((arms, algo.state.A.cpu(), algo.state.b.cpu(), wall,
                         res[-1]["episode_return_mean"],
                         str(algo.state.A.device)))
            algo.stop()
        (arms, A, b, wall, ret, a_dev), (h_arms, hA, hb, _, _, _) = runs
        a_err, b_err = _rel_max(A, hA), _rel_max(b, hb)
        log(f"[38] {kind}, A and b on {a_dev}: {BANDIT_ITERS} iterations "
            f"of 64 pulls {wall:.3f} s ({wall / (64 * BANDIT_ITERS) * 1e3:.2f}"
            f" ms a pull), mean reward {ret:.4f}; against the CPU twin: arms "
            f"equal {arms == h_arms} ({len(set(arms))} distinct), A "
            f"{a_err:.2e}, b {b_err:.2e} (tol 1e-5); {card}")
        if arms != h_arms or len(arms) != 64 * BANDIT_ITERS or \
                a_err > 1e-5 or b_err > 1e-5 or drawn:
            raise AssertionError(f"[38] {kind} on the card disagrees with the"
                                 f" CPU: arms {arms == h_arms}, A {a_err}, b "
                                 f"{b_err}, draws left {len(drawn)}")
        out[kind] = wall
    def card_allocations():
        # allocations made on the card so far (a count that only grows:
        # memory freed meanwhile by the collector leaves it as it is)
        return (torch.cuda.memory_stats().get("allocation.all.allocated", 0)
                if DEVICE == "cuda" else 0)

    allocs0 = card_allocations()
    for name, cfg in (("ES", ESConfig()), ("ARS", ARSConfig())):
        # the reference's population; each candidate's fragment cut from
        # 512 steps x 4 envs to the reference test's 48 x 2 on this
        # corridor (episodes of at most 24 steps): the phase's time is the
        # runners' CPU stepping
        cfg = cfg.environment(_Chain).env_runners(
            num_env_runners=2, num_envs_per_env_runner=2,
            rollout_fragment_length=48).debugging(seed=0)
        t0 = time.perf_counter()
        algo = cfg.build()
        t_build = time.perf_counter() - t0
        try:
            theta0 = algo._theta.copy()
            t0 = time.perf_counter()
            r = algo.train()
            wall = time.perf_counter() - t0
            moved = float(np.linalg.norm(algo._theta - theta0))
            reports = ray_tpu_torch.get([w.device_report.remote()
                                         for w in algo.env_runners],
                                        timeout=60)
        finally:
            algo.stop()
        n_steps = 2 * cfg.pop_size * cfg.rollout_fragment_length * \
            cfg.num_envs_per_env_runner
        filt = r.get("filter_count")
        log(f"[38] {name} (population {2 * cfg.pop_size}, "
            f"{cfg.rollout_fragment_length} steps x "
            f"{cfg.num_envs_per_env_runner} envs a candidate) on 2 CPU env "
            f"runners: build {t_build:.2f} s, one iteration {wall:.2f} s, "
            f"env steps {r['env_steps_this_iter']}, fitness mean "
            f"{r['fitness_mean']:.4f} max {r['fitness_max']:.4f}, theta moved "
            f"{moved:.4f}, filter count {filt}; nothing of it runs on the card; "
            f"{card}")
        # every candidate alike (none reaches the corridor's end) gives ARS
        # no direction to step in; ES still decays theta by its l2 term
        still = name == "ARS" and r["fitness_max"] == r["fitness_mean"]
        if (r["env_steps_this_iter"] != n_steps
                or not (moved > 0 or still)
                or (name == "ARS" and filt != n_steps)
                or any(x["cuda_initialized"] for x in reports)):
            raise AssertionError(f"[38] {name}: {r}, moved {moved}, runners "
                                 f"{reports}")
        out[name] = wall
    allocs1 = card_allocations()
    log(f"[38] allocations on the card during ES and ARS: "
        f"{allocs1 - allocs0}")
    if allocs1 != allocs0:
        raise AssertionError(f"[38] ES/ARS allocated on the card: "
                             f"{allocs1 - allocs0} allocations")
    return out


def phase_rl(card):
    """Phases 32-38, in the session of phases 30-31, with this process's
    K1-K3 counts set to 0 before each group: RLlib's path launches none."""
    reset_counts()
    t0 = time.perf_counter()
    out = {"ppo": phase_rl_ppo(card)}
    t1 = time.perf_counter()
    out["appo"] = phase_rl_appo(card)
    t2 = time.perf_counter()
    log(f"[32-33] phase 32 {t1 - t0:.2f} s, phase 33 {t2 - t1:.2f} s; "
        f"K1/K2/K3 launches in this process: {counts()}; {card}")
    if counts() != (0, 0, 0):
        raise AssertionError(f"[32-33] RLlib's path launched {counts()}")
    reset_counts()
    t3 = time.perf_counter()
    out["dqn"] = phase_rl_dqn(card)
    t4 = time.perf_counter()
    out["sac"] = phase_rl_sac(card)
    t5 = time.perf_counter()
    log(f"[34-35] phase 34 {t4 - t3:.2f} s, phase 35 {t5 - t4:.2f} s; "
        f"K1/K2/K3 launches in this process: {counts()}; {card}")
    if counts() != (0, 0, 0):
        raise AssertionError(f"[34-35] RLlib's path launched {counts()}")
    reset_counts()
    t6 = time.perf_counter()
    out["dreamer"] = phase_rl_dreamer(card)
    t7 = time.perf_counter()
    out["multi_az"] = phase_rl_multi_az(card)
    t8 = time.perf_counter()
    out["bandit_es"] = phase_rl_bandit_es(card)
    t9 = time.perf_counter()
    log(f"[36-38] phase 36 {t7 - t6:.2f} s")
    log(f"[36-38] phase 37 {t8 - t7:.2f} s")
    log(f"[36-38] phase 38 {t9 - t8:.2f} s; K1/K2/K3 launches in this "
        f"process: {counts()}; {card}")
    if counts() != (0, 0, 0):
        raise AssertionError(f"[36-38] RLlib's path launched {counts()}")
    return out


RESUME_STEPS = 4       # phase 39: a fit's steps; the state is saved after 2
RESUME_SAVE_AT = 2
TRACE_S = 6.0          # phase 39: the trace's length
TRACE_KERNELS = ("flash_fwd_kernel_tc", "flash_dq_kernel_tc",
                 "flash_dkv_kernel_tc")


def phase_cluster_resume(card):
    """Phase 39 (see the module docstring): a two-node ``Cluster``, the
    bundle's half-GPU actors, a fit that saves a sharded checkpoint while
    the driver traces its worker, and a fit that resumes from it. Returns
    the (K1, K2, K3) launches of both fits' workers."""
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch._private import lifecycle
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.train import (
        FailureConfig, RunConfig, ScalingConfig, TorchConfig, TorchTrainer)
    from ray_tpu_torch.util import state as state_api
    from ray_tpu_torch.util.placement_group import (
        placement_group, remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)

    def resume_loop(config):
        """Phase 39's train loop, in the trainer's worker: phase 7's LoRA step
        on ``MeshConfig(data=-1)`` with ``attn_impl="flash"``, the frozen base
        drawn from seed 0 and the LoRA from seed 1 (or, when
        ``config["resume"]``, the state loaded with ``load_pytree_orbax``
        from ``config["ckpt"]``),
        up to RESUME_STEPS steps, each reported with its loss, grad norm, wall
        ms and K1-K3 launches and the whole history so far. The first fit saves
        the state with ``save_pytree_orbax`` after step ``config["save_at"]``,
        then tells the driver its worker id (``<sync>/ready``) and waits for
        the driver's trace to begin (``<sync>/go``) before the next steps, and
        for it to end (``<sync>/traced``) before it returns. Self-contained: it
        travels to the worker by value."""
        import dataclasses
        import os
        import pickle
        import time

        import torch

        import ray_tpu_torch
        from ray_tpu_torch import resolve_device, train
        from ray_tpu_torch.models.llama import (
            init_llama, init_lora, llama_logical_axes, llama_lora_loss,
            lora_logical_axes)
        from ray_tpu_torch.ops.cuda import _build
        from ray_tpu_torch.ops.cuda import flash_attention as fa
        from ray_tpu_torch.parallel import (
            MeshConfig, adamw, create_mesh, create_train_state,
            make_train_step, sharded_train_state_tree, train_state_from_tree)
        from ray_tpu_torch.train import load_pytree_orbax, save_pytree_orbax

        def wait_for(name, seconds=180):
            path = os.path.join(config["sync"], name)
            deadline = time.time() + seconds
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise TimeoutError(f"the driver never wrote {name}")
                time.sleep(0.01)

        t_start = time.time()
        dev = resolve_device(config["device"])
        on = dev.type == "cuda"
        for name in config["kernels"]:
            _build.load(name)
        cfg, lcfg, base_cfg = pickle.loads(config["cfgs"])
        cfg = dataclasses.replace(cfg, attn_impl="flash")
        mesh = create_mesh(MeshConfig(data=-1), device=dev)
        tok = torch.tensor(config["tokens"], device=dev)
        batch = {"inputs": tok[:, :-1], "targets": tok[:, 1:]}
        g = torch.Generator(device=dev).manual_seed(0)
        base = init_llama(dataclasses.replace(
            base_cfg, param_dtype=base_cfg.dtype), g, dev)
        tx = adamw(config["lr"])
        state = create_train_state(
            lambda gg: init_lora(cfg, lcfg, gg, gg.device), tx, mesh,
            lora_logical_axes(cfg, lcfg), device=dev, seed=1)
        step = make_train_step(
            lambda lo, b, fz: llama_lora_loss(fz, lo, b, cfg, lcfg), tx, mesh,
            batch_logical_axes=("batch", "seq"), frozen=base,
            frozen_logical_axes=llama_logical_axes(cfg))
        ctx = ray_tpu_torch.get_runtime_context()
        info = {"pid": os.getpid(), "node_id": ctx.get_node_id(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "t_start": t_start}
        if config["resume"]:
            t0 = time.perf_counter()
            loaded = load_pytree_orbax(config["ckpt"],
                                       sharded_train_state_tree(state))
            state = train_state_from_tree(loaded, state)
            del loaded
            if on:
                torch.cuda.synchronize()
            info["load_s"] = time.perf_counter() - t0
        hist = []
        while state.step < config["steps"]:
            if not config["resume"] and state.step == config["save_at"]:
                t0 = time.perf_counter()
                save_pytree_orbax(sharded_train_state_tree(state),
                                  config["ckpt"])
                info["save_s"] = time.perf_counter() - t0
                d = os.path.join(config["ckpt"], "dcp")
                info["ckpt_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                         for f in os.listdir(d))
                with open(os.path.join(config["sync"], "ready.tmp"), "w") as f:
                    f.write(ctx.get_worker_id())
                os.replace(os.path.join(config["sync"], "ready.tmp"),
                           os.path.join(config["sync"], "ready"))
                wait_for("go")
            before = (fa.launches, fa.dq_launches, fa.dkv_launches)
            if on:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss, gnorm = m["loss"].item(), m["grad_norm"].item()
            hist.append({"step": m["step"], "loss": loss,
                         "grad_norm": gnorm, "t": time.time(),
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "launches": [a - b for a, b in zip(
                             (fa.launches, fa.dq_launches, fa.dkv_launches),
                             before)]})
            train.report(dict(info, history=list(hist)))
        if not config["resume"]:
            wait_for("traced")

    t_phase = time.perf_counter()
    on_card = DEVICE == "cuda"
    base_cfg, cfg, lcfg = tune_setup()
    L = cfg.num_layers
    per_step = (2 * L, L, L) if on_card else (0, 0, 0)
    work = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    sync = os.path.join(work, "sync")
    os.makedirs(sync)
    common = {"cfgs": pickle.dumps((cfg, lcfg, base_cfg)),
              "tokens": train_tokens(cfg), "device": DEVICE, "lr": 1e-4,
              "kernels": TENSOR_CORE_LIBS if on_card else (),
              "steps": RESUME_STEPS, "save_at": RESUME_SAVE_AT,
              "ckpt": os.path.join(work, "ckpt"), "sync": sync}
    avail_before = _device_available() if on_card else 0
    cluster = Cluster(head_node_args={"num_cpus": 2, "num_gpus": 0})
    session_dir = cluster.session_dir
    procs, workers, box = [], {}, {}
    try:
        gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
        ray_tpu_torch.init(_node=cluster.head_node)
        cluster.wait_for_nodes()
        t_boot = time.perf_counter() - t_phase
        gpus = {n["node_id"]: n["resources_total"].get("GPU", 0)
                for n in state_api.list_nodes() if n["alive"]}
        want = {cluster.head_node.node_id: 0, gpu_node.node_id: 1}
        if gpus != want:
            raise AssertionError(f"[39] GPUs by node {gpus} != {want}")

        # two half-GPU actors in one whole-GPU bundle
        pg = placement_group([{"GPU": 1}])
        if not pg.wait(timeout_seconds=60):
            raise AssertionError("[39] the GPU bundle was not placed")

        @ray_tpu_torch.remote(num_cpus=0, num_gpus=0.5)
        class Half:
            def probe(self):
                import os

                import torch

                x = torch.arange(8, dtype=torch.float32,
                                 device="cuda:0" if on_card else "cpu")
                return {"node_id":
                        ray_tpu_torch.get_runtime_context().get_node_id(),
                        "pid": os.getpid(), "device": str(x.device),
                        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                        "sum": float(x.sum().item())}

        halves = [Half.options(scheduling_strategy=(
            PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=0))).remote()
            for _ in range(2)]
        seen = ray_tpu_torch.get([h.probe.remote() for h in halves],
                                 timeout=120)
        for h in halves:
            ray_tpu_torch.kill(h)
        remove_placement_group(pg)
        workers.update({f"half actor {i}": r["pid"]
                        for i, r in enumerate(seen)})
        by_node = [gpus[n.node_id] for n in (cluster.head_node, gpu_node)]
        probes = [(r["node_id"] == gpu_node.node_id, r["visible"],
                   r["device"], r["sum"]) for r in seen]
        log(f"[39] two-node Cluster up in {t_boot:.2f} s, GPUs by node "
            f"(head, second) {by_node}; 2 x {{'GPU': 0.5}} actors in one "
            f"{{'GPU': 1}} bundle (on the GPU node, CUDA_VISIBLE_DEVICES, "
            f"device, sum): {probes}")
        if any(r["node_id"] != gpu_node.node_id or r["visible"] != "0"
               or r["sum"] != 28.0 or (on_card and r["device"] != "cuda:0")
               for r in seen):
            raise AssertionError(f"[39] the half-GPU actors saw {seen}")

        def tracer():
            """Once the first fit's worker has saved: trace it for TRACE_S
            from a thread, and let it run steps 3-4 once the profiler has
            begun (the worker's ``*.profiling`` file stands in the trace
            dir)."""
            try:
                ready = os.path.join(sync, "ready")
                deadline = time.time() + 600
                while not os.path.exists(ready):
                    if time.time() > deadline or "fit_done" in box:
                        return
                    time.sleep(0.01)
                with open(ready) as f:
                    worker_id = f.read()

                trace_dir = os.path.join(work, "trace")

                def capture():
                    try:
                        box["trace"] = state_api.capture_torch_trace(
                            worker_id, duration_s=TRACE_S, out_dir=trace_dir)
                    except BaseException as e:  # noqa: BLE001
                        box["trace_error"] = e

                th = threading.Thread(target=capture, daemon=True)
                th.start()
                # a capture that fails before it begins ends the thread
                while th.is_alive() and not (
                        os.path.isdir(trace_dir) and any(
                            n.endswith(".profiling")
                            for n in os.listdir(trace_dir))):
                    time.sleep(0.01)
                box["trace_began"] = th.is_alive()
                open(os.path.join(sync, "go"), "w").close()
                th.join()
            finally:
                for name in ("go", "traced"):
                    open(os.path.join(sync, name), "w").close()

        fits = []
        for resume in (False, True):
            th = None if resume else threading.Thread(target=tracer,
                                                      daemon=True)
            if th is not None:
                th.start()
            storage = os.path.join(work, f"storage_{int(resume)}")
            t_fit = time.time()
            try:
                # a GPU worker also off the card (the node declares its
                # GPU), over gloo there: the placement is what is checked
                result = TorchTrainer(
                    resume_loop, train_loop_config=dict(common,
                                                        resume=resume),
                    torch_config=TorchConfig(
                        backend="nccl" if on_card else "gloo"),
                    scaling_config=ScalingConfig(num_workers=1,
                                                 use_gpu=True),
                    run_config=RunConfig(
                        name=f"resume_{int(resume)}", storage_path=storage,
                        failure_config=FailureConfig(max_failures=0))).fit()
            finally:
                box["fit_done"] = True
                if th is not None:
                    th.join(timeout=TRACE_S + 60)
            fit_s = time.time() - t_fit
            if result.error is not None or result.restarts != 0:
                raise AssertionError(f"[39] fit (resume={resume}): error "
                                     f"{result.error!r}, restarts "
                                     f"{result.restarts}")
            m = dict(result.metrics, fit_s=fit_s,
                     first_report_s=result.metrics["history"][0]["t"] - t_fit)
            workers[f"fit {int(resume)} worker"] = m["pid"]
            fits.append(m)
        procs = lifecycle.list_registered(session_dir)
        cluster.remove_node(gpu_node)
    except BaseException:
        _log_tail(session_dir, tag="39")
        raise
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()

    first, second = fits
    h1 = {h["step"]: h for h in first["history"]}
    h2 = {h["step"]: h for h in second["history"]}
    if sorted(h1) != list(range(1, RESUME_STEPS + 1)) or sorted(h2) != list(
            range(RESUME_SAVE_AT + 1, RESUME_STEPS + 1)):
        raise AssertionError(f"[39] steps {sorted(h1)} and {sorted(h2)}")
    errs = [abs(h2[s][k] - h1[s][k]) / abs(h1[s][k])
            for s in h2 for k in ("loss", "grad_norm")]
    bad = [(h["step"], h["launches"]) for h in (*h1.values(), *h2.values())
           if tuple(h["launches"]) != per_step]
    trace_counts, trace_file = {}, None
    if "trace" in box and "error" not in box["trace"]:
        trace_file = os.path.join(box["trace"]["trace_dir"],
                                  box["trace"]["files"][0])
        with open(trace_file) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        trace_counts = {k: sum(k in n for n in names) for k in TRACE_KERNELS}
        trace_counts["events"] = len(names)
    shutil.rmtree(work, ignore_errors=True)
    def pairs(h):
        return [(round(h[s]["loss"], 6), round(h[s]["grad_norm"], 6))
                for s in sorted(h)]

    every = (*h1.values(), *h2.values())
    log(f"[39] TorchTrainer on the second node (worker node is the GPU "
        f"node: {[f['node_id'] == gpu_node.node_id for f in fits]}, "
        f"CUDA_VISIBLE_DEVICES {[f['visible'] for f in fits]}), 7B widths "
        f"cut to {L} layers, B={TRAIN_B} S={TRAIN_S}, MeshConfig(data=-1), "
        f"attn_impl=flash: first fit (loss, grad_norm) {pairs(h1)}, ms/step "
        f"{[round(h1[s]['ms'], 1) for s in sorted(h1)]}; checkpoint after "
        f"step {RESUME_SAVE_AT}: {first['ckpt_bytes']} bytes, saved in "
        f"{first['save_s']:.3f} s; resumed fit loaded it in "
        f"{second['load_s']:.3f} s, steps 3-4 {pairs(h2)}: largest "
        f"relative difference from the first fit's {max(errs):.3e} (tol "
        f"{TOL_MESH_REL:g}); first report {first['first_report_s']:.2f} and "
        f"{second['first_report_s']:.2f} s after fit(), fits "
        f"{first['fit_s']:.2f} and {second['fit_s']:.2f} s; launches a step "
        f"{sorted({tuple(h['launches']) for h in every})}; {card}")
    log(f"[39] trace of the first fit's worker over steps 3-4 "
        f"(capture_torch_trace, {TRACE_S:g} s): "
        f"{trace_counts or box.get('trace') or box.get('trace_error')}")
    if any(f["node_id"] != gpu_node.node_id or f["visible"] != "0"
           for f in fits):
        raise AssertionError("[39] a fit's worker was not on the GPU node")
    if max(errs) > TOL_MESH_REL:
        raise AssertionError("[39] the resumed steps disagree with the "
                             "first fit's")
    if bad:
        raise AssertionError(f"[39] launches {bad} != {per_step} a step")
    if trace_file is None or not box.get("trace_began") or (
            on_card and not all(trace_counts[k] >= 1
                                for k in TRACE_KERNELS)):
        raise AssertionError(f"[39] the trace holds {trace_counts}: "
                             f"{box.get('trace') or box.get('trace_error')}")
    _check_session_gone("39", session_dir, procs, avail_before, workers)
    log(f"[39] phase 39 {time.perf_counter() - t_phase:.2f} s; {card}")
    return [sum(h["launches"][i] for h in every) for i in range(3)]


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
    trainer_launches, predictor_launches, phase19 = phase_train_runtime(
        gen, card, inproc_train)
    session = phase_mesh_runtime(
        gen, card, dict(inproc_train, device_ms=train_device_ms), phase19)
    mesh_launches = session["mesh"]
    trainer_data_launches = session["trainer_data"]
    dense_data = session["dense_data"]
    dense = phase_dense()
    log(f"[28] data-fed against resident batch, dense 1B B={DENSE_B} "
        f"S={DENSE_S}: {dense_data['tok_s']:.0f} against "
        f"{dense['tok_s']:.0f} tokens/s, MFU {dense_data['mfu']:.1%} against "
        f"{dense['mfu']:.1%}, busy {dense_data['busy']:.1%} (the timed "
        f"window) against {dense['busy']:.1%} (phase 10: a profiled step "
        f"over the timed steps' wall); {card}")
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
    tune_asha, tune_pbt, _ = phase_tune(card, in_session=phase_rl)
    resume_launches = phase_cluster_resume(card)

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
                     + pipe_launches[0] + trainer_data_launches[0]
                     + dense_data["launches"][0]
                     + session["batch_predictor"] + tune_asha[0]
                     + tune_pbt[0] + resume_launches[0]
                     + session["compiled_dag"] + session["ray_client"]),
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
                             "pipeline": pipe_launches[0],
                             "trainer_data": trainer_data_launches[0],
                             "dense_data": dense_data["launches"][0],
                             "batch_predictor": session["batch_predictor"],
                             "tune_asha": tune_asha[0],
                             "tune_pbt": tune_pbt[0],
                             "cluster_resume": resume_launches[0],
                             "compiled_dag": session["compiled_dag"],
                             "ray_client": session["ray_client"]},
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
             + ring_launches[i] + mesh_launches[i] + pipe_launches[i]
             + trainer_data_launches[i] + dense_data["launches"][i]
             + tune_asha[i] + tune_pbt[i] + resume_launches[i])
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
                                 "pipeline": pipe_launches[i],
                                 "trainer_data": trainer_data_launches[i],
                                 "dense_data": dense_data["launches"][i],
                                 "tune_asha": tune_asha[i],
                                 "tune_pbt": tune_pbt[i],
                                 "cluster_resume": resume_launches[i]},
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
