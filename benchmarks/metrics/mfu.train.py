"""mfu.train: model FLOPs of the window's steps over its time x 989
TFLOP/s. A step's FLOPs, remat not counted: 6 x the weights a token meets
in products (the MoE's active weights) per token, plus attention's causal
score and value products, forward and backward (3 x the forward). In a
traced run, the steps after the trace stopped and their time."""

from benchmarks.flops import attn_fwd_flops_causal, moe_active_params
from benchmarks.harness import PEAK_FLOPS


def step_flops(r):
    c, B, S = r["sizes"], r["batch"], r["seq"]
    return (6.0 * moe_active_params(c) * B * S
            + 3.0 * B * attn_fwd_flops_causal(c, S))


def read(r):
    steps, seconds = r["steps"], r["window_s"]
    if r.get("trace"):
        steps, seconds = r["untraced"]["steps"], r["untraced"]["seconds"]
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * step_flops(r) * steps / (seconds * PEAK_FLOPS["bfloat16"])
