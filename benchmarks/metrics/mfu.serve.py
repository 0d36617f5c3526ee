"""mfu.serve: model FLOPs of the work the clients asked for and got in the
window (each prompt token and each output token once, at its causal
context; ``benchmarks.flops.serve_flops``) over window x 989 TFLOP/s."""

from benchmarks.flops import serve_flops
from benchmarks.harness import PEAK_FLOPS


def read(r):
    if not r["served"]:
        return None
    flops = serve_flops(r["sizes"], r["lora"]["rank"], r["lora"]["targets"],
                        r["served"])
    return 100.0 * flops / (r["window_s"] * PEAK_FLOPS["bfloat16"])
