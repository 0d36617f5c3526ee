"""Tiny cells for the CPU tests: the real drivers, mixes shrunk to a test's
size, and limits set for these sizes from their own readings (program and
fp8 control, on the seeds below)."""

from benchmarks import harness

MAN = harness.load_json(harness.MANIFEST)

LLAMA = {"name": "tiny-llama", "architecture": "llama", "config": {
    "hidden_size": 128, "intermediate_size": 384, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 4096,
    "rope_theta": 1e4, "rms_norm_eps": 1e-5, "max_position_embeddings": 512,
    "torch_dtype": "bfloat16"}, "assumed": {"head_dim": 32}}

MOE = {"name": "tiny-moe", "architecture": "moe", "config": {
    "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
    "rope_theta": 1e6, "rms_norm_eps": 1e-5, "max_position_embeddings": 256,
    "torch_dtype": "bfloat16", "num_local_experts": 4,
    "num_experts_per_tok": 2, "router_aux_loss_coef": 0.02},
    "assumed": {"capacity_factor": 1.25}}

SERVE_MIX = {
    "driver": "serve", "clients": 4, "pool": 8,
    "prompt_len": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                   "min": 8, "max": 60},
    "output_len": {"dist": "uniform", "min": 6, "max": 12},
    "adapters": {"names": ["a0", "a1"], "zipf_s": 1.0},
    "serve": {"lora_rank": 2, "max_batch_size": 4,
              "allowed_batch_sizes": [1, 2, 4], "seq_bucket": 32,
              "max_new_tokens": 12, "max_adapters": 2,
              "max_ongoing_requests": 8, "max_queued_requests": 8},
    "window_opens_after": {"max_batch": 1, "steps": 2}, "trace_seconds": 1,
    "check": {"requests": 3, "drain_s": 60}}

SFT_MIX = {"driver": "train", "batch": 2, "seq": 32, "batches": 4,
           "optimizer": {"name": "adamw", "lr": 1e-3},
           "compared_steps": 3, "trace_seconds": 1}

# Limits for these sizes, from their own readings on seeds 1-7 and the
# tests' seed: the program's bfloat16 serve gap read at most 0.02, the fp8
# control's at least 0.08; in training (the MoE on the program's routing,
# B=2 and B=1) the program's grad gap at most 3.5e-3 and its routing
# disagreement 2.0%, the fp8 control's at least 1.4e-2 and 1.6%, a step on
# half the batch at least 0.40 and 100%. The loss and change gaps do not
# separate the control at these sizes and are held above the program's
# (3.4e-4, 2.1e-3).
SERVE_LIMITS = {"max_gap": {"limit": 0.04}}
SFT_LIMITS = {"loss_gap": {"limit": 8e-4}, "grad_gap": {"limit": 5e-3},
              "change_gap": {"limit": 8e-3}, "route1_disagree": {"limit": 0.03}}


def cell(name, conf, mix, limits):
    return harness.Cell(
        name=name, chips=1, config_name=conf["name"], config=conf,
        traffic_name=name, traffic=mix, driver=mix["driver"],
        end_to_end=[m for m in MAN["end_to_end"]
                    if m["name"] == "setup_s"
                    or m["name"].startswith(mix["driver"])],
        per_layer=[m for m in MAN["per_layer"]
                   if m["name"].endswith("." + mix["driver"])],
        limits=limits)
