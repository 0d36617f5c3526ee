# Copied from ray_tpu/devtools/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Developer-facing correctness tooling for the ray_tpu_torch runtime.

The runtime's kernel-layer analogs in the reference get their invariant
guarantees from C++ review and sanitizers (TSAN for the lock discipline,
ASAN for lifetime); this pure-Python runtime gets them from
``ray_tpu_torch.devtools.lint`` — an AST/CFG checker whose rules are distilled
from the repo's own shipped-bug history. See ``lint/rules/`` for the
catalog and README "Correctness tooling" for the workflow.
"""
