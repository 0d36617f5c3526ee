# Copied from ray_tpu/devtools/lint/__init__.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""raylint — AST/CFG invariant checker for the ray_tpu_torch runtime.

Eight rules distilled from the repo's shipped-bug history (each rule
module's docstring names the motivating incident):

- R1  GC-reentrancy: plain ``Lock`` reachable from ``__del__``/weakref
      callbacks (the MemoryStore driver-wide deadlock, PR 5).
- R2  blocking calls inside ``async def`` (event-loop stalls read as
      node death).
- R3  thread lock held across an ``await``.
- R4  fire-and-forget ``create_task``/``ensure_future`` (the leaked
      read-loop tasks, PRs 1/3).
- R5  cross-process exceptions must survive pickle with fields intact.
- R6  control RPCs must carry a timeout/retry budget (the watchdog
      wedge under one-way partitions, PR 5).
- R7  every ``Popen`` registers with the PR 1 pid registry (the daemon
      leaks that starved the MULTICHIP gate).
- R8  ``CONFIG.<flag>`` references must exist in config.py.

Run ``python -m ray_tpu_torch.devtools.lint ray_tpu_torch``; suppress a justified
site inline with ``# raylint: disable=Rn -- reason``; historical debt
lives in ``baseline.json`` which may only shrink. Enforced in tier-1 by
``tests/test_torch_raylint.py``.
"""

from .engine import default_baseline_path, discover_files, run_lint  # noqa: F401
from .model import LintResult, Violation  # noqa: F401
from .rules import rule_catalog  # noqa: F401

__all__ = ["run_lint", "discover_files", "default_baseline_path",
           "LintResult", "Violation", "rule_catalog"]
