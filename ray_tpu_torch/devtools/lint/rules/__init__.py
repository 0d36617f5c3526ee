# Copied from ray_tpu/devtools/lint/rules/__init__.py.
"""Rule registry.

Each rule module exposes ``RULE_ID``, ``SUMMARY`` and
``check(index) -> List[Violation]`` (project-wide rules) or
``check_module(mod, index) -> List[Violation]`` (per-file rules). The
engine runs whichever is defined. Every rule encodes an invariant the
repo has already paid for violating — the docstring of each module names
the motivating PR.
"""

from __future__ import annotations

from typing import Dict, List

from . import (
    r1_gc_reentrancy,
    r2_blocking_in_async,
    r3_lock_across_await,
    r4_task_leak,
    r5_exception_pickle,
    r6_unbounded_rpc,
    r7_untracked_spawn,
    r8_config_knobs,
    r9_view_escape,
    r10_grow_only,
    r11_loop_stop_strands_client,
    r12_lock_order,
    r13_thread_affinity,
    r14_wire_contract,
)

ALL_RULES = [
    r1_gc_reentrancy,
    r2_blocking_in_async,
    r3_lock_across_await,
    r4_task_leak,
    r5_exception_pickle,
    r6_unbounded_rpc,
    r7_untracked_spawn,
    r8_config_knobs,
    r9_view_escape,
    r10_grow_only,
    r11_loop_stop_strands_client,
    r12_lock_order,
    r13_thread_affinity,
    r14_wire_contract,
]

RULES_BY_ID: Dict[str, object] = {m.RULE_ID: m for m in ALL_RULES}


def rule_catalog() -> List[Dict[str, str]]:
    return [{"id": m.RULE_ID, "summary": m.SUMMARY} for m in ALL_RULES]
