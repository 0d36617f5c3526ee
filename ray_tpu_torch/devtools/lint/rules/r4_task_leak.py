# Copied from ray_tpu/devtools/lint/rules/r4_task_leak.py.
"""R4 — fire-and-forget ``asyncio.create_task`` / ``ensure_future``.

Invariant: every spawned task handle must be retained somewhere that
(a) keeps it alive (the loop holds only a *weak* reference — an
unreferenced task can be garbage-collected mid-flight, the source of
"Task was destroyed but it is pending!") and (b) surfaces its exception
(an unobserved failed task dies silently; the daemon it implemented is
simply gone).

Motivating bugs: the leaked read-loop tasks of PRs 1/3 (bench-tail "Task
was destroyed" spam traced to an overwritten client whose read task
nobody held), and the GCS loops that died silently until PR 5 put them
under a restart-on-crash supervisor with ``_hold_task``.

Detection: a ``create_task``/``ensure_future`` call whose result is
discarded — a bare expression statement, or assigned to ``_``. Passing
the task to a tracker (``self._hold_task(loop.create_task(...))``),
assigning it to an attribute, or appending it to a collection all count
as retained and are not flagged.
"""

from __future__ import annotations

import ast
from typing import List

from ..callgraph import _call_name
from ..model import ModuleInfo, Violation

RULE_ID = "R4"
SUMMARY = ("create_task/ensure_future result discarded — the loop keeps "
           "only a weak ref (task can vanish mid-flight) and exceptions "
           "are never observed; retain the handle in a tracked group")

_SPAWNERS = {"create_task", "ensure_future"}


def _is_spawn(call: ast.Call) -> bool:
    base, attr = _call_name(call.func)
    return attr in _SPAWNERS


def check_module(mod: ModuleInfo, index) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not _is_spawn(node):
            continue
        parent = mod.parent(node)
        discarded = False
        if isinstance(parent, ast.Expr):
            discarded = True
        elif isinstance(parent, ast.Assign):
            targets = parent.targets
            if all(isinstance(t, ast.Name) and t.id == "_"
                   for t in targets):
                discarded = True
        if not discarded:
            continue
        base, attr = _call_name(node.func)
        out.append(mod.violation(
            RULE_ID, node,
            f"'{attr}' result discarded in '{mod.qualname(node)}': the "
            f"event loop holds the task only weakly (GC can destroy it "
            f"pending) and a raised exception is never observed — keep "
            f"the handle in a tracked set with a done-callback, or await "
            f"it"))
    return out
