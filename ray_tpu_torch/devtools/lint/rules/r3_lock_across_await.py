# Copied from ray_tpu/devtools/lint/rules/r3_lock_across_await.py.
"""R3 — a threading lock held across an ``await`` point.

Invariant: a *thread* lock (``threading.Lock``/``RLock``) must never be
held across an ``await``. The await suspends the coroutine but NOT the
lock: every other task on the loop that touches the same lock now blocks
the loop thread itself, which (unlike a task-level ``asyncio.Lock`` wait)
can never be broken by the loop — the classic single-thread deadlock.
Holding a lock across a suspension also silently extends the critical
section to everything the loop interleaves, the same shape that wedged
the driver in the MemoryStore incident (PR 5) — here the loop *is* the
"other thread".

Detection: inside ``async def`` bodies, any sync ``with`` statement whose
context expression resolves (via the project lock index) to a
``threading.Lock``/``RLock`` and whose body subtree contains an ``Await``.
``async with`` on ``asyncio.Lock`` is the sanctioned alternative.
"""

from __future__ import annotations

import ast
from typing import List

from ..callgraph import FunctionInfo, ProjectIndex
from ..model import ModuleInfo, Violation
from .r2_blocking_in_async import _walk_async_body

RULE_ID = "R3"
SUMMARY = ("threading.Lock/RLock held across an await — blocks the loop "
           "thread for every interleaved task; narrow the critical "
           "section or use asyncio.Lock")


def check_module(mod: ModuleInfo, index: ProjectIndex) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        qn = mod.qualname(node)
        cls = qn.split(".")[0] if "." in qn else None
        fn = FunctionInfo(node.name, qn, mod, node, class_name=cls)
        # _walk_async_body skips nested defs: a nested async def's
        # with-blocks are visited under its OWN AsyncFunctionDef pass,
        # never twice, and awaits inside a nested def defined in the
        # with-body don't execute while the lock is held.
        for sub in _walk_async_body(node):
            if not isinstance(sub, ast.With):
                continue
            lock_name = None
            for item in sub.items:
                kind, name = index.lock_kind(fn, item.context_expr)
                if kind in ("Lock", "RLock"):
                    lock_name = name
                    break
            if lock_name is None:
                continue
            awaits = _awaits_in(sub)
            if awaits:
                out.append(mod.violation(
                    RULE_ID, awaits[0],
                    f"thread lock '{lock_name}' is held across this await "
                    f"in '{qn}' (with-block at line {sub.lineno}); the "
                    f"suspension keeps the lock while other tasks run and "
                    f"any of them touching it deadlocks the loop thread — "
                    f"release before awaiting or use asyncio.Lock"))
    return out


def _awaits_in(with_node: ast.With) -> List[ast.Await]:
    """Awaits lexically inside the with-body, excluding nested defs
    (those suspend whoever CALLS them, not this critical section)."""
    out: List[ast.Await] = []
    stack = list(ast.iter_child_nodes(with_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Await):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    out.sort(key=lambda n: (n.lineno, n.col_offset))
    return out
