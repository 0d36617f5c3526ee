# Copied from ray_tpu/devtools/lint/rules/r6_unbounded_rpc.py.
"""R6 — control RPCs must carry a timeout or retry budget.

Invariant: every ``.call("Method", ...)`` on a control channel must be
bounded — a ``timeout=`` (or third positional), an enclosing
``asyncio.wait_for``, or a ``protocol.retry_call`` wrapper (bounded
attempts + per-attempt transport failure detection). An unbounded
control RPC under a one-way partition (no TCP RST — the request is
simply eaten) parks its caller *forever*.

Motivating bug (PR 5): the agent's head watchdog awaited an untimed
``RegisterNode``/``ReturnWorker`` under a one-way partition and wedged —
the node could neither re-register nor be declared dead. PR 5 bounded
those two by hand; this rule bounds the class.

Detection: a ``X.call("Name", ...)`` / ``X.call_raw_into(...)`` whose
first argument is a string literal (the control-method idiom; arbitrary
``.call()`` APIs with non-literal callees are out of scope) and that has
neither a timeout argument nor a bounding ancestor
(``asyncio.wait_for(...)`` / a lambda argument of ``retry_call``).
``call_future`` (explicitly deadline-managed by its done-callback
callers) is not matched.
"""

from __future__ import annotations

import ast
from typing import List

from ..callgraph import _call_name
from ..model import ModuleInfo, Violation

RULE_ID = "R6"
SUMMARY = ("control RPC .call(...) with no timeout/retry budget — hangs "
           "forever under a one-way partition; pass timeout=, wrap in "
           "wait_for, or use protocol.retry_call")

_CALL_NAMES = {"call", "call_raw_into"}


def _is_bounded_by_ancestors(mod: ModuleInfo, node: ast.Call) -> bool:
    """True when the call sits under asyncio.wait_for(...), inside a
    lambda/function argument of retry_call(...), or inside an
    ``_acall(..., timeout=X)`` bridge (the worker's run-coroutine-
    threadsafe wrapper whose ``fut.result(timeout)`` bounds the await)."""
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.Call):
            base, attr = _call_name(anc.func)
            if attr == "wait_for":
                return True
            if attr == "retry_call":
                return True
            if attr == "_acall" and (
                    any(kw.arg == "timeout" for kw in anc.keywords)
                    or len(anc.args) >= 2):
                return True
    return False


def check_module(mod: ModuleInfo, index) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        base, attr = _call_name(node.func)
        if attr not in _CALL_NAMES or not isinstance(node.func,
                                                     ast.Attribute):
            continue
        if not node.args or not (isinstance(node.args[0], ast.Constant)
                                 and isinstance(node.args[0].value, str)):
            continue
        method = node.args[0].value
        # bounded forms: timeout kwarg, or enough positionals to include
        # the timeout slot (call(m, p, t) / call_raw_into(m, p, dest, t))
        has_kw = any(kw.arg == "timeout" for kw in node.keywords)
        pos_needed = 3 if attr == "call" else 4
        if has_kw or len(node.args) >= pos_needed:
            continue
        if _is_bounded_by_ancestors(mod, node):
            continue
        out.append(mod.violation(
            RULE_ID, node,
            f"control RPC .{attr}(\"{method}\") carries no timeout or "
            f"retry budget: under a one-way partition the request is "
            f"silently eaten and the caller parks forever — pass "
            f"timeout= (CONFIG.control_rpc_timeout_s for fire-and-check "
            f"control traffic), wrap in asyncio.wait_for, or use "
            f"protocol.retry_call"))
    return out
