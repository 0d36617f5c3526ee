# Copied from ray_tpu/devtools/lint/rules/r9_view_escape.py.
"""R9 — a store mmap view escaping a function without a matching pin.

Invariant (the device object plane's view-lifetime contract, ISSUE 9):
a memoryview produced by the store read layer (``get_view`` /
``read_maybe_spilled``) aliases store memory whose lifetime the store
controls. A view that stays local to a function dies before the store
can move the object; a view that ESCAPES — returned, stored on
``self``, or captured by a nested function handed to the event loop —
outlives the call and can alias an evicted or spilled segment unless
the object is pinned for the view's lifetime. The zero-copy get path
ships exactly this shape (``Worker._pin_escaping_view``); the serve
path pins via its view-cache entry.

Detection (per module, heuristic but shaped on the shipped code):
inside every function that is not itself part of the store read layer
(``PRODUCER_NAMES``) and that performs no pin call (any call whose
attribute/function name contains ``pin`` — pin registration is
inherently name-adjacent in this codebase: ``pin``, ``PinObject``
pushes ride helper methods like ``_pin_escaping_view``), flag:

- ``return`` expressions containing a view variable or a direct
  producer call,
- assignments of either onto ``self``,
- view variables referenced inside a nested def/lambda (the capture
  outlives the frame — the task-leak shape applied to memory).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..callgraph import ProjectIndex
from ..model import ModuleInfo, Violation

RULE_ID = "R9"
SUMMARY = ("store mmap view escapes its function (returned / stored on "
           "self / captured by a nested function) without a pin — it can "
           "alias an evicted segment; pin the object for the view's "
           "lifetime")

# The store read layer: calls to these produce views; functions NAMED
# like these (or wrapping them, like the agent's tiered reader) are the
# producer layer itself and exempt — the contract binds their callers.
PRODUCER_NAMES = frozenset({
    "get_view", "read_maybe_spilled", "pinned_view", "pin_view",
})

# Calls that CONSUME a view into a fresh, non-aliasing value: passing
# the view through these is not an escape (``return len(view)`` copies
# nothing out of the segment).
SAFE_CONSUMERS = frozenset({
    "len", "bytes", "bytearray", "int", "bool", "float", "str", "hash",
    "sum", "min", "max", "repr", "hex",
})


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return None


def _is_producer_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and _call_name(node) in PRODUCER_NAMES


def _walk_own(node: ast.AST, *, into_nested: bool = False):
    """Walk a function body without descending into nested defs (their
    statements belong to their own pass) unless ``into_nested``."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if not into_nested and isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                      ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(cur))


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def check_module(mod: ModuleInfo, index: ProjectIndex) -> List[Violation]:
    out: List[Violation] = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if fn.name in PRODUCER_NAMES:
            continue
        # A pin anywhere in the function satisfies the contract for its
        # escapes (registration APIs are pin-named by convention).
        if any(isinstance(n, ast.Call) and "pin" in (
                _call_name(n) or "").lower()
               for n in _walk_own(fn, into_nested=True)):
            continue
        qn = mod.qualname(fn)
        # view variables: x = <recv>.get_view(...) etc.
        view_vars: Set[str] = set()
        for node in _walk_own(fn):
            if isinstance(node, ast.Assign) and _is_producer_call(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        view_vars.add(tgt.id)
        for node in _walk_own(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                if _escapes(node.value, view_vars):
                    out.append(mod.violation(
                        RULE_ID, node,
                        f"'{qn}' returns a store view with no pin in "
                        f"scope — the caller's copy outlives this frame "
                        f"and can alias an evicted segment; pin the "
                        f"object for the view's lifetime (R9 view-"
                        f"lifetime contract)"))
            elif isinstance(node, ast.Assign):
                is_self_store = any(
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    for t in node.targets)
                if is_self_store and _escapes(node.value, view_vars):
                    out.append(mod.violation(
                        RULE_ID, node,
                        f"'{qn}' stores a store view on self with no pin "
                        f"in scope — the attribute outlives every call "
                        f"and can alias an evicted segment (R9)"))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                captured = view_vars & _names_in(node)
                if captured:
                    out.append(mod.violation(
                        RULE_ID, node,
                        f"nested function in '{qn}' captures store view "
                        f"'{sorted(captured)[0]}' with no pin in scope — "
                        f"the closure (a task, a callback) can run after "
                        f"the store moved the object (R9)"))
    return out


def _escapes(expr: ast.AST, view_vars: Set[str]) -> bool:
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call) and _call_name(node) in SAFE_CONSUMERS:
            continue  # consumed into a fresh value — nothing aliases
        if _is_producer_call(node):
            return True
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in view_vars:
            return True
        stack.extend(ast.iter_child_nodes(node))
    return False
