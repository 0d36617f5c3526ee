# Copied from ray_tpu/devtools/lint/rules/r2_blocking_in_async.py.
"""R2 — blocking calls inside ``async def`` bodies.

Invariant: coroutine bodies must not issue thread-blocking calls —
``time.sleep``, synchronous subprocess waits, synchronous sockets/HTTP —
because one blocked coroutine freezes the *entire* event loop: every RPC
read loop, watchdog, and heartbeat sharing it goes silent, which reads
as a node death to the rest of the cluster.

Motivating history: the agent/GCS control loops share one loop with the
RPC read path (PRs 1/5); a single stray ``time.sleep`` in a handler
stalls heartbeats long enough to trip the health-check death verdict.

Detection is a deny-list of call shapes, resolved through the module's
imports (``import time as t`` still matches). ``await
asyncio.sleep(...)`` and ``loop.run_in_executor(...)`` are the sanctioned
alternatives.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from ..callgraph import _call_name
from ..model import ModuleInfo, Violation

RULE_ID = "R2"
SUMMARY = ("blocking call (time.sleep / sync subprocess / sync HTTP) "
           "inside an async def — stalls the shared event loop; use the "
           "async equivalent or run_in_executor")

# (module, attr) call shapes that block the calling thread
_BLOCKING = {
    ("time", "sleep"),
    ("subprocess", "run"),
    ("subprocess", "call"),
    ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("os", "system"),
    ("os", "wait"),
    ("os", "waitpid"),
    ("socket", "create_connection"),
    ("requests", "get"),
    ("requests", "post"),
    ("requests", "put"),
    ("requests", "delete"),
    ("requests", "request"),
    ("urllib.request", "urlopen"),
}


def _import_aliases(mod: ModuleInfo) -> dict:
    """alias -> real module name for plain imports (import time as t)."""
    out = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
    return out


def _resolved(base: Optional[str], attr: Optional[str],
              aliases: dict) -> Tuple[Optional[str], Optional[str]]:
    if base is None:
        return None, attr
    return aliases.get(base, base), attr


def check_module(mod: ModuleInfo, index) -> List[Violation]:
    out: List[Violation] = []
    aliases = _import_aliases(mod)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        for sub in _walk_async_body(node):
            if not isinstance(sub, ast.Call):
                continue
            base, attr = _call_name(sub.func)
            rbase, rattr = _resolved(base, attr, aliases)
            if (rbase, rattr) in _BLOCKING:
                out.append(mod.violation(
                    RULE_ID, sub,
                    f"blocking call '{rbase}.{rattr}()' inside async "
                    f"'{mod.qualname(node)}' freezes the shared event "
                    f"loop (heartbeats, RPC reads, watchdogs); use the "
                    f"async equivalent or loop.run_in_executor"))
    return out


def _walk_async_body(fn: ast.AsyncFunctionDef):
    """Walk the coroutine body without descending into nested *sync*
    defs (those run wherever they're called) but descending into nested
    async defs' bodies is also skipped — they're visited as their own
    AsyncFunctionDef by the outer walk."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))
