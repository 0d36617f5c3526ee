# Copied from ray_tpu/devtools/lint/rules/r11_loop_stop_strands_client.py.
"""R11 — event-loop stop in a class holding an ``AsyncRpcClient``
without awaiting the client's read loop first.

Invariant: a class that owns a private event-loop thread AND an
``AsyncRpcClient`` must route teardown through ``aclose()`` /
``close_soon()`` *before* stopping the loop. ``client.close()`` only
*cancels* the read-loop task; the cancelled task still needs one loop
tick to finish, so a method that stops the loop without awaiting it
strands the task and the dying loop prints "Task was destroyed but it
is pending!" at interpreter teardown.

Motivating bug: the BENCH tail-leak (ISSUE 17 satellite) —
``util/client/client.py::_Channel.close`` and
``autoscaler/monitor.py::GcsChannel.close`` both did
``self._loop.call_soon_threadsafe(self._loop.stop)`` with the client's
cancelled read loop still pending, spamming the bench tail whenever a
client-mode driver or the autoscaler monitor shut down.

Detection: inside a class whose body constructs an ``AsyncRpcClient``,
a method that stops an event loop (``<loop>.stop()`` directly, or
``call_soon_threadsafe(<loop>.stop)``) while the method body never
references ``aclose`` or ``close_soon``.
"""

from __future__ import annotations

import ast
from typing import List

from ..callgraph import _call_name
from ..model import ModuleInfo, Violation

RULE_ID = "R11"
SUMMARY = ("loop stopped in a class holding an AsyncRpcClient without "
           "aclose()/close_soon() — the cancelled read-loop task is "
           "stranded and the dying loop warns 'Task was destroyed but "
           "it is pending!'; await the client's aclose() on the loop "
           "before stopping it")


def _is_loop_stop(node: ast.AST) -> bool:
    """``<x>.stop()`` where x looks like a loop, or
    ``<x>.call_soon_threadsafe(<y>.stop, ...)``."""
    if not isinstance(node, ast.Call):
        return False
    base, attr = _call_name(node.func)
    if attr == "call_soon_threadsafe":
        return any(isinstance(a, ast.Attribute) and a.attr == "stop"
                   for a in node.args)
    if attr == "stop" and isinstance(node.func, ast.Attribute):
        # direct <loop>.stop(): only when the receiver names a loop, so
        # Monitor.stop() / watchdog.stop() style APIs don't trip
        v = node.func.value
        name = (v.attr if isinstance(v, ast.Attribute)
                else v.id if isinstance(v, ast.Name) else "")
        return "loop" in name.lower()
    return False


def _holds_async_client(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            base, attr = _call_name(node.func)
            if attr == "AsyncRpcClient":
                return True
    return False


def check_module(mod: ModuleInfo, index) -> List[Violation]:
    out: List[Violation] = []
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef) or not _holds_async_client(cls):
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stops = [n for n in ast.walk(fn) if _is_loop_stop(n)]
            if not stops:
                continue
            mentioned = {n.attr for n in ast.walk(fn)
                         if isinstance(n, ast.Attribute)}
            mentioned |= {n.id for n in ast.walk(fn)
                          if isinstance(n, ast.Name)}
            if "aclose" in mentioned or "close_soon" in mentioned:
                continue
            out.append(mod.violation(
                RULE_ID, stops[0],
                f"'{mod.qualname(fn)}' stops the event loop while this "
                f"class holds an AsyncRpcClient and the method never "
                f"awaits aclose()/close_soon(): the client's cancelled "
                f"read-loop task needs one more loop tick, so stopping "
                f"first strands it ('Task was destroyed but it is "
                f"pending!' at teardown) — run "
                f"run_coroutine_threadsafe(client.aclose(), loop)"
                f".result() before stopping the loop"))
    return out
