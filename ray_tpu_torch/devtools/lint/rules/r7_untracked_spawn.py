# Copied from ray_tpu/devtools/lint/rules/r7_untracked_spawn.py; a Popen that
# dies with its parent passes too.
"""R7 — every spawned process must register with the pid registry.

Invariant: any ``subprocess.Popen`` (or forkserver spawn) must be
recorded in the session pid registry (``lifecycle.register_process`` /
``register_self``, or the CLI's ``_record_pid`` pidfile) by its spawner,
so the PR 1 teardown sweep (``node.stop()`` SIGTERM→SIGKILL walk, stale
session GC, conftest leak gate) can reap it. An unregistered child that
outlives its parent is exactly the daemon-leak class that starved the
round-5 MULTICHIP gate (leaked forkservers + workers oversubscribing the
box).

Detection: a ``Popen(...)`` call whose enclosing function does not also
call a registry function. Same-function registration is the contract
("called by the SPAWNER immediately after fork/Popen, so a crash of the
child can never leave it unregistered" — lifecycle.py); registering in
some *other* function leaves a crash window and is flagged.

The port also takes a child that cannot outlive its spawner: a ``Popen``
given ``preexec_fn=die_with_parent`` (``lifecycle.die_with_parent``, which
arms ``PR_SET_PDEATHSIG`` with SIGKILL in the child) needs no registry,
because the kill -9 of its spawner that the sweep exists for kills it too.
That is how the port spawns where no session may exist (``nvcc`` in
``ops/cuda/_build.py``, the rank processes of ``dryrun.py``).
"""

from __future__ import annotations

import ast
from typing import List

from ..callgraph import _call_name
from ..model import ModuleInfo, Violation

RULE_ID = "R7"
SUMMARY = ("subprocess.Popen without same-function pid-registry "
           "registration — the child escapes the teardown sweep and "
           "leaks as a daemon")

_REGISTRY_CALLS = {"register_process", "register_self", "_record_pid"}
_FATE_SHARING_HOOKS = {"die_with_parent"}


def _dies_with_parent(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "preexec_fn":
            _base, attr = _call_name(kw.value)
            return attr in _FATE_SHARING_HOOKS
    return False


def check_module(mod: ModuleInfo, index) -> List[Violation]:
    out: List[Violation] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        spawns: List[ast.Call] = []
        registers = False
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                base, attr = _call_name(sub.func)
                if attr == "Popen":
                    if not _dies_with_parent(sub):
                        spawns.append(sub)
                elif attr in _REGISTRY_CALLS:
                    registers = True
        if spawns and not registers:
            for sp in spawns:
                out.append(mod.violation(
                    RULE_ID, sp,
                    f"Popen in '{mod.qualname(node)}' never registers the "
                    f"child with the session pid registry "
                    f"(lifecycle.register_process) in the same function: "
                    f"if this process dies the child escapes the "
                    f"teardown sweep and leaks as a daemon"))
    return out
