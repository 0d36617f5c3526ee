# Copied from ray_tpu/devtools/lint/rules/r1_gc_reentrancy.py.
"""R1 — plain ``threading.Lock`` reachable from GC context.

Invariant: any critical section reachable from ``__del__`` or a weakref
callback must use ``RLock`` (or a documented GC-safe pattern), because
the garbage collector may run the destructor on *any* thread at *any*
bytecode boundary — including while that same thread already holds the
lock.

Motivating bug (PR 5): ``MemoryStore`` used a plain ``Lock``;
``ObjectRef.__del__`` fired inside a GC pass while the owning thread was
inside ``MemoryStore.wait()``'s critical section, re-entered
``delete()`` via the reference counter, and deadlocked the whole driver
(three modules between the destructor and the lock — no single-file
review could see it).

Detection: fixpoint reachability over the project call graph from every
``__del__`` / ``weakref.ref|finalize`` callback; every reached function's
sync lock acquisitions are checked. The violation message carries the
call path so the reader can judge the chain.
"""

from __future__ import annotations

import ast
from typing import List

from ..callgraph import FunctionInfo, ProjectIndex
from ..model import Violation

RULE_ID = "R1"
SUMMARY = ("threading.Lock (non-reentrant) acquired in code reachable "
           "from __del__/weakref callbacks — GC re-entry deadlocks; "
           "use RLock or a GC-safe pattern")


def check(index: ProjectIndex) -> List[Violation]:
    roots: List[FunctionInfo] = []
    for mod in index.modules:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name == "__del__":
                qn = mod.qualname(node)
                cls = qn.split(".")[0] if "." in qn else None
                roots.append(FunctionInfo(node.name, qn, mod, node,
                                          class_name=cls))
    for expr, mod in index.weakref_callbacks:
        roots.extend(index.function_for_expr(expr, mod))
    if not roots:
        return []
    reached = index.reachable(roots)
    out: List[Violation] = []
    seen_sites = set()
    for ref, (fn, path) in reached.items():
        for site in index.lock_sites(fn):
            if site.kind != "Lock":
                continue
            site_key = (fn.module.relpath, site.node.lineno, site.name)
            if site_key in seen_sites:
                continue
            seen_sites.add(site_key)
            chain = " -> ".join(p.split("::")[-1] for p in path)
            out.append(fn.module.violation(
                RULE_ID, site.node,
                f"plain threading.Lock '{site.name}' is acquired in "
                f"'{fn.qualname}', which is reachable from GC context "
                f"via {chain}; a destructor firing on the owning thread "
                f"mid-critical-section deadlocks — use RLock or defer "
                f"the GC-path work off-lock"))
    return out
