# Copied from ray_tpu/devtools/lint/rules/r12_lock_order.py.
"""R12 — lock-order deadlock detection over the interprocedural graph.

Invariant: the project-wide lock-*order* graph (lock A held while lock B
is acquired, directly or through any resolvable call chain) must be
acyclic, and no plain ``Lock`` may be acquired from both the event loop
and GC context.

Motivating bugs: the PR 5 MemoryStore deadlock was an *ordering* bug as
much as a reentrancy one (store lock inside refcount lock on one path,
the reverse on the GC path); PR 17's ``LineageLedger`` had to hand-roll
its evict-outside-the-lock discipline precisely because ledger-lock →
store-lock nests on the retain path. R1 sees single locks; R12 sees
pairs.

Two checks:

- **Cycles**: every ordering edge inside a strongly-connected component
  of ≥2 locks is flagged at its witness site, naming the reverse-order
  witness. Two locks taken in opposite orders on any two reachable paths
  deadlock the moment both paths run concurrently.
- **Loop/GC split**: a plain (non-reentrant) ``Lock`` acquired both in
  loop-affine code and in ``__del__``/weakref context lacks the R1 RLock
  remedy — the collector can fire the destructor on the loop thread
  mid-critical-section. Flagged at the loop-side site (R1 flags the
  GC-side one), so each carries its own justification or fix.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .. import concurrency
from ..callgraph import ProjectIndex
from ..model import Violation

RULE_ID = "R12"
SUMMARY = ("lock-order cycle (two locks acquired in opposite orders on "
           "reachable paths) or plain Lock shared between event-loop "
           "and GC context — deadlock by ordering")


def _site(e: concurrency.OrderEdge) -> str:
    return (f"{e.fn.info.module.relpath}:"
            f"{getattr(e.node, 'lineno', 0)} in '{e.fn.info.qualname}'")


def check(index: ProjectIndex) -> List[Violation]:
    conc = concurrency.get(index)
    out: List[Violation] = []

    for comp in conc.lock_sccs():
        members = set(comp)
        for (a, b) in sorted(conc.edges):
            if a not in members or b not in members:
                continue
            e = conc.edges[(a, b)]
            rev = conc.edges.get((b, a))
            how = ""
            if e.via is not None:
                chain = conc.explain_path(e.via, b)
                how = (f" via the call chain "
                       f"{' -> '.join([e.fn.info.qualname] + chain)}")
            rev_txt = (f"the reverse order is taken at {_site(rev)}"
                       if rev is not None else
                       f"a reverse path exists inside the cycle "
                       f"{{{', '.join(comp)}}}")
            out.append(e.fn.info.module.violation(
                RULE_ID, e.node,
                f"lock-order cycle: '{a}' is held here while acquiring "
                f"'{b}'{how}, but {rev_txt} — two threads entering "
                f"these paths concurrently deadlock; pick one global "
                f"order or drop to a single lock"))

    # plain Lock acquired in both loop-affine and GC-affine code
    acquires: Dict[str, List[Tuple]] = {}
    for ref in sorted(conc.fns):
        fn = conc.fns[ref]
        doms = conc.domains.get(ref, set())
        for decl, node, _held in fn.acquires:
            acquires.setdefault(decl.id, []).append((fn, node, doms))
    for lock_id in sorted(acquires):
        decl = conc.lock_decls.get(lock_id)
        if decl is None or decl.kind != "Lock":
            continue
        sites = acquires[lock_id]
        loop_sites = [s for s in sites if "loop" in s[2]]
        gc_sites = [s for s in sites if "gc" in s[2]]
        if not loop_sites or not gc_sites:
            continue
        fn, node, _doms = loop_sites[0]
        gfn, gnode, _g = gc_sites[0]
        out.append(fn.info.module.violation(
            RULE_ID, node,
            f"plain Lock '{lock_id}' (declared {decl.relpath}:"
            f"{decl.line}) is acquired on the event loop here and in "
            f"GC context at {gfn.info.module.relpath}:"
            f"{getattr(gnode, 'lineno', 0)} in '{gfn.info.qualname}' "
            f"without the R1 RLock remedy — a destructor firing on the "
            f"loop thread mid-critical-section deadlocks; use RLock or "
            f"defer the GC-path work off-lock"))
    return out
