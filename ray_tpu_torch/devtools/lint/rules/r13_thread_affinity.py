# Copied from ray_tpu/devtools/lint/rules/r13_thread_affinity.py.
"""R13 — loop/thread/GC affinity races on plain attribute mutation.

Invariant: a ``self.<attr>`` that is plainly mutated (no lock held in
scope) must be confined to ONE affinity domain — event-loop callbacks,
executor/drainer threads, or GC-context finalizers. The same attribute
mutated from two domains with no hand-off is a data race the GIL merely
makes *rare*, not safe.

Motivating shape (PR 18): ``_completion_buf``/``_completions_armed``
are touched by ``_completion_enqueue`` (scheduled onto the loop) and
read-modify-written by ``_drain_completions``; PR 12's shm feeder thread
had the same pattern against the loop. Both had to get the hand-off
right *by hand* — this rule pins the discipline down.

Detection: every function gets a domain set walked to fixpoint from
roots — ``async def`` bodies and ``call_soon*``/``create_task``
callbacks are loop-affine, ``threading.Thread``/``run_in_executor``
targets are thread-affine, ``__del__``/weakref callbacks are GC-affine;
nested defs inherit their enclosing frame's domains. If the union of
domains over all mutation sites of one ``(class, attr)`` spans ≥2
domains, each *unguarded* classified site is flagged. Mutations inside
``__init__`` (construction happens-before publication) and sites under
any held lock are exempt.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .. import concurrency
from ..callgraph import ProjectIndex
from ..model import Violation

RULE_ID = "R13"
SUMMARY = ("same self.<attr> plainly mutated from two thread-affinity "
           "domains (loop/executor/GC) with no lock or queue hand-off "
           "in scope — cross-thread data race")

_CTOR_NAMES = {"__init__", "__new__", "__post_init__",
               "__init_subclass__", "__set_name__"}


def _in_ctor(conc: "concurrency.Concurrency",
             fn: "concurrency.FnNode") -> bool:
    cur = fn
    while cur is not None:
        if cur.info.name in _CTOR_NAMES:
            return True
        cur = conc.fns.get(cur.parent_ref) if cur.parent_ref else None
    return False


def check(index: ProjectIndex) -> List[Violation]:
    conc = concurrency.get(index)
    groups: Dict[Tuple[str, str], List[Tuple]] = {}
    for ref in sorted(conc.fns):
        fn = conc.fns[ref]
        cls = fn.info.class_name
        if not cls or _in_ctor(conc, fn):
            continue
        doms = frozenset(conc.domains.get(ref, ()))
        for attr, node, held in fn.self_writes:
            groups.setdefault((cls, attr), []).append(
                (fn, node, held, doms))

    out: List[Violation] = []
    for (cls, attr) in sorted(groups):
        writes = groups[(cls, attr)]
        all_doms = set()
        for _fn, _node, _held, doms in writes:
            all_doms |= doms
        if len(all_doms) < 2:
            continue
        seen_lines = set()
        for fn, node, held, doms in writes:
            if held or not doms:
                continue  # lock hand-off in scope / unclassified frame
            line_key = (fn.info.module.relpath,
                        getattr(node, "lineno", 0))
            if line_key in seen_lines:
                continue
            seen_lines.add(line_key)
            other = next(
                ((f, n, d) for f, n, _h, d in writes
                 if d - doms), None)
            if other is not None:
                of, onode, od = other
                other_txt = (
                    f"and from {sorted(od)} context at "
                    f"{of.info.module.relpath}:"
                    f"{getattr(onode, 'lineno', 0)} in "
                    f"'{of.info.qualname}'")
            else:
                other_txt = (f"and this frame itself runs in all of "
                             f"{sorted(all_doms)}")
            out.append(fn.info.module.violation(
                RULE_ID, node,
                f"'self.{attr}' of {cls} is mutated from "
                f"{sorted(doms)} context here {other_txt} with no "
                f"lock/queue hand-off in scope — plain cross-domain "
                f"mutation races; guard it, confine it to one domain, "
                f"or annotate the happens-before argument"))
    return out
