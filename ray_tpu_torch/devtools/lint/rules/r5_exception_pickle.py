# Copied from ray_tpu/devtools/lint/rules/r5_exception_pickle.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""R5 — cross-process exceptions must survive a pickle round-trip.

Invariant: every exception class raised across a process boundary (the
public hierarchy in ``ray_tpu_torch/exceptions.py``) must reconstruct with its
fields intact after ``pickle.dumps``/``loads``. The default
``BaseException.__reduce__`` re-calls ``cls(*self.args)`` — and
``self.args`` is whatever was passed to ``super().__init__()``, which in
a class with a custom ``__init__`` is almost always the *formatted
message*, not the original fields. The round trip then either crashes
(arity mismatch) or silently corrupts: the receiver catches
``ObjectLostError`` whose ``object_id_hex`` is a full sentence.

Motivating history: PR 5/6 added explicit ``__reduce__`` to the
``DeathContext`` carriers (``NodeDiedError``, ``RayActorError``,
``BackPressureError``) precisely because their context dicts evaporated
at the first boundary; this rule makes that discipline structural.

Detection (static half): in ``exceptions.py``, any class in the
exception hierarchy that defines (or inherits, within the module) a
custom ``__init__`` must also define or inherit-in-module a
``__reduce__``. The dynamic half is the auto-generated round-trip test
(tests/test_torch_raylint.py) which instantiates every public class and
compares fields across dumps/loads.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..model import ModuleInfo, Violation

RULE_ID = "R5"
SUMMARY = ("exception class with a custom __init__ but no __reduce__ — "
           "default pickling rebuilds from self.args and drops/corrupts "
           "fields at the process boundary")

_TARGET_SUFFIX = "exceptions.py"


def check_module(mod: ModuleInfo, index) -> List[Violation]:
    if not mod.relpath.endswith(_TARGET_SUFFIX):
        return []
    classes: Dict[str, ast.ClassDef] = {
        n.name: n for n in mod.tree.body if isinstance(n, ast.ClassDef)}

    def bases_of(cd: ast.ClassDef) -> List[str]:
        out = []
        for b in cd.bases:
            if isinstance(b, ast.Name):
                out.append(b.id)
            elif isinstance(b, ast.Attribute):
                out.append(b.attr)
        return out

    def is_exception(name: str, seen: Optional[Set[str]] = None) -> bool:
        seen = seen or set()
        if name in seen:
            return False
        seen.add(name)
        if name in ("Exception", "BaseException", "TimeoutError",
                    "RuntimeError", "ValueError", "OSError"):
            return True
        cd = classes.get(name)
        if cd is None:
            return False
        return any(is_exception(b, seen) for b in bases_of(cd))

    def defines(cd: ast.ClassDef, meth: str) -> bool:
        return any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and n.name == meth for n in cd.body)

    def inherits(name: str, meth: str, seen: Optional[Set[str]] = None
                 ) -> bool:
        """Does ``name`` define or inherit ``meth`` from an in-module
        ancestor?"""
        seen = seen or set()
        if name in seen:
            return False
        seen.add(name)
        cd = classes.get(name)
        if cd is None:
            return False
        if defines(cd, meth):
            return True
        return any(inherits(b, meth, seen) for b in bases_of(cd))

    out: List[Violation] = []
    for name, cd in classes.items():
        if not any(is_exception(b) for b in bases_of(cd)):
            continue
        if inherits(name, "__init__") and not inherits(name, "__reduce__"):
            out.append(mod.violation(
                RULE_ID, cd,
                f"exception '{name}' customizes __init__ (so self.args no "
                f"longer matches the constructor signature) but has no "
                f"__reduce__: pickling across a process boundary will "
                f"rebuild it from the formatted message, dropping or "
                f"corrupting its fields — add __reduce__ that rebuilds "
                f"from the real fields"))
    return out
