# Copied from ray_tpu/devtools/lint/rules/r10_grow_only.py.
"""R10 — grow-only container in a long-lived service class.

Invariant: a ``self.``-attribute (or module-level) dict/list/set that a
resident service process only ever ADDS to is a memory leak with a
delay fuse.  Agents, the GCS and worker runtimes live for the cluster's
lifetime; a ledger keyed by object/task/worker ids that nothing ever
prunes grows with cumulative traffic, not live state.

Motivating bugs: the PR 11 agent demand ledger and pool-waiter queue
(unbounded in no-stats-polling regimes, pruned in-PR), the PR 13 GCS
task-event list (O(n) copy per overflow until it became a capped
deque), and the set_resolved resurrection leak the ISSUE 15 ref-leak
gate caught (an owned-table entry nothing could ever free again).

Detection (per module): a class with at least one ``async def`` method
containing a ``while`` loop (the resident-service marker) whose
``__init__`` assigns ``self.<name>`` an empty dict/list/set/
defaultdict/OrderedDict, where the class body then contains at least
one grow operation on ``self.<name>`` and NO shrink operation
(``pop``/``popitem``/``clear``/``remove``/``discard``/``popleft``/
``del self.<name>[...]``/wholesale reassignment outside ``__init__``).
Passing the bare container to a call (``prune(self._ledger)``) counts
as an escape and suppresses the finding — someone else may own the
pruning.  ``deque(maxlen=...)`` is bounded by construction and never
flagged.  Module-level containers are checked the same way in modules
that define such a service class.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from ..model import ModuleInfo, Violation

RULE_ID = "R10"
SUMMARY = ("grow-only dict/list/set in a long-lived service class — "
           "entries are added on traffic but nothing ever prunes them, "
           "so the process leaks with cumulative load; add an eviction "
           "path or bound it by construction")

_EMPTY_CTORS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                "Counter", "WeakValueDictionary"}
_GROW_METHODS = {"append", "add", "setdefault", "extend", "insert",
                 "appendleft", "update"}
_SHRINK_METHODS = {"pop", "popitem", "clear", "remove", "discard",
                   "popleft", "prune"}


def _is_empty_container(node: ast.AST) -> bool:
    """``{}`` / ``[]`` / ``set()`` / ``dict()`` / ``defaultdict(...)`` /
    ``OrderedDict()`` — an empty growable container literal/ctor."""
    if isinstance(node, ast.Dict) and not node.keys:
        return True
    if isinstance(node, ast.List) and not node.elts:
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        return name in _EMPTY_CTORS
    return False


def _is_service_class(cls: ast.ClassDef) -> bool:
    """Long-lived marker: any async method with a ``while`` loop (the
    shape of every agent/gcs/worker background service loop)."""
    for item in cls.body:
        if isinstance(item, ast.AsyncFunctionDef):
            for sub in ast.walk(item):
                if isinstance(sub, ast.While):
                    return True
    return False


class _ContainerOps:
    __slots__ = ("grow", "shrink", "escape", "decl")

    def __init__(self, decl: ast.AST):
        self.decl = decl
        self.grow = 0
        self.shrink = 0
        self.escape = 0


def _target_name(node: ast.AST, self_attr: bool) -> Optional[str]:
    """Name of the container an expression refers to: ``self.x`` (when
    self_attr) or a bare module-level ``x``."""
    if self_attr:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            return node.attr
        return None
    if isinstance(node, ast.Name):
        return node.id
    return None


def _scan_ops(tree_nodes, containers: Dict[str, _ContainerOps],
              self_attr: bool, skip: Optional[Set[ast.AST]] = None) -> None:
    """Classify every reference to a tracked container as grow / shrink /
    escape. ``skip`` holds the declaration statements themselves."""
    skip = skip or set()
    for node in tree_nodes:
        for sub in ast.walk(node):
            if sub in skip:
                continue
            # self.x[k] = v  /  x[k] = v  (grow);  del self.x[k] (shrink)
            if isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        name = _target_name(t.value, self_attr)
                        if name in containers:
                            containers[name].grow += 1
                    else:
                        name = _target_name(t, self_attr)
                        if name in containers:
                            # wholesale reassignment outside the decl:
                            # a reset path — counts as shrink
                            containers[name].shrink += 1
            elif isinstance(sub, ast.Delete):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript):
                        name = _target_name(t.value, self_attr)
                        if name in containers:
                            containers[name].shrink += 1
            elif isinstance(sub, ast.Attribute):
                # any reference to self.x.pop / self.x.discard — called
                # directly OR passed as a callback
                # (task.add_done_callback(self._bg_tasks.discard)) —
                # proves a shrink path exists
                name = _target_name(sub.value, self_attr)
                if name in containers:
                    if sub.attr in _GROW_METHODS:
                        containers[name].grow += 1
                    elif sub.attr in _SHRINK_METHODS:
                        containers[name].shrink += 1
            elif isinstance(sub, ast.Call):
                # bare container passed to a call: ownership escapes
                for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                    name = _target_name(arg, self_attr)
                    if name in containers:
                        containers[name].escape += 1


def check_module(mod: ModuleInfo, index) -> List[Violation]:
    out: List[Violation] = []
    service_classes = [n for n in ast.walk(mod.tree)
                       if isinstance(n, ast.ClassDef)
                       and _is_service_class(n)]
    for cls in service_classes:
        init = next((i for i in cls.body
                     if isinstance(i, ast.FunctionDef)
                     and i.name == "__init__"), None)
        if init is None:
            continue
        containers: Dict[str, _ContainerOps] = {}
        decls: Set[ast.AST] = set()
        for stmt in ast.walk(init):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            value = stmt.value
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            if value is None or not _is_empty_container(value):
                continue
            for t in targets:
                name = _target_name(t, self_attr=True)
                if name:
                    containers[name] = _ContainerOps(stmt)
                    decls.add(stmt)
        if not containers:
            continue
        _scan_ops([n for n in cls.body if n is not init] + [init],
                  containers, self_attr=True, skip=decls)
        for name, ops in containers.items():
            if ops.grow and not ops.shrink and not ops.escape:
                out.append(mod.violation(
                    RULE_ID, ops.decl,
                    f"'self.{name}' in service class '{cls.name}' is "
                    f"only ever added to ({ops.grow} grow sites, no "
                    f"pop/del/clear/maxlen anywhere in the class): a "
                    f"long-lived process leaks it with cumulative "
                    f"traffic — add an eviction/prune path, bound it, "
                    f"or justify with a disable"))
    # module-level containers, only in modules hosting a service class
    if service_classes:
        containers = {}
        decls = set()
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and \
                    _is_empty_container(stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name) and not t.id.startswith("__"):
                        containers[t.id] = _ContainerOps(stmt)
                        decls.add(stmt)
        if containers:
            _scan_ops([n for n in mod.tree.body if n not in decls],
                      containers, self_attr=False, skip=decls)
            for name, ops in containers.items():
                if ops.grow and not ops.shrink and not ops.escape:
                    out.append(mod.violation(
                        RULE_ID, ops.decl,
                        f"module-level '{name}' is only ever added to "
                        f"({ops.grow} grow sites, no shrink op in the "
                        f"module) in a module hosting a long-lived "
                        f"service class — it leaks with cumulative "
                        f"traffic"))
    return out
