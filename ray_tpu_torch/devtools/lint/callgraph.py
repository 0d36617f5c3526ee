# Copied from ray_tpu/devtools/lint/callgraph.py.
"""Project-wide symbol index, call graph, and fixpoint reachability.

The runtime's worst shipped bugs were *reachability* properties, not
single-statement ones: the MemoryStore deadlock was ``ObjectRef.__del__``
→ ``ReferenceCounter.remove_local_ref`` → ``MemoryStore.delete`` → plain
``Lock`` — three modules apart. Rules that need "can GC context reach
this lock?" get it from here: a conservative, name-based call graph with
an ambiguity cutoff, walked to fixpoint.

Resolution strategy (deliberately approximate — Python has no static
types here):

- ``name(...)``          → same-module function, else a project function
                           imported by that name.
- ``self.m(...)``        → method ``m`` on the enclosing class, else on a
                           project base class of it, else global-by-name.
- ``obj.m(...)``         → every project function/method named ``m``,
                           but only if the name has at most
                           ``AMBIGUITY_CUTOFF`` definitions project-wide.
                           Ubiquitous names (``get``, ``put``, ``call``)
                           exceed the cutoff and contribute no edge —
                           that keeps reachability from exploding to the
                           whole tree while still following distinctive
                           hops like ``remove_local_ref``.

Lock identity: every ``self.X = threading.Lock()/RLock()`` (and
module-level ``X = Lock()``) assignment in the project is indexed, so a
``with self._lock:`` inside a method resolves to the lock *kind* declared
by its class.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .model import ModuleInfo

AMBIGUITY_CUTOFF = 4

# Attribute names that are stdlib-protocol vocabulary (lock/future/queue/
# event methods). Calling `obj.acquire()` on an *unknown* receiver is
# almost always a synchronization primitive, not a project method — a
# global-by-name edge through these would wire every __del__ to every
# class that happens to define `set` or `release` and drown R1 in false
# chains. `self.m(...)` still resolves through these names normally (the
# receiver's class is known).
GLOBAL_RESOLVE_BLOCKLIST = {
    "acquire", "release", "locked", "wait", "notify", "notify_all",
    "set", "clear", "is_set", "set_result", "set_exception", "result",
    "exception", "done", "cancel", "cancelled", "add_done_callback",
    "get", "put", "get_nowait", "put_nowait", "close", "join", "start",
    "run", "stop", "send", "recv", "read", "write", "flush", "append",
    "pop", "update", "items", "keys", "values", "copy", "encode",
    "decode", "format",
    # more stdlib vocabulary that manufactured cross-module edges once
    # R12 started chaining EA sets through them: StreamWriter.drain,
    # str.partition, list.count, json.dump/load, socket.connect
    "drain", "partition", "count", "dump", "dumps", "load", "loads",
    "connect", "index", "insert", "extend", "sort", "split", "strip",
    "seek", "submit", "shutdown",
}

_LOCK_FACTORIES = {"Lock": "Lock", "RLock": "RLock"}


@dataclass
class FunctionInfo:
    name: str
    qualname: str            # "Class.meth" or "func"
    module: ModuleInfo
    node: ast.AST            # FunctionDef | AsyncFunctionDef | Lambda
    class_name: Optional[str] = None

    @property
    def ref(self) -> str:
        return f"{self.module.relpath}::{self.qualname}"


@dataclass
class LockSite:
    node: ast.AST            # the With item / acquire() call
    kind: str                # "Lock" | "RLock" | "unknown"
    name: str                # "self._lock", "_GLOBAL_LOCK", ...
    fn: FunctionInfo


@dataclass
class ClassInfo:
    name: str
    module: ModuleInfo
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr -> kind


def _call_name(func: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """(base, attr) for a call target: ('time','sleep'), (None,'foo'),
    ('self','meth'), ('<expr>','meth') for computed bases."""
    if isinstance(func, ast.Name):
        return None, func.id
    if isinstance(func, ast.Attribute):
        v = func.value
        if isinstance(v, ast.Name):
            return v.id, func.attr
        return "<expr>", func.attr
    return None, None


def _is_lock_ctor(call: ast.Call) -> Optional[str]:
    """'Lock'/'RLock' when ``call`` constructs a threading lock."""
    base, attr = _call_name(call.func)
    if attr not in _LOCK_FACTORIES:
        return None
    if base in (None, "threading", "_threading", "th"):
        return _LOCK_FACTORIES[attr]
    return None


class ProjectIndex:
    """Symbol tables over every analyzed module, built once per run."""

    def __init__(self, modules: Iterable[ModuleInfo]):
        self.modules: List[ModuleInfo] = list(modules)
        self.classes: Dict[str, List[ClassInfo]] = {}
        self.module_functions: Dict[Tuple[str, str], FunctionInfo] = {}
        self.by_method_name: Dict[str, List[FunctionInfo]] = {}
        self.module_locks: Dict[Tuple[str, str], str] = {}
        # name imported in module -> source function name (only same-name
        # from-imports matter for call resolution)
        self.weakref_callbacks: List[Tuple[ast.AST, ModuleInfo]] = []
        for mod in self.modules:
            self._index_module(mod)

    # ------------------------------------------------------------ build
    def _index_module(self, mod: ModuleInfo) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                self._index_class(mod, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not any(isinstance(a, ast.ClassDef)
                           for a in mod.ancestors(node)):
                    fi = FunctionInfo(node.name, mod.qualname(node), mod,
                                      node)
                    self.module_functions[(mod.relpath, node.name)] = fi
                    self.by_method_name.setdefault(node.name, []).append(fi)
            elif isinstance(node, ast.Assign):
                # module-level LOCK = threading.Lock()
                if isinstance(node.value, ast.Call):
                    kind = _is_lock_ctor(node.value)
                    if kind:
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name) and not any(
                                    isinstance(a, (ast.FunctionDef,
                                                   ast.AsyncFunctionDef,
                                                   ast.ClassDef))
                                    for a in mod.ancestors(node)):
                                self.module_locks[(mod.relpath, tgt.id)] = kind
            elif isinstance(node, ast.Call):
                self._maybe_weakref_callback(mod, node)

    def _index_class(self, mod: ModuleInfo, node: ast.ClassDef) -> None:
        ci = ClassInfo(node.name, mod, node)
        for b in node.bases:
            base, attr = _call_name(b) if isinstance(b, ast.Call) else (
                (b.value.id, b.attr) if isinstance(b, ast.Attribute)
                and isinstance(b.value, ast.Name)
                else (None, b.id) if isinstance(b, ast.Name) else (None, None))
            if attr:
                ci.bases.append(attr)
        for item in ast.walk(node):
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # only direct methods (not nested-class methods)
                anc_classes = [a for a in mod.ancestors(item)
                               if isinstance(a, ast.ClassDef)]
                if anc_classes and anc_classes[0] is node:
                    fi = FunctionInfo(item.name, mod.qualname(item), mod,
                                      item, class_name=node.name)
                    ci.methods.setdefault(item.name, fi)
                    self.by_method_name.setdefault(item.name, []).append(fi)
            elif isinstance(item, ast.Assign) and isinstance(item.value,
                                                             ast.Call):
                kind = _is_lock_ctor(item.value)
                if kind:
                    for tgt in item.targets:
                        if (isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"):
                            ci.lock_attrs[tgt.attr] = kind
        self.classes.setdefault(node.name, []).append(ci)

    def _maybe_weakref_callback(self, mod: ModuleInfo,
                                call: ast.Call) -> None:
        """Record functions handed to weakref.ref(obj, cb) /
        weakref.finalize(obj, cb, ...) — they run in GC context exactly
        like __del__."""
        base, attr = _call_name(call.func)
        if attr == "ref" and base in ("weakref",) and len(call.args) >= 2:
            self.weakref_callbacks.append((call.args[1], mod))
        elif attr == "finalize" and base in ("weakref",) and len(
                call.args) >= 2:
            self.weakref_callbacks.append((call.args[1], mod))
        elif attr == "WeakValueDictionary":
            pass

    # ----------------------------------------------------------- lookup
    def class_of(self, fn: FunctionInfo) -> Optional[ClassInfo]:
        if not fn.class_name:
            return None
        for ci in self.classes.get(fn.class_name, []):
            if ci.module is fn.module:
                return ci
        return None

    def lock_kind(self, fn: FunctionInfo, expr: ast.AST) -> Tuple[
            Optional[str], str]:
        """Resolve a with-item / acquire() receiver to a lock (kind, name).

        kind is None when the expression is not a known lock.
        """
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id == "self":
            ci = self.class_of(fn)
            seen: Set[str] = set()
            while ci is not None and ci.name not in seen:
                seen.add(ci.name)
                if expr.attr in ci.lock_attrs:
                    return ci.lock_attrs[expr.attr], f"self.{expr.attr}"
                nxt = None
                for b in ci.bases:
                    cands = self.classes.get(b)
                    if cands:
                        nxt = cands[0]
                        break
                ci = nxt
            return None, f"self.{expr.attr}"
        if isinstance(expr, ast.Name):
            kind = self.module_locks.get((fn.module.relpath, expr.id))
            return kind, expr.id
        if isinstance(expr, ast.Call):
            kind = _is_lock_ctor(expr)
            if kind:
                return kind, "<inline lock>"
        return None, "<expr>"

    def lock_sites(self, fn: FunctionInfo) -> List[LockSite]:
        """Every lock acquisition (sync ``with`` or ``.acquire()``) in
        ``fn``'s own body (not nested defs)."""
        out: List[LockSite] = []
        for node in _own_body_walk(fn.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    kind, name = self.lock_kind(fn, item.context_expr)
                    if kind:
                        out.append(LockSite(node, kind, name, fn))
            elif isinstance(node, ast.Call):
                base, attr = _call_name(node.func)
                if attr == "acquire" and isinstance(node.func,
                                                    ast.Attribute):
                    kind, name = self.lock_kind(fn, node.func.value)
                    if kind:
                        out.append(LockSite(node, kind, name, fn))
        return out

    # -------------------------------------------------------- call graph
    def resolve_call(self, fn: FunctionInfo,
                     call: ast.Call) -> List[FunctionInfo]:
        base, attr = _call_name(call.func)
        if attr is None:
            return []
        if base is None:  # bare name
            local = self.module_functions.get((fn.module.relpath, attr))
            if local is not None:
                return [local]
            cands = self.by_method_name.get(attr, [])
            cands = [c for c in cands if c.class_name is None]
            return cands if 0 < len(cands) <= AMBIGUITY_CUTOFF else []
        if base == "self":
            ci = self.class_of(fn)
            seen: Set[str] = set()
            while ci is not None and ci.name not in seen:
                seen.add(ci.name)
                if attr in ci.methods:
                    return [ci.methods[attr]]
                nxt = None
                for b in ci.bases:
                    cands2 = self.classes.get(b)
                    if cands2:
                        nxt = cands2[0]
                        break
                ci = nxt
            # fall through to global-by-name for mixin patterns
        if attr in GLOBAL_RESOLVE_BLOCKLIST:
            return []
        cands = self.by_method_name.get(attr, [])
        if 0 < len(cands) <= AMBIGUITY_CUTOFF:
            return cands
        return []

    def callees(self, fn: FunctionInfo) -> List[FunctionInfo]:
        out: List[FunctionInfo] = []
        for node in _own_body_walk(fn.node):
            if isinstance(node, ast.Call):
                out.extend(self.resolve_call(fn, node))
        return out

    def reachable(self, roots: List[FunctionInfo],
                  max_depth: int = 12) -> Dict[str, Tuple[FunctionInfo,
                                                          List[str]]]:
        """Fixpoint BFS from ``roots``; returns ref -> (fn, path-of-refs)
        so violations can explain *how* GC context reaches a lock."""
        frontier: List[Tuple[FunctionInfo, List[str]]] = [
            (r, [r.ref]) for r in roots]
        seen: Dict[str, Tuple[FunctionInfo, List[str]]] = {
            r.ref: (r, [r.ref]) for r in roots}
        depth = 0
        while frontier and depth < max_depth:
            nxt: List[Tuple[FunctionInfo, List[str]]] = []
            for fn, path in frontier:
                for callee in self.callees(fn):
                    if callee.ref not in seen:
                        npath = path + [callee.ref]
                        seen[callee.ref] = (callee, npath)
                        nxt.append((callee, npath))
            frontier = nxt
            depth += 1
        return seen

    def function_for_expr(self, expr: ast.AST,
                          mod: ModuleInfo) -> List[FunctionInfo]:
        """Resolve a callback expression (weakref.ref's 2nd arg) to
        project functions."""
        if isinstance(expr, ast.Name):
            fi = self.module_functions.get((mod.relpath, expr.id))
            if fi:
                return [fi]
            cands = self.by_method_name.get(expr.id, [])
            return cands if 0 < len(cands) <= AMBIGUITY_CUTOFF else []
        if isinstance(expr, ast.Attribute):
            cands = self.by_method_name.get(expr.attr, [])
            return cands if 0 < len(cands) <= AMBIGUITY_CUTOFF else []
        if isinstance(expr, ast.Lambda):
            # treat the lambda body's calls as roots via a synthetic fn
            return [FunctionInfo("<lambda>", f"{mod.qualname(expr)}.<lambda>",
                                 mod, expr)]
        return []


def _own_body_walk(fn_node: ast.AST):
    """Walk a function body without descending into nested function/class
    definitions (their bodies are separate call-graph nodes)."""
    if isinstance(fn_node, ast.Lambda):
        stack = [fn_node.body]
    else:
        body = getattr(fn_node, "body", None)
        if body is None:
            return
        stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
