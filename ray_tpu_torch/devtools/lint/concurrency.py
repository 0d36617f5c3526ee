# Copied from ray_tpu/devtools/lint/concurrency.py.
"""Shared interprocedural concurrency analysis (ISSUE 19).

One pass over the project builds everything the R12/R13 rule families
(and the runtime sanitizer's static lock graph) consume:

- **Lock declarations** with identity: ``self.X = threading.Lock()``
  inside ``class C`` becomes lock id ``C.X`` (shared by subclasses that
  inherit the attr); module-level ``X = Lock()`` becomes
  ``<relpath>::X``. Identity deliberately collapses instances — the
  classic lock-order analysis granularity.
- **Lexical lock events** per function: every acquisition site with the
  set of lock ids already held (``with``-nesting), and every call made
  while holding a lock.
- **Eventually-acquired sets** (EA): fixpoint over the call graph —
  which lock ids can a call into ``f`` end up acquiring, transitively.
  ``A held`` + ``call g`` + ``B ∈ EA(g)`` yields the interprocedural
  ordering edge ``A → B``.
- **The lock-order graph** with one witness site per edge, and its
  strongly-connected components (a component with ≥2 locks is a
  potential deadlock cycle).
- **Thread-affinity domains** per function: ``loop`` (async defs, and
  sync functions reached from ``call_soon*``/``create_task``/RPC
  handler roots), ``thread`` (``threading.Thread`` targets,
  ``run_in_executor`` callables), ``gc`` (``__del__``/weakref
  callbacks), propagated to fixpoint over the same call graph. Nested
  defs/lambdas inherit their enclosing function's domains (the
  registered-callback heuristic) but never leak their lock
  acquisitions into the enclosing frame (callbacks run *later*).

Deliberate approximations, same philosophy as callgraph.py: name-based
resolution with an ambiguity cutoff, lexical (not path-sensitive) held
sets, and async bodies pinned to the ``loop`` domain only — a thread
calling an async def merely *creates* a coroutine.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import (FunctionInfo, ProjectIndex, _call_name,
                        _is_lock_ctor)
from .model import ModuleInfo

# callback-registration vocabulary: arg index holding the callable that
# will run ON THE EVENT LOOP
_LOOP_CB_ARG = {
    "call_soon": 0,
    "call_soon_threadsafe": 0,
    "call_later": 1,
    "call_at": 1,
    "create_task": 0,
    "ensure_future": 0,
    "run_coroutine_threadsafe": 0,
    "add_done_callback": 0,
    "spawn_tracked": 0,
}

# callables that will run on a NON-loop thread
_THREAD_CB_ARG = {
    "run_in_executor": 1,
}

DOMAINS = ("loop", "thread", "gc")


@dataclass(frozen=True)
class LockDecl:
    """One lock *declaration* site; the unit of lock identity."""

    id: str        # "Class.attr" or "<relpath>::NAME"
    kind: str      # "Lock" | "RLock"
    relpath: str
    line: int


@dataclass
class FnNode:
    info: FunctionInfo
    ref: str
    parent_ref: Optional[str]       # enclosing function (nested defs)
    is_async: bool
    # analysis products (filled by _analyze_fn)
    acquires: List[Tuple[LockDecl, ast.AST, Tuple[str, ...]]] = \
        field(default_factory=list)
    calls: List[Tuple[ast.AST, Tuple[str, ...], List[str]]] = \
        field(default_factory=list)
    callee_refs: List[str] = field(default_factory=list)
    self_writes: List[Tuple[str, ast.AST, Tuple[str, ...]]] = \
        field(default_factory=list)  # (attr, node, held lock ids)


@dataclass
class OrderEdge:
    src: str
    dst: str
    fn: FnNode                       # function containing the witness
    node: ast.AST                    # acquire or call site
    via: Optional[str] = None        # callee ref for interprocedural edges


def _is_nonblocking_acquire(call: ast.Call) -> bool:
    """``acquire(False)`` / ``acquire(blocking=False)`` cannot deadlock
    by ordering — the caller handles refusal."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is False:
        return True
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    return False


class Concurrency:
    """Computed once per ProjectIndex (see :func:`get`)."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self.class_locks: Dict[Tuple[str, str], LockDecl] = {}
        self.mod_locks: Dict[Tuple[str, str], LockDecl] = {}
        self.fns: Dict[str, FnNode] = {}
        self.ea: Dict[str, Set[str]] = {}
        self.edges: Dict[Tuple[str, str], OrderEdge] = {}
        self.domains: Dict[str, Set[str]] = {}
        self.lock_decls: Dict[str, LockDecl] = {}
        self._index_lock_decls()
        self._index_functions()
        for fn in self.fns.values():
            self._analyze_fn(fn)
        self._compute_ea()
        self._build_edges()
        self._compute_domains()

    # ------------------------------------------------------- lock decls
    def _index_lock_decls(self) -> None:
        for mod in self.index.modules:
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                kind = _is_lock_ctor(node.value)
                if not kind:
                    continue
                cls = next((a for a in mod.ancestors(node)
                            if isinstance(a, ast.ClassDef)), None)
                for tgt in node.targets:
                    if (cls is not None and isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        decl = LockDecl(f"{cls.name}.{tgt.attr}", kind,
                                        mod.relpath, node.lineno)
                        self.class_locks.setdefault((cls.name, tgt.attr),
                                                    decl)
                        self.lock_decls.setdefault(decl.id, decl)
                    elif (cls is None and isinstance(tgt, ast.Name)
                          and not any(isinstance(
                              a, (ast.FunctionDef, ast.AsyncFunctionDef))
                              for a in mod.ancestors(node))):
                        decl = LockDecl(f"{mod.relpath}::{tgt.id}", kind,
                                        mod.relpath, node.lineno)
                        self.mod_locks.setdefault((mod.relpath, tgt.id),
                                                  decl)
                        self.lock_decls.setdefault(decl.id, decl)

    def resolve_lock(self, fn: FunctionInfo,
                     expr: ast.AST) -> Optional[LockDecl]:
        """Resolve a with-item / acquire receiver to its declaration,
        walking project base classes for inherited lock attrs."""
        if isinstance(expr, ast.Attribute) and isinstance(
                expr.value, ast.Name) and expr.value.id == "self":
            cname = fn.class_name
            seen: Set[str] = set()
            while cname and cname not in seen:
                seen.add(cname)
                decl = self.class_locks.get((cname, expr.attr))
                if decl is not None:
                    return decl
                cands = self.index.classes.get(cname)
                nxt = None
                if cands:
                    for b in cands[0].bases:
                        if b in self.index.classes:
                            nxt = b
                            break
                cname = nxt
            return None
        if isinstance(expr, ast.Name):
            return self.mod_locks.get((fn.module.relpath, expr.id))
        return None

    # -------------------------------------------------------- functions
    def _index_functions(self) -> None:
        for mod in self.index.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.Lambda)):
                    continue
                qn = mod.qualname(node)
                if isinstance(node, ast.Lambda):
                    qn = f"{qn}.<lambda@{node.lineno}>"
                ref = f"{mod.relpath}::{qn}"
                if ref in self.fns:  # same-name def in one suite
                    ref = f"{ref}@{node.lineno}"
                cls = next((a.name for a in mod.ancestors(node)
                            if isinstance(a, ast.ClassDef)), None)
                name = getattr(node, "name", "<lambda>")
                info = FunctionInfo(name, qn, mod, node, class_name=cls)
                parent = next(
                    (a for a in mod.ancestors(node)
                     if isinstance(a, (ast.FunctionDef,
                                       ast.AsyncFunctionDef, ast.Lambda))),
                    None)
                pref = None
                if parent is not None:
                    pq = mod.qualname(parent)
                    if isinstance(parent, ast.Lambda):
                        pq = f"{pq}.<lambda@{parent.lineno}>"
                    pref = f"{mod.relpath}::{pq}"
                self.fns[ref] = FnNode(
                    info, ref, pref,
                    isinstance(node, ast.AsyncFunctionDef))

    def ref_of(self, fi: FunctionInfo) -> str:
        return f"{fi.module.relpath}::{fi.qualname}"

    # --------------------------------------------- per-function analysis
    def _analyze_fn(self, fn: FnNode) -> None:
        index = self.index
        node = fn.info.node
        body = [node.body] if isinstance(node, ast.Lambda) \
            else list(getattr(node, "body", []))

        def visit(n: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                return  # separate node; deferred execution
            if isinstance(n, ast.With):
                inner = list(held)
                for item in n.items:
                    decl = self.resolve_lock(fn.info, item.context_expr)
                    if decl is not None:
                        fn.acquires.append((decl, n, tuple(inner)))
                        inner.append(decl.id)
                    else:
                        visit(item.context_expr, tuple(held))
                for child in n.body:
                    visit(child, tuple(inner))
                return
            if isinstance(n, ast.Call):
                base, attr = _call_name(n.func)
                if attr == "acquire" and isinstance(n.func, ast.Attribute):
                    decl = self.resolve_lock(fn.info, n.func.value)
                    if decl is not None and not _is_nonblocking_acquire(n):
                        fn.acquires.append((decl, n, held))
                resolved = index.resolve_call(fn.info, n)
                refs = [self.ref_of(c) for c in resolved]
                refs = [r for r in refs if r in self.fns]
                if refs:
                    fn.calls.append((n, held, refs))
                    fn.callee_refs.extend(refs)
            elif isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if isinstance(n, ast.AnnAssign) and n.value is None:
                    tgts = []  # bare annotation, not a mutation
                else:
                    tgts = n.targets if isinstance(n, ast.Assign) else \
                        [n.target]
                for tgt in tgts:
                    if (isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        fn.self_writes.append((tgt.attr, n, held))
            for child in ast.iter_child_nodes(n):
                visit(child, held)

        for stmt in body:
            visit(stmt, ())

    # ------------------------------------------------------ EA fixpoint
    def _compute_ea(self) -> None:
        ea: Dict[str, Set[str]] = {
            ref: {d.id for d, _, _ in fn.acquires}
            for ref, fn in self.fns.items()}
        for _ in range(40):  # bounded fixpoint (call-chain depth)
            changed = False
            for ref, fn in self.fns.items():
                cur = ea[ref]
                before = len(cur)
                for cal in fn.callee_refs:
                    cur |= ea.get(cal, set())
                if len(cur) != before:
                    changed = True
            if not changed:
                break
        self.ea = ea

    # ------------------------------------------------------- lock graph
    def _add_edge(self, src: str, dst: str, fn: FnNode, node: ast.AST,
                  via: Optional[str]) -> None:
        if src == dst:
            return  # same-identity re-acquire: R1/RLock territory
        cur = self.edges.get((src, dst))
        if cur is None or (cur.via is not None and via is None):
            self.edges[(src, dst)] = OrderEdge(src, dst, fn, node, via)

    def _build_edges(self) -> None:
        for fn in self.fns.values():
            for decl, node, held in fn.acquires:
                for a in held:
                    self._add_edge(a, decl.id, fn, node, None)
            for node, held, refs in fn.calls:
                if not held:
                    continue
                for ref in refs:
                    for b in self.ea.get(ref, ()):
                        for a in held:
                            self._add_edge(a, b, fn, node, ref)

    def lock_sccs(self) -> List[List[str]]:
        """Strongly-connected components of the lock-order graph with
        more than one lock (iterative Tarjan)."""
        adj: Dict[str, List[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        idx: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]
        for root in adj:
            if root in idx:
                continue
            work = [(root, iter(adj[root]))]
            idx[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in idx:
                        idx[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on.add(w)
                        work.append((w, iter(adj[w])))
                        advanced = True
                        break
                    elif w in on:
                        low[v] = min(low[v], idx[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == idx[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        out.append(sorted(comp))
        return out

    def explain_path(self, start_ref: str, lock_id: str,
                     max_depth: int = 12) -> List[str]:
        """Qualname chain from ``start_ref`` to a function that directly
        acquires ``lock_id`` (for edge messages)."""
        seen = {start_ref}
        frontier = [(start_ref, [start_ref])]
        for _ in range(max_depth):
            nxt = []
            for ref, path in frontier:
                fn = self.fns.get(ref)
                if fn is None:
                    continue
                if any(d.id == lock_id for d, _, _ in fn.acquires):
                    return [p.split("::")[-1] for p in path]
                for cal in fn.callee_refs:
                    if cal not in seen and lock_id in self.ea.get(cal,
                                                                  ()):
                        seen.add(cal)
                        nxt.append((cal, path + [cal]))
            frontier = nxt
            if not frontier:
                break
        return [start_ref.split("::")[-1], "...", lock_id]

    # --------------------------------------------------------- affinity
    def _resolve_callback(self, mod: ModuleInfo, expr: ast.AST,
                          encl_class: Optional[str]) -> List[str]:
        if isinstance(expr, ast.Call):  # create_task(self.foo(...))
            expr = expr.func
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and encl_class):
            cname = encl_class
            seen: Set[str] = set()
            while cname and cname not in seen:
                seen.add(cname)
                for ci in self.index.classes.get(cname, []):
                    if expr.attr in ci.methods:
                        return [self.ref_of(ci.methods[expr.attr])]
                cands = self.index.classes.get(cname)
                cname = None
                if cands:
                    for b in cands[0].bases:
                        if b in self.index.classes:
                            cname = b
                            break
            # fall through to by-name
            expr = ast.Name(id="\x00none")  # force by-name miss below
        out = []
        for fi in self.index.function_for_expr(expr, mod):
            ref = self.ref_of(fi)
            if ref in self.fns:
                out.append(ref)
        return out

    def _domain_roots(self) -> Dict[str, Set[str]]:
        roots: Dict[str, Set[str]] = {d: set() for d in DOMAINS}
        for ref, fn in self.fns.items():
            if fn.is_async:
                roots["loop"].add(ref)
            if fn.info.name == "__del__" and fn.info.class_name:
                roots["gc"].add(ref)
        for expr, mod in self.index.weakref_callbacks:
            cls = next((a.name for a in mod.ancestors(expr)
                        if isinstance(a, ast.ClassDef)), None)
            roots["gc"].update(self._resolve_callback(mod, expr, cls))
        for mod in self.index.modules:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                base, attr = _call_name(node.func)
                cls = next((a.name for a in mod.ancestors(node)
                            if isinstance(a, ast.ClassDef)), None)
                if attr in _LOOP_CB_ARG:
                    i = _LOOP_CB_ARG[attr]
                    if len(node.args) > i:
                        roots["loop"].update(self._resolve_callback(
                            mod, node.args[i], cls))
                elif attr in _THREAD_CB_ARG:
                    i = _THREAD_CB_ARG[attr]
                    if len(node.args) > i:
                        roots["thread"].update(self._resolve_callback(
                            mod, node.args[i], cls))
                elif attr == "Thread":
                    tgt = None
                    for kw in node.keywords:
                        if kw.arg == "target":
                            tgt = kw.value
                    if tgt is None and node.args:
                        tgt = node.args[0]
                    if tgt is not None:
                        roots["thread"].update(self._resolve_callback(
                            mod, tgt, cls))
        return roots

    def _compute_domains(self) -> None:
        domains: Dict[str, Set[str]] = {ref: set() for ref in self.fns}
        roots = self._domain_roots()
        for d, refs in roots.items():
            for r in refs:
                domains[r].add(d)
        # union graph: callee edges + enclosing->nested inheritance
        succ: Dict[str, List[str]] = {ref: list(fn.callee_refs)
                                      for ref, fn in self.fns.items()}
        for ref, fn in self.fns.items():
            if fn.parent_ref and fn.parent_ref in succ:
                succ[fn.parent_ref].append(ref)
        for _ in range(40):
            changed = False
            for ref, fn in self.fns.items():
                mine = domains[ref]
                if not mine:
                    continue
                for cal in succ.get(ref, ()):
                    tgt = self.fns.get(cal)
                    if tgt is None:
                        continue
                    add = mine if not tgt.is_async else (
                        mine & {"loop"})  # async bodies only run on loops
                    if add - domains[cal]:
                        domains[cal] |= add
                        changed = True
            if not changed:
                break
        self.domains = domains

    # -------------------------------------------------------- sanitizer
    def static_graph(self) -> Dict:
        """JSON-able static lock graph the runtime sanitizer asserts
        against (lock identity = declaration file:line)."""
        return {
            "locks": {
                d.id: {"decl": f"{d.relpath}:{d.line}", "kind": d.kind}
                for d in self.lock_decls.values()},
            "edges": sorted(
                [a, b, (f"{e.fn.info.module.relpath}:"
                        f"{getattr(e.node, 'lineno', 0)}")]
                for (a, b), e in self.edges.items()),
        }


def get(index: ProjectIndex) -> Concurrency:
    """Memoized per index — R12 and R13 share one analysis pass."""
    cached = getattr(index, "_concurrency", None)
    if cached is None:
        cached = Concurrency(index)
        index._concurrency = cached
    return cached
