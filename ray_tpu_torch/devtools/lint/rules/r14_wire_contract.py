# Copied from ray_tpu/devtools/lint/rules/r14_wire_contract.py.
"""R14 — wire-frame contract drift between send and receive paths.

Invariant: for every RPC/stream method, the msgpack payload keys built
on send paths and the keys read on the registered receive path must
agree — no send-only keys (dead bytes on every frame, or worse, a
feature the receiver silently ignores), no read-but-never-sent keys
(``.get`` masking a key that no sender provides), no type-incoherent
keys (the same key sent as ``str`` in one caller and ``int`` in
another).

Motivating shape (PR 11/18): the mux/shm/batch framing contracts —
single-letter keys like ``"s"`` (stream id), ``"q"`` (session seq),
``"ai"`` (assigned instances) riding ``PushTaskBatchStream`` — hold by
convention only; a typo'd key on one of five send sites ships silently
and surfaces as a hang three modules away.

Detection: send sites are ``client.call/call_future/push/push_nowait/
call_raw_into("Method", {...})`` and ``head_call("Method", {...})``
with a CamelCase string-literal method; thin *send wrappers* — a
function that forwards a method parameter and a payload parameter into
one of those verbs, like ``util/state``'s ``_call(method, payload)`` —
are detected and their call sites indexed as send sites too. Receive
sites come from ``add_handler("Method", fn)`` (including the
``r = server.add_handler`` alias idiom) and ``@server.route("Method")``.
Handler payload reads are
``p["k"]`` / ``p.get("k")`` / ``"k" in p``; any opaque use of the
payload (iterated, forwarded) disables the send-only check for that
method, and the read-never-sent check requires every send site to be a
full dict literal. Optional keys (sent by some literal sites, absent
from others) are fine by design.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..callgraph import (AMBIGUITY_CUTOFF, FunctionInfo, ProjectIndex,
                         _call_name)
from ..model import ModuleInfo, Violation

RULE_ID = "R14"
SUMMARY = ("msgpack frame contract drift: payload key sent but never "
           "read, read but never sent, or sent with incoherent types "
           "across send sites")

_SEND_VERBS = {"call", "call_future", "push", "push_nowait",
               "call_raw_into", "head_call"}
_METHOD_RE = re.compile(r"^[A-Z][A-Za-z0-9]{2,}$")


@dataclass
class _SendSite:
    mod: ModuleInfo
    call: ast.Call
    keys: Dict[str, Tuple[Optional[str], ast.AST]]  # key -> (type, node)
    literal: bool      # full dict literal, no ** expansion


@dataclass
class _Recv:
    mod: ModuleInfo
    fn: FunctionInfo
    reads: Dict[str, ast.AST] = field(default_factory=dict)
    opaque: bool = False


def _type_tag(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant):
        return type(node.value).__name__
    if isinstance(node, ast.Dict):
        return "dict"
    if isinstance(node, (ast.List, ast.Tuple, ast.Set, ast.ListComp)):
        return "list"
    if isinstance(node, ast.JoinedStr):
        return "str"
    return None  # Name / Call / computed — unknown


def _compatible(a: str, b: str) -> bool:
    if a == b or "NoneType" in (a, b):
        return True
    return {a, b} <= {"int", "float"}


def _payload_site(mod: ModuleInfo, call: ast.Call,
                  payload: ast.AST) -> Optional[_SendSite]:
    if not isinstance(payload, ast.Dict):
        return None
    keys: Dict[str, Tuple[Optional[str], ast.AST]] = {}
    literal = True
    for k, v in zip(payload.keys, payload.values):
        if k is None:                       # ** expansion
            literal = False
        elif isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys[k.value] = (_type_tag(v), k)
        else:
            literal = False                 # computed key
    return _SendSite(mod, call, keys, literal)


def _param_name(expr: ast.AST) -> Optional[str]:
    """The parameter a wrapper forwards: a bare ``payload`` Name, or the
    ``payload or {}`` defaulting idiom."""
    if isinstance(expr, ast.BoolOp) and isinstance(expr.op, ast.Or) \
            and expr.values and isinstance(expr.values[0], ast.Name):
        return expr.values[0].id
    return expr.id if isinstance(expr, ast.Name) else None


def _send_wrappers(index: ProjectIndex) -> Dict[Tuple[str, str],
                                                Tuple[int, int]]:
    """(relpath, name) → (method_arg_idx, payload_arg_idx) for thin
    module-level wrappers that forward both positions into a send verb
    (the ``util/state._call(method, payload)`` idiom)."""
    out: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for (relpath, name), fi in index.module_functions.items():
        args = getattr(fi.node, "args", None)
        if args is None:
            continue
        params = [a.arg for a in args.args if a.arg != "self"]
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            _base, attr = _call_name(node.func)
            if attr not in _SEND_VERBS or len(node.args) < 2:
                continue
            mname = _param_name(node.args[0])
            pname = _param_name(node.args[1])
            if mname in params and pname in params and mname != pname:
                out[(relpath, name)] = (params.index(mname),
                                        params.index(pname))
                break
    return out


def _resolve_handler(index: ProjectIndex, mod: ModuleInfo,
                     expr: ast.AST) -> List[FunctionInfo]:
    if isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name) and expr.value.id == "self":
        cname = next((a.name for a in mod.ancestors(expr)
                      if isinstance(a, ast.ClassDef)), None)
        seen: Set[str] = set()
        while cname and cname not in seen:
            seen.add(cname)
            for ci in index.classes.get(cname, []):
                if expr.attr in ci.methods:
                    return [ci.methods[expr.attr]]
            cands = index.classes.get(cname)
            cname = None
            if cands:
                for b in cands[0].bases:
                    if b in index.classes:
                        cname = b
                        break
        return []
    if isinstance(expr, ast.Name):
        fi = index.module_functions.get((mod.relpath, expr.id))
        return [fi] if fi else []
    if isinstance(expr, ast.Attribute):
        cands = index.by_method_name.get(expr.attr, [])
        return cands if 0 < len(cands) <= AMBIGUITY_CUTOFF else []
    return []


def _payload_param(fn: FunctionInfo) -> Optional[str]:
    args = getattr(fn.node, "args", None)
    if args is None:
        return None
    names = [a.arg for a in args.args if a.arg != "self"]
    if len(names) < 2:      # handlers are (conn, payload)
        return None
    return names[-1]


def _scan_handler(index: ProjectIndex, fn: FunctionInfo) -> _Recv:
    recv = _Recv(fn.module, fn)
    pname = _payload_param(fn)
    if pname is None:
        recv.opaque = True
        return recv
    mod = fn.module
    for node in ast.walk(fn.node):
        if not (isinstance(node, ast.Name) and node.id == pname):
            continue
        parent = mod.parent(node)
        if isinstance(parent, ast.Subscript) and parent.value is node:
            sl = parent.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                recv.reads.setdefault(sl.value, parent)
            else:
                recv.opaque = True
        elif isinstance(parent, ast.Attribute) and parent.value is node:
            gp = mod.parent(parent)
            if (parent.attr in ("get", "pop", "setdefault")
                    and isinstance(gp, ast.Call) and gp.func is parent
                    and gp.args
                    and isinstance(gp.args[0], ast.Constant)
                    and isinstance(gp.args[0].value, str)):
                recv.reads.setdefault(gp.args[0].value, gp)
            else:
                recv.opaque = True
        elif isinstance(parent, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn))
                for op in parent.ops) and node in parent.comparators:
            if isinstance(parent.left, ast.Constant) and isinstance(
                    parent.left.value, str):
                recv.reads.setdefault(parent.left.value, parent)
            else:
                recv.opaque = True
        elif isinstance(parent, ast.arg) or parent is None:
            continue
        else:
            # payload forwarded / iterated / defaulted — unknown reads
            recv.opaque = True
    return recv


def check(index: ProjectIndex) -> List[Violation]:
    sends: Dict[str, List[_SendSite]] = {}
    recvs: Dict[str, List[_Recv]] = {}
    wrappers = _send_wrappers(index)

    def add_send(mod: ModuleInfo, node: ast.Call, method: str,
                 payload: Optional[ast.AST]) -> None:
        if payload is None:
            # wrapper call with the payload argument omitted: the
            # wrapper's ``payload or {}`` default sends an empty frame
            site = _SendSite(mod, node, {}, literal=True)
        else:
            site = _payload_site(mod, node, payload)
            if site is None:
                site = _SendSite(mod, node, {}, literal=False)
        sends.setdefault(method, []).append(site)

    for mod in index.modules:
        alias_names: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Attribute) \
                    and node.value.attr == "add_handler":
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        alias_names.add(tgt.id)
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for deco in node.decorator_list:
                    if (isinstance(deco, ast.Call)
                            and isinstance(deco.func, ast.Attribute)
                            and deco.func.attr == "route" and deco.args
                            and isinstance(deco.args[0], ast.Constant)):
                        cls = next((a.name for a in mod.ancestors(node)
                                    if isinstance(a, ast.ClassDef)), None)
                        fi = FunctionInfo(node.name, mod.qualname(node),
                                          mod, node, class_name=cls)
                        recvs.setdefault(deco.args[0].value, []).append(
                            _scan_handler(index, fi))
                continue
            if not isinstance(node, ast.Call):
                continue
            base, attr = _call_name(node.func)
            # handler registration (direct or via the `r = ...` alias)
            is_reg = (attr == "add_handler"
                      or (base is None and attr in alias_names))
            if is_reg and len(node.args) >= 2 and isinstance(
                    node.args[0], ast.Constant) and isinstance(
                        node.args[0].value, str):
                for fi in _resolve_handler(index, mod, node.args[1]):
                    recvs.setdefault(node.args[0].value, []).append(
                        _scan_handler(index, fi))
                continue
            # direct send site
            if (attr in _SEND_VERBS and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _METHOD_RE.match(node.args[0].value)):
                add_send(mod, node, node.args[0].value, node.args[1])
                continue
            # send-wrapper call site (same-module bare name)
            if base is None and isinstance(node.func, ast.Name):
                spec = wrappers.get((mod.relpath, node.func.id))
                if spec is not None:
                    mi, pi = spec
                    if (len(node.args) > mi
                            and isinstance(node.args[mi], ast.Constant)
                            and isinstance(node.args[mi].value, str)
                            and _METHOD_RE.match(node.args[mi].value)):
                        payload = (node.args[pi]
                                   if len(node.args) > pi else None)
                        add_send(mod, node, node.args[mi].value, payload)

    out: List[Violation] = []
    for method in sorted(set(sends) & set(recvs)):
        ssites = sends[method]
        handlers = recvs[method]
        reads: Set[str] = set()
        opaque = False
        for r in handlers:
            reads |= set(r.reads)
            opaque = opaque or r.opaque
        all_sent: Set[str] = set()
        for s in ssites:
            all_sent |= set(s.keys)
        hname = handlers[0].fn.qualname
        hloc = (f"{handlers[0].mod.relpath}:"
                f"{getattr(handlers[0].fn.node, 'lineno', 0)}")

        if not opaque:
            flagged: Set[str] = set()
            for s in ssites:
                for key in sorted(set(s.keys) - reads - flagged):
                    flagged.add(key)
                    _t, knode = s.keys[key]
                    out.append(s.mod.violation(
                        RULE_ID, knode,
                        f"payload key '{key}' of RPC '{method}' is "
                        f"sent here but never read by its handler "
                        f"'{hname}' ({hloc}) — dead bytes on every "
                        f"frame or a silently-ignored feature; drop "
                        f"the key or read it"))

        if ssites and all(s.literal for s in ssites):
            for r in handlers:
                for key in sorted(set(r.reads) - all_sent):
                    out.append(r.mod.violation(
                        RULE_ID, r.reads[key],
                        f"handler '{hname}' reads payload key "
                        f"'{key}' of RPC '{method}', but none of the "
                        f"{len(ssites)} literal send site(s) ever "
                        f"sends it — the read can only see the "
                        f"default; fix the key or delete the read"))

        tags: Dict[str, Tuple[str, _SendSite]] = {}
        for s in ssites:
            for key, (tag, knode) in sorted(s.keys.items()):
                if tag is None:
                    continue
                prev = tags.get(key)
                if prev is None:
                    tags[key] = (tag, s)
                elif not _compatible(prev[0], tag):
                    out.append(s.mod.violation(
                        RULE_ID, knode,
                        f"payload key '{key}' of RPC '{method}' is "
                        f"sent as {tag} here but as {prev[0]} at "
                        f"{prev[1].mod.relpath}:"
                        f"{getattr(prev[1].call, 'lineno', 0)} — "
                        f"type-incoherent wire contract; the handler "
                        f"'{hname}' cannot rely on either"))
    return out
