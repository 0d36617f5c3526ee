# Copied from ray_tpu/devtools/lint/model.py.
"""Core data model shared by the lint engine, rules, and baseline manager."""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

# `# raylint: disable=R1` or `# raylint: disable=R1,R4 -- reason`
_DISABLE_RE = re.compile(r"#\s*raylint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Violation:
    """One rule hit, attributed to a source location.

    ``key()`` deliberately excludes the line number: baseline entries must
    survive unrelated edits above the flagged statement, so identity is
    (file, rule, enclosing symbol, normalized source text) plus an
    occurrence index assigned by the baseline manager for duplicates.
    """

    rule: str       # "R1".."R8"
    path: str       # project-relative posix path
    line: int       # 1-based
    col: int
    message: str
    symbol: str     # enclosing qualname ("MemoryStore.put", "<module>")
    snippet: str    # stripped source of the flagged line

    def key(self) -> str:
        norm = " ".join(self.snippet.split())
        return f"{self.path}::{self.rule}::{self.symbol}::{norm}"

    def to_dict(self) -> Dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "symbol": self.symbol,
            "snippet": self.snippet,
            "key": self.key(),
        }

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")


class ModuleInfo:
    """Parsed view of one source file: AST + parent links + disable map.

    Parent links let rules walk *up* (is this call inside a lambda passed
    to retry_call? is this create_task a bare statement?), which plain
    ``ast.walk`` cannot answer.
    """

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.Module):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.disables: Dict[int, Set[str]] = self._parse_disables()

    def _parse_disables(self) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(line)
            if m:
                rules = {r.strip().upper() for r in m.group(1).split(",")
                         if r.strip()}
                out[i] = rules
        return out

    def is_disabled(self, rule: str, line: int) -> bool:
        """A violation at ``line`` is suppressed by a disable comment on
        the line itself or anywhere in the contiguous block of comment
        lines directly above it (multi-line justifications are the
        expected idiom: ``# raylint: disable=R6 -- long-poll by design:``
        followed by continuation comment lines)."""
        if self._has_disable(rule, line):
            return True
        ln = line - 1
        while ln >= 1 and self.lines[ln - 1].strip().startswith("#"):
            if self._has_disable(rule, ln):
                return True
            ln -= 1
        return False

    def _has_disable(self, rule: str, line: int) -> bool:
        rules = self.disables.get(line)
        return bool(rules and (rule in rules or "ALL" in rules))

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def qualname(self, node: ast.AST) -> str:
        """Dotted class/function path enclosing ``node`` ('<module>' at
        top level)."""
        parts: List[str] = []
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(anc.name)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            parts.insert(0, node.name)
        return ".".join(reversed(parts)) or "<module>"

    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def violation(self, rule: str, node: ast.AST, message: str) -> Violation:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Violation(rule=rule, path=self.relpath, line=line, col=col,
                         message=message, symbol=self.qualname(node),
                         snippet=self.snippet_at(line))


@dataclass
class LintResult:
    """Outcome of one lint run, pre-split by the baseline manager."""

    violations: List[Violation] = field(default_factory=list)   # unsuppressed
    grandfathered: List[Violation] = field(default_factory=list)
    suppressed_count: int = 0      # inline-disabled
    stale_baseline: List[str] = field(default_factory=list)     # unmatched keys
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations and not self.parse_errors

    def to_dict(self) -> Dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "elapsed_s": round(self.elapsed_s, 3),
            "violations": [v.to_dict() for v in self.violations],
            "grandfathered": [v.to_dict() for v in self.grandfathered],
            "suppressed_count": self.suppressed_count,
            "stale_baseline": list(self.stale_baseline),
            "parse_errors": list(self.parse_errors),
        }
