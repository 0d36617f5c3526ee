# Copied from ray_tpu/devtools/lint/engine.py.
"""Lint engine: file discovery, parsing, rule driving, suppression.

Two rule shapes are supported (see rules/__init__.py): per-module
``check_module(mod, index)`` and project-wide ``check(index)`` (for
rules that need the cross-module call graph or the config flag table).
Inline ``# raylint: disable=Rn`` comments suppress at the site; the
baseline manager grandfathers historical debt; everything else fails.
"""

from __future__ import annotations

import ast
import os
import time
from typing import Dict, Iterable, List, Optional

from . import baseline as baseline_mod
from .callgraph import ProjectIndex
from .model import LintResult, ModuleInfo, Violation
from .rules import ALL_RULES, RULES_BY_ID

_SKIP_DIRS = {"__pycache__", ".git", "node_modules"}


def discover_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in _SKIP_DIRS)
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
    return out


def parse_modules(files: List[str], project_root: str
                  ) -> (List[ModuleInfo], List[str]):
    mods: List[ModuleInfo] = []
    errors: List[str] = []
    for path in files:
        try:
            with open(path, "r", encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            errors.append(f"{path}: {e}")
            continue
        rel = os.path.relpath(os.path.abspath(path),
                              os.path.abspath(project_root))
        mods.append(ModuleInfo(path, rel.replace(os.sep, "/"), source, tree))
    return mods, errors


def run_lint(paths: Iterable[str],
             project_root: Optional[str] = None,
             rules: Optional[List[str]] = None,
             baseline_path: Optional[str] = None,
             report_only: Optional[Iterable[str]] = None) -> LintResult:
    """Run the analyzer; returns a LintResult with failing /
    grandfathered / suppressed violations split out.

    ``baseline_path=None`` means no baseline (every unsuppressed
    violation fails); pass the checked-in file for the tier-1 contract.
    ``report_only`` restricts *reported* violations to those
    project-relative paths while the index (and therefore call-graph
    precision) still covers everything in ``paths`` — the ``--changed``
    mode: lint the diff against the full-tree index.
    """
    t0 = time.monotonic()
    project_root = project_root or os.getcwd()
    files = discover_files(paths)
    mods, errors = parse_modules(files, project_root)
    index = ProjectIndex(mods)
    # rules that consult files outside the module set (R8's README knob
    # tables) anchor themselves here
    index.project_root = os.path.abspath(project_root)

    selected = ALL_RULES if not rules else [
        RULES_BY_ID[r.upper()] for r in rules]

    raw: List[Violation] = []
    for rule in selected:
        if hasattr(rule, "check"):
            raw.extend(rule.check(index))
        if hasattr(rule, "check_module"):
            for mod in mods:
                raw.extend(rule.check_module(mod, index))
    raw.sort(key=lambda v: (v.path, v.line, v.rule))

    if report_only is not None:
        keep = {p.replace(os.sep, "/") for p in report_only}
        raw = [v for v in raw if v.path in keep]

    by_mod: Dict[str, ModuleInfo] = {m.relpath: m for m in mods}
    unsuppressed: List[Violation] = []
    suppressed = 0
    for v in raw:
        mod = by_mod.get(v.path)
        if mod is not None and mod.is_disabled(v.rule, v.line):
            suppressed += 1
        else:
            unsuppressed.append(v)

    bl = baseline_mod.load(baseline_path) if baseline_path else {}
    failing, grandfathered, stale = baseline_mod.split(unsuppressed, bl)
    if report_only is not None:
        stale = []  # a partial report can't prove baseline entries stale

    result = LintResult(
        violations=failing,
        grandfathered=grandfathered,
        suppressed_count=suppressed,
        stale_baseline=stale,
        files_scanned=len(mods),
        parse_errors=errors,
        elapsed_s=time.monotonic() - t0,
    )
    result._index = index  # CLI extras (--dump-lock-graph) reuse it
    return result


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")
