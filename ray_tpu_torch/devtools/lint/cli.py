# Copied from ray_tpu/devtools/lint/cli.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""CLI for the raylint invariant checker.

Usage:
    python -m ray_tpu_torch.devtools.lint ray_tpu_torch [options]

Exit codes: 0 clean (grandfathered-only is clean), 1 violations or parse
errors (or stale baseline under --strict-baseline), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from . import baseline as baseline_mod
from .engine import default_baseline_path, run_lint
from .rules import rule_catalog


def _changed_files(project_root: str) -> List[str]:
    """Project-relative .py files touched vs HEAD (staged, unstaged, and
    untracked) — the ``--changed`` report scope."""
    out: List[str] = []
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=project_root, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if res.returncode != 0:
            continue
        for line in res.stdout.splitlines():
            line = line.strip()
            if line.endswith(".py") and line not in out:
                out.append(line)
    return out


def _to_sarif(result) -> dict:
    """SARIF 2.1.0 — one run, one rule descriptor per rule id, one
    result per failing violation (grandfathered hits are omitted: SARIF
    consumers treat every result as actionable)."""
    catalog = {r["id"]: r["summary"] for r in rule_catalog()}
    rule_ids = sorted({v.rule for v in result.violations} | set(catalog))
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "raylint",
                "informationUri": "ray_tpu_torch/devtools/lint",
                "rules": [{"id": rid,
                           "shortDescription":
                               {"text": catalog.get(rid, rid)}}
                          for rid in rule_ids],
            }},
            "results": [{
                "ruleId": v.rule,
                "level": "error",
                "message": {"text": v.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": v.path},
                    "region": {"startLine": v.line,
                               "startColumn": v.col + 1},
                }}],
                "partialFingerprints": {"raylintKey/v1": v.key()},
            } for v in result.violations],
        }],
    }


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.devtools.lint",
        description=("AST/CFG invariant checker for the ray_tpu_torch runtime's "
                     "concurrency, serialization, and lifecycle "
                     "contracts."))
    p.add_argument("paths", nargs="*", default=["ray_tpu_torch"],
                   help="files/directories to analyze (default: ray_tpu_torch)")
    p.add_argument("--project-root", default=None,
                   help="root for relative paths in reports (default: cwd)")
    p.add_argument("--rules", default=None,
                   help="comma-separated subset, e.g. R1,R4 (default: all)")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default="text")
    p.add_argument("--changed", action="store_true",
                   help="report only violations in files changed vs git "
                        "HEAD (plus untracked); the call-graph index "
                        "still covers all of `paths`, so cross-module "
                        "rules keep full precision")
    p.add_argument("--dump-lock-graph", metavar="PATH", default=None,
                   help="also write the R12 static lock-order graph as "
                        "JSON (consumed by the RAY_TPU_TORCH_SANITIZE=1 "
                        "runtime sanitizer)")
    p.add_argument("--baseline", default=None,
                   help="baseline JSON (default: the checked-in "
                        "devtools/lint/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: every violation fails")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to exactly the current "
                        "unsuppressed violations (review the diff: it "
                        "must only shrink)")
    p.add_argument("--strict-baseline", action="store_true",
                   help="also fail on stale baseline entries (used by the "
                        "tier-1 test so the baseline monotonically "
                        "shrinks)")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for r in rule_catalog():
            print(f"{r['id']}: {r['summary']}")
        return 0

    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    if rules:
        known = {r["id"] for r in rule_catalog()}
        bad = [r for r in rules if r.upper() not in known]
        if bad:
            print(f"unknown rule(s): {', '.join(bad)} "
                  f"(valid: {', '.join(sorted(known))})", file=sys.stderr)
            return 2
    if args.update_baseline and rules:
        # A subset run only produces that subset's violations; rewriting
        # the baseline from it would silently delete every other rule's
        # grandfathered entries.
        print("--update-baseline requires a full-rule run (drop --rules)",
              file=sys.stderr)
        return 2
    baseline_path = None if args.no_baseline else (
        args.baseline or default_baseline_path())

    report_only = None
    if args.changed:
        root = args.project_root or os.getcwd()
        report_only = _changed_files(root)

    result = run_lint(args.paths, project_root=args.project_root,
                      rules=rules, baseline_path=baseline_path,
                      report_only=report_only)

    if args.dump_lock_graph:
        from . import concurrency
        graph = concurrency.get(result._index).static_graph()
        with open(args.dump_lock_graph, "w", encoding="utf-8") as f:
            json.dump(graph, f, indent=1, sort_keys=True)
            f.write("\n")

    if args.update_baseline:
        target = args.baseline or default_baseline_path()
        entries = baseline_mod.counts(result.violations
                                      + result.grandfathered)
        old = baseline_mod.load(target)
        baseline_mod.save(target, entries)
        grew = sum(entries.values()) > sum(old.values())
        print(f"baseline written: {target} "
              f"({sum(entries.values())} entries, was {sum(old.values())})")
        if grew:
            print("WARNING: baseline GREW — the tier-1 contract only "
                  "allows it to shrink; fix or `# raylint: disable=` new "
                  "violations instead", file=sys.stderr)
        return 0

    if args.format == "json":
        print(json.dumps(result.to_dict(), indent=1))
    elif args.format == "sarif":
        print(json.dumps(_to_sarif(result), indent=1))
    else:
        for v in result.violations:
            print(v.format())
        if result.grandfathered:
            print(f"-- {len(result.grandfathered)} grandfathered "
                  f"violation(s) in the baseline "
                  f"({os.path.basename(baseline_path or '')}); new code "
                  f"must not add to them")
        if result.stale_baseline:
            print(f"-- {len(result.stale_baseline)} stale baseline "
                  f"entr(y/ies) no longer match — shrink with "
                  f"--update-baseline:")
            for k in result.stale_baseline:
                print(f"   {k}")
        for e in result.parse_errors:
            print(f"parse error: {e}", file=sys.stderr)
        print(f"raylint: {result.files_scanned} files, "
              f"{len(result.violations)} failing, "
              f"{len(result.grandfathered)} grandfathered, "
              f"{result.suppressed_count} inline-disabled "
              f"({result.elapsed_s:.2f}s)")

    if result.violations or result.parse_errors:
        return 1
    if args.strict_baseline and result.stale_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
