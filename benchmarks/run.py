"""Run one cell of ``BENCHMARK.json`` and print its result.

    python3 -m benchmarks.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each number compared beside its limit. The same numbers end
standard error. A run exits non-zero and prints no result when the card is
missing or the cell asks for more cards than there are, when the program is
missing, when a process of the run loaded the JAX stack or the JAX package,
or when a traced run's trace failed or left one of the cell's per-layer
metrics unread."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from benchmarks import harness


def _process_start() -> float:
    """When this process started, by the wall clock."""
    try:
        import psutil

        return psutil.Process(os.getpid()).create_time()
    except ImportError:
        return time.time()


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def judge(compared: Dict[str, Any], limits: Dict[str, Any]
          ) -> Tuple[bool, Dict[str, Dict[str, Any]]]:
    """Each number of ``limits`` that the run compared, beside its limit;
    correct when every one is at or under its limit. A number without a
    limit is not correct."""
    checks, ok = {}, True
    for name, spec in limits.items():
        if name.startswith("_"):
            continue
        value = compared.get(name)
        limit = spec.get("limit")
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    if not checks:
        ok = False
    return ok, checks


def per_layer(cell: harness.Cell, readings: Dict[str, Any]
              ) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in cell.per_layer:
        value = harness.metric_reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def missing_metrics(cell: harness.Cell, line: Dict[str, Any]) -> List[str]:
    """The cell's per-layer metrics that a traced run's line lacks, and
    "busy_s" where the line has no device trace."""
    missing = [m["name"] for m in cell.per_layer
               if m["name"] not in line["metrics"]]
    return missing + ([] if "busy_s" in line["device"] else ["busy_s"])


def result_line(cell: harness.Cell, fig: Dict[str, Any], trace: bool
                ) -> Optional[Dict[str, Any]]:
    """The result object of a run's figures, or None where a process of the
    run loaded a forbidden module (named on standard error)."""
    from benchmarks import trace as tr

    found = {"driver": harness.forbidden_modules()}
    for i, p in enumerate(fig["probes"]):
        found[f"device process {i} (pid {p.get('pid')})"] = p["forbidden"]
    bad = {k: v for k, v in found.items() if v}
    if bad:
        for where, mods in bad.items():
            _log(f"[run] forbidden modules in the {where}: {mods}")
        return None
    correct, checks = judge(fig["compared"], cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        metrics = per_layer(cell, fig["readings"])
    else:
        metrics = {name: {"value": v, "unit": units[name]}
                   for name, v in fig["end_to_end"].items() if name in units}
    probes = fig["probes"]
    device = {"platform": "gpu", "kind": probes[0]["device"],
              "count": cell.chips,
              "memory_peak_bytes": max(p["memory_peak_bytes"]
                                       for p in probes)}
    line: Dict[str, Any] = {"correct": correct,
                            "attempted": fig["attempted"],
                            "failed": fig["failed"], "metrics": metrics,
                            "device": device}
    summary = fig["readings"].get("trace")
    if trace and summary:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = tr.breakdown(summary)
    line["checks"] = checks
    return line


def _card_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv: Optional[List[str]] = None) -> int:
    t_start = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_environment()
    cell = harness.resolve_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        _log("[run] no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"[run] the cell asks for {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")
        return 2
    _log(f"[run] {cell.name}: config {cell.config_name}, traffic "
         f"{cell.traffic_name}, driver {cell.driver}, seed {args.seed}, "
         f"{args.seconds:g} s, trace {args.trace}; card "
         f"{_card_limit()}")
    fig = harness.driver_module(cell.driver).run(
        cell, args.seed, args.seconds, bool(args.trace), device="cuda",
        t_start=t_start)
    line = result_line(cell, fig, bool(args.trace))
    if line is None:
        return 3
    if args.trace and missing_metrics(cell, line):
        _log(f"[run] the traced run read no {missing_metrics(cell, line)}: "
             f"no result")
        return 4
    _log(f"[run] compared: {json.dumps(fig['compared'])}")
    _log(f"[run] {time.time() - t_start:.1f} s from the process's start")
    for name, chk in line["checks"].items():
        _log(f"check {name}: {chk['value']} (limit {chk['limit']})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
