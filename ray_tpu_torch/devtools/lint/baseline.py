# Copied from ray_tpu/devtools/lint/baseline.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Baseline manager: grandfathered violations that may only shrink.

The baseline is a checked-in JSON file mapping violation keys (see
``Violation.key()`` — line-number free, so unrelated edits don't churn
it) to occurrence counts. Semantics:

- A violation whose key still has baseline budget is *grandfathered*:
  reported, but not failing. New code can never add to the file except
  via an explicit ``--update-baseline`` (which a reviewer sees as a
  diff growing the file — the thing the tier-1 test forbids).
- A baseline entry matching nothing is *stale*: the violation was fixed
  but the entry lingers. ``--strict-baseline`` (used by the tier-1
  test) fails the run until ``--update-baseline`` shrinks the file, so
  the baseline monotonically ratchets toward empty.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from .model import Violation


def load(path: str) -> Dict[str, int]:
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", data) if isinstance(data, dict) else {}
    return {str(k): int(v) for k, v in entries.items()}


def save(path: str, entries: Dict[str, int]) -> None:
    payload = {
        "comment": ("raylint grandfathered violations — this file may "
                    "only shrink; regenerate with `python -m "
                    "ray_tpu_torch.devtools.lint ray_tpu_torch --update-baseline`"),
        "entries": {k: entries[k] for k in sorted(entries)},
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=False)
        f.write("\n")


def split(violations: List[Violation], baseline: Dict[str, int]
          ) -> Tuple[List[Violation], List[Violation], List[str]]:
    """(failing, grandfathered, stale_keys)."""
    budget = dict(baseline)
    failing: List[Violation] = []
    grandfathered: List[Violation] = []
    for v in violations:
        k = v.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            grandfathered.append(v)
        else:
            failing.append(v)
    stale = [k for k, n in budget.items() if n > 0]
    return failing, grandfathered, stale


def counts(violations: List[Violation]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for v in violations:
        out[v.key()] = out.get(v.key(), 0) + 1
    return out
