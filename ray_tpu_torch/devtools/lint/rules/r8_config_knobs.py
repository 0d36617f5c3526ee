# Copied from ray_tpu/devtools/lint/rules/r8_config_knobs.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""R8 — config knob hygiene: reads, declarations, and docs must agree.

Three invariants over the ``_flag(...)`` table:

- **Unknown read**: ``CONFIG.<flag>`` resolves through
  ``_Config.__getattr__`` which raises ``AttributeError`` for names
  missing from the table — but only *when the line executes*, which for
  rarely-taken paths (failure handling, chaos branches) is production,
  not tests.
- **Dead knob** (full-tree runs only — absence evidence): a flag
  declared in the table but never read anywhere (``CONFIG.name``,
  ``getattr(CONFIG, "name")``, the quoted name, or its
  ``RAY_TPU_TORCH_NAME`` env form) is config surface that lies to operators —
  setting it does nothing. The PR 19 audit found 13 of these, declared
  for reference parity with mechanisms that were never built.
- **Doc drift**: a knob named in one of README's ``**Knobs**``
  paragraphs that is not in the table documents an override that
  silently doesn't exist (the reverse direction — undocumented knobs —
  is deliberate: internal tuning knobs outnumber operator-facing ones).

Detection: the flag table is parsed from ``config.py``'s ``_flag("name",
default)`` calls; reads are scanned per module (AST for attribute/
getattr forms, source text for quoted/env forms to catch dynamic
lookups); README is scanned only when the index carries a project root.

The README is shared with the JAX package, so its ``**Knobs**``
paragraphs document knobs in their ``RAY_TPU_<NAME>`` env form. The port
keeps the reference's flag names and reads each as
``RAY_TPU_TORCH_<NAME>``, so the drift check compares the bare knob name
with the port's ``_flag`` table: a documented knob that the port does not
declare is a real finding (the port dropped a knob the README promises),
whatever prefix the paragraph shows.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Set, Tuple

from ..model import ModuleInfo, Violation

RULE_ID = "R8"
SUMMARY = ("config knob drift: CONFIG.<name> missing from the _flag "
           "table, a declared knob never read anywhere (dead config "
           "surface), or a README-documented knob that doesn't exist")

# knob-name shape inside a README **Knobs** paragraph; uppercase tokens
# (RAY_TPU_* and RAY_TPU_TORCH_* env hooks) and dotted tokens (filenames)
# never match
_KNOB_TOKEN_RE = re.compile(r"`([a-z][a-z0-9_]*_[a-z0-9_]+)`")
# raw env hooks documented alongside knobs but intentionally not flags
_ENV_HOOK_ALLOWLIST = {"fault_injection", "fault_file"}
# dead-knob scanning needs the whole tree as evidence; subset runs
# (fixtures, --changed, single dirs) can't prove absence
_FULL_TREE_MIN_MODULES = 100

_CONFIG_METHODS = {"apply_cluster_config", "snapshot", "to_json"}
_CONFIG_FILE_SUFFIX = "_private/config.py"


def _flag_decls(index) -> List[Tuple[ModuleInfo, ast.Call, str]]:
    out: List[Tuple[ModuleInfo, ast.Call, str]] = []
    for mod in index.modules:
        if not mod.relpath.replace("\\", "/").endswith(_CONFIG_FILE_SUFFIX):
            continue
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "_flag" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append((mod, node, node.args[0].value))
    return out


def _check_dead_knobs(index, decls) -> List[Violation]:
    if len(index.modules) < _FULL_TREE_MIN_MODULES:
        return []
    alive: Set[str] = set()
    names = [name for _m, _n, name in decls]
    for mod in index.modules:
        if mod.relpath.replace("\\", "/").endswith(_CONFIG_FILE_SUFFIX):
            continue
        src = mod.source
        for name in names:
            if name in alive:
                continue
            if (f"CONFIG.{name}" in src or f'"{name}"' in src
                    or f"'{name}'" in src
                    or f"RAY_TPU_TORCH_{name.upper()}" in src):
                alive.add(name)
    out: List[Violation] = []
    for mod, node, name in decls:
        if name in alive:
            continue
        out.append(mod.violation(
            RULE_ID, node,
            f"config knob '{name}' is declared here but never read "
            f"anywhere in the tree (no CONFIG.{name}, getattr, quoted "
            f"name, or RAY_TPU_TORCH_{name.upper()} reference) — setting it "
            f"does nothing; wire it to the mechanism or delete the "
            f"declaration"))
    return out


def _check_readme_drift(index, flags: Set[str]) -> List[Violation]:
    root = getattr(index, "project_root", None)
    if not root:
        return []
    readme = os.path.join(root, "README.md")
    try:
        with open(readme, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return []
    out: List[Violation] = []
    in_knobs = False
    for i, line in enumerate(lines, start=1):
        if not line.strip():
            in_knobs = False
            continue
        if line.lstrip().startswith("**Knobs**"):
            in_knobs = True
        if not in_knobs:
            continue
        for m in _KNOB_TOKEN_RE.finditer(line):
            name = m.group(1)
            if name in flags or name in _ENV_HOOK_ALLOWLIST:
                continue
            out.append(Violation(
                rule=RULE_ID, path="README.md", line=i,
                col=m.start() + 1,
                message=(f"README documents knob '{name}' in a "
                         f"**Knobs** paragraph, but config.py's _flag "
                         f"table doesn't declare it — the port's "
                         f"RAY_TPU_TORCH_{name.upper()} override silently "
                         f"does nothing; fix the doc or declare the "
                         f"flag"),
                symbol="<readme>", snippet=line.strip()))
    return out


def check(index) -> List[Violation]:
    decls = _flag_decls(index)
    flags = {name for _m, _n, name in decls}
    if not flags:
        # config.py not in the analyzed set (e.g. linting a fixture dir):
        # nothing to check against
        return []
    out: List[Violation] = []
    out.extend(_check_dead_knobs(index, decls))
    out.extend(_check_readme_drift(index, flags))
    for mod in index.modules:
        if mod.relpath.replace("\\", "/").endswith(_CONFIG_FILE_SUFFIX):
            continue
        for node in ast.walk(mod.tree):
            name = None
            target = None
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "CONFIG"):
                name, target = node.attr, node
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr" and len(node.args) >= 2
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == "CONFIG"
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                name, target = node.args[1].value, node
            if name is None:
                continue
            if name.startswith("_") or name in _CONFIG_METHODS:
                continue
            if name not in flags:
                out.append(mod.violation(
                    RULE_ID, target,
                    f"CONFIG.{name} is not declared in config.py's _flag "
                    f"table: _Config.__getattr__ will raise "
                    f"AttributeError the first time this line runs — "
                    f"declare the flag with a typed default or fix the "
                    f"name"))
    return out
