"""raylint for the port (``ray_tpu_torch.devtools.lint``) on the CPU, held
against the JAX package's (``ray_tpu.devtools.lint``):

1. **Tree gate** — ``ray_tpu_torch/`` lints clean against the port's
   empty baseline: no violation, no parse error, no stale entry, the whole
   tree scanned, inside a CPU-time budget. The reference's linter run on
   the same tree finds exactly the port's deliberate divergences.
2. **Fixtures** — every file of ``raylint_fixtures/`` goes through both
   linters: the same (rule, line) pairs, exactly on the ``# expect-Rn``
   lines.
3. **Engine and CLI** — ``test_raylint.py``'s cases on the port's engine.
4. **R8's env form** and **R7's fate-sharing spawn**, the two rules the
   port changes, and the two spawn sites that needed them.
5. **R5's dynamic half** over ``ray_tpu_torch.exceptions``.
6. **The lock graph** the sanitizer reads: committed equals a fresh dump,
   and its edges are the reference's.

Both linters scan the port's tree once for the module (``trees``)."""

import inspect
import json
import os
import pickle
import re
import signal
import subprocess
import sys
import textwrap
import time

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch.exceptions as exc_mod  # noqa: E402
from ray_tpu.devtools.lint import run_lint as jax_run_lint  # noqa: E402
from ray_tpu_torch.devtools.lint import baseline as baseline_mod  # noqa: E402
from ray_tpu_torch.devtools.lint import concurrency  # noqa: E402
from ray_tpu_torch.devtools.lint.cli import main as lint_main  # noqa: E402
from ray_tpu_torch.devtools.lint.engine import (  # noqa: E402
    default_baseline_path, run_lint)
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
FIXTURES = os.path.join(TESTS_DIR, "raylint_fixtures")
PORT_TREE = os.path.join(REPO_ROOT, "ray_tpu_torch")
LOCK_GRAPH = os.path.join(PORT_TREE, "devtools", "lint", "lock_graph.json")
JAX_LOCK_GRAPH = os.path.join(REPO_ROOT, "ray_tpu", "devtools", "lint",
                              "lock_graph.json")
REGENERATE = ("python -m ray_tpu_torch.devtools.lint ray_tpu_torch "
              "--dump-lock-graph ray_tpu_torch/devtools/lint/lock_graph.json")

# CPU seconds (time.process_time) for the port's whole-tree scan: 17.7-20.0
# s measured alone on one core, so the budget is about twice that. CPU
# time, not wall time: the reference's 30 s wall-clock budget went red
# under the tier's -n 6 load, where the scan waits for a core.
LINT_CPU_BUDGET_S = 40.0

# What the reference's rules report on the port's tree and the port's do
# not, each on purpose: the port reads its knobs as RAY_TPU_TORCH_<NAME>
# (R8), and its two spawns that may run outside a session make their
# children die with the spawner instead of registering them (R7).
DELIBERATE = {
    ("R8", "ray_tpu_torch/_private/config.py", "<module>"),
    ("R7", "ray_tpu_torch/dryrun.py", "_run_entry_workers"),
    ("R7", "ray_tpu_torch/ops/cuda/_build.py", "_start"),
}


@pytest.fixture(scope="module")
def trees():
    """Both linters over ``ray_tpu_torch/``, once: the port's against its
    checked-in baseline (with its CPU seconds), the reference's with none."""
    t0 = time.process_time()
    port = run_lint([PORT_TREE], project_root=REPO_ROOT,
                    baseline_path=default_baseline_path())
    cpu_s = time.process_time() - t0
    ref = jax_run_lint([PORT_TREE], project_root=REPO_ROOT,
                       baseline_path=None)
    return {"port": port, "cpu_s": cpu_s, "ref": ref}


# ---------------------------------------------------------------------------
# 1. Tree gate
# ---------------------------------------------------------------------------
def test_tree_has_no_violations(trees):
    res = trees["port"]
    assert not res.parse_errors, res.parse_errors
    assert not res.violations, (
        "raylint found unsuppressed violations in ray_tpu_torch — fix "
        "them, or add an inline '# raylint: disable=Rn -- reason':\n"
        + "\n".join(v.format() for v in res.violations))


def test_baseline_is_empty_and_not_stale(trees):
    res = trees["port"]
    assert not res.stale_baseline, (
        "baseline entries no longer match any violation — shrink "
        "baseline.json (python -m ray_tpu_torch.devtools.lint "
        "ray_tpu_torch --update-baseline): "
        + ", ".join(res.stale_baseline))
    assert baseline_mod.load(default_baseline_path()) == {}
    assert not res.grandfathered


def test_whole_tree_was_scanned(trees):
    assert trees["port"].files_scanned > 200
    assert trees["ref"].files_scanned == trees["port"].files_scanned


def test_cpu_budget(trees):
    assert trees["cpu_s"] < LINT_CPU_BUDGET_S, (
        f"the whole-tree lint took {trees['cpu_s']:.1f} CPU s, budget "
        f"{LINT_CPU_BUDGET_S} s")


def test_reference_rules_differ_only_where_deliberate(trees):
    got = {(v.rule, v.path, v.symbol) for v in trees["ref"].violations}
    assert got == DELIBERATE, "\n".join(
        v.format() for v in trees["ref"].violations)
    (r8,) = [v for v in trees["ref"].violations if v.rule == "R8"]
    assert "'log_to_driver'" in r8.message


def test_log_to_driver_lints_clean_without_suppression(trees):
    cfg = os.path.join(PORT_TREE, "_private", "config.py")
    with open(cfg) as f:
        lines = f.read().splitlines()
    (line,) = [ln for ln in lines if '_flag("log_to_driver"' in ln]
    assert "raylint" not in line
    assert not any("log_to_driver" in v.message
                   for v in trees["port"].violations)


# ---------------------------------------------------------------------------
# 2. Fixtures through both linters
# ---------------------------------------------------------------------------
_FIXTURES = sorted(f for f in os.listdir(FIXTURES)
                   if re.match(r"r\d+_.*\.py$", f))


def _expected(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return sorted((rule, i) for i, line in enumerate(lines, 1)
                  for rule in re.findall(r"expect-(R\d+)", line))


def _pairs(res):
    return sorted((v.rule, v.line) for v in res.violations)


@pytest.mark.parametrize("fixture", _FIXTURES)
def test_fixture_trips_the_same_lines_in_both(fixture):
    path = os.path.join(FIXTURES, fixture)
    expected = _expected(path)
    (rule,) = {r for r, _ in expected}
    for rules in ([rule], None):
        port = run_lint([path], project_root=FIXTURES, rules=rules,
                        baseline_path=None)
        ref = jax_run_lint([path], project_root=FIXTURES, rules=rules,
                           baseline_path=None)
        assert not port.parse_errors
        assert _pairs(port) == _pairs(ref), (rules, _pairs(port),
                                             _pairs(ref))
        assert ([v.message for v in port.violations]
                == [v.message for v in ref.violations])
    one_rule = run_lint([path], project_root=FIXTURES, rules=[rule],
                        baseline_path=None)
    assert _pairs(one_rule) == expected, "\n".join(
        v.format() for v in one_rule.violations)


def test_fixture_set_covers_the_reference_cases():
    assert len(_FIXTURES) == 8


# ---------------------------------------------------------------------------
# 3. Engine semantics and the CLI
# ---------------------------------------------------------------------------
_LEAK = "import asyncio\n\ndef go(loop):\n    loop.create_task(work())\n"


@pytest.mark.parametrize("comment,suppressed", [
    ("  # raylint: disable=R4 -- test exemption", True),
    ("  # raylint: disable=R6 -- wrong rule", False),
    ("block", True),
])
def test_inline_disable(tmp_path, comment, suppressed):
    f = tmp_path / "leak.py"
    if comment == "block":
        f.write_text(_LEAK.replace(
            "    loop.create_task(work())",
            "    # raylint: disable=R4 -- justification on its own line,\n"
            "    # continued here\n"
            "    loop.create_task(work())"))
    else:
        f.write_text(_LEAK.replace("loop.create_task(work())",
                                   "loop.create_task(work())" + comment))
    res = run_lint([str(f)], project_root=str(tmp_path), baseline_path=None)
    assert [v.rule for v in res.violations] == ([] if suppressed else ["R4"])
    assert res.suppressed_count == (1 if suppressed else 0)


def test_baseline_grandfathers_then_flags_growth(tmp_path):
    f = tmp_path / "leak.py"
    f.write_text(_LEAK)
    bl = tmp_path / "baseline.json"
    res = run_lint([str(f)], project_root=str(tmp_path), baseline_path=None)
    baseline_mod.save(str(bl), baseline_mod.counts(res.violations))
    assert "ray_tpu_torch.devtools.lint ray_tpu_torch --update-baseline" in \
        json.loads(bl.read_text())["comment"]
    res = run_lint([str(f)], project_root=str(tmp_path),
                   baseline_path=str(bl))
    assert not res.violations and len(res.grandfathered) == 1
    f.write_text(_LEAK + "\ndef go2(loop):\n    loop.create_task(work())\n")
    res = run_lint([str(f)], project_root=str(tmp_path),
                   baseline_path=str(bl))
    assert len(res.violations) == 1 and len(res.grandfathered) == 1


def test_baseline_stale_entry_detected(tmp_path):
    f = tmp_path / "clean.py"
    f.write_text("x = 1\n")
    bl = tmp_path / "baseline.json"
    baseline_mod.save(str(bl), {"gone.py::R4::go::loop.create_task(w())": 1})
    res = run_lint([str(f)], project_root=str(tmp_path),
                   baseline_path=str(bl))
    assert not res.violations
    assert res.stale_baseline == ["gone.py::R4::go::loop.create_task(w())"]
    rc = lint_main([str(f), "--project-root", str(tmp_path), "--baseline",
                    str(bl), "--strict-baseline"])
    assert rc == 1


def test_baseline_key_survives_line_shifts(tmp_path):
    f = tmp_path / "leak.py"
    f.write_text(_LEAK)
    res1 = run_lint([str(f)], project_root=str(tmp_path), baseline_path=None)
    f.write_text("# a new comment pushing everything down\n\n" + _LEAK)
    res2 = run_lint([str(f)], project_root=str(tmp_path), baseline_path=None)
    assert res1.violations[0].line != res2.violations[0].line
    assert res1.violations[0].key() == res2.violations[0].key()


def test_cli_json_output_and_exit_codes(tmp_path, capsys):
    f = tmp_path / "leak.py"
    f.write_text(_LEAK)
    rc = lint_main([str(f), "--project-root", str(tmp_path),
                    "--no-baseline", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["ok"] is False
    (v,) = out["violations"]
    assert v["rule"] == "R4" and v["path"] == "leak.py" and v["key"]
    clean = tmp_path / "clean.py"
    clean.write_text("x = 1\n")
    rc = lint_main([str(clean), "--project-root", str(tmp_path),
                    "--no-baseline", "--format", "json"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    assert lint_main([str(clean), "--rules", "R99"]) == 2
    assert lint_main([str(clean), "--rules", "R4",
                      "--update-baseline"]) == 2


def test_cli_lists_all_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for n in range(1, 15):
        assert f"R{n}:" in out


def test_cli_sarif_output(tmp_path, capsys):
    f = tmp_path / "leak.py"
    f.write_text(_LEAK)
    rc = lint_main([str(f), "--project-root", str(tmp_path),
                    "--no-baseline", "--format", "sarif"])
    sarif = json.loads(capsys.readouterr().out)
    assert rc == 1 and sarif["version"] == "2.1.0"
    (run,) = sarif["runs"]
    assert run["tool"]["driver"]["informationUri"] == \
        "ray_tpu_torch/devtools/lint"
    assert {r["id"] for r in run["tool"]["driver"]["rules"]} >= {
        "R1", "R12", "R13", "R14"}
    (result,) = run["results"]
    assert result["ruleId"] == "R4" and result["level"] == "error"
    loc = result["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "leak.py"
    assert loc["region"]["startLine"] == 4
    assert result["partialFingerprints"]["raylintKey/v1"].startswith(
        "leak.py::R4::")


def test_cli_changed_scopes_the_report(tmp_path, capsys):
    def git(*args):
        subprocess.run(["git", "-c", "user.email=t@t", "-c",
                        "user.name=t", *args], cwd=str(tmp_path),
                       check=True, capture_output=True)

    git("init", "-q")
    (tmp_path / "committed_leak.py").write_text(_LEAK)
    git("add", "committed_leak.py")
    git("commit", "-qm", "seed")
    (tmp_path / "fresh_leak.py").write_text(_LEAK)
    rc = lint_main([str(tmp_path), "--project-root", str(tmp_path),
                    "--no-baseline", "--changed", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert [v["path"] for v in out["violations"]] == ["fresh_leak.py"]
    rc = lint_main([str(tmp_path), "--project-root", str(tmp_path),
                    "--no-baseline", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert {v["path"] for v in out["violations"]} == {
        "committed_leak.py", "fresh_leak.py"}


def test_cli_default_path_is_the_port(monkeypatch, tmp_path, capsys):
    """With no path the CLI lints ``ray_tpu_torch`` under the cwd."""
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    (pkg / "leak.py").write_text(_LEAK)
    monkeypatch.chdir(tmp_path)
    rc = lint_main(["--no-baseline", "--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert [v["path"] for v in out["violations"]] == [
        "ray_tpu_torch/leak.py"]


# ---------------------------------------------------------------------------
# 4. The rules the port changes: R8's env form, R7's fate-sharing spawn
# ---------------------------------------------------------------------------
def _knob_tree(root, reader_src, readme=None):
    """A tree big enough for R8's dead-knob scan (100 modules), with a
    config.py declaring ``env_only_knob`` and ``unread_knob``."""
    pkg = root / "pkg"
    (pkg / "_private").mkdir(parents=True)
    (pkg / "_private" / "config.py").write_text(
        '_flag("env_only_knob", 1)\n_flag("unread_knob", 2)\n')
    (pkg / "reader.py").write_text(reader_src)
    for i in range(100):
        (pkg / f"m{i}.py").write_text(f"X{i} = {i}\n")
    if readme is not None:
        (root / "README.md").write_text(readme)
    return str(pkg)


def _dead(res):
    return sorted(re.search(r"knob '(\w+)'", v.message).group(1)
                  for v in res.violations if v.rule == "R8")


def test_r8_env_form_keeps_a_knob_alive(tmp_path):
    pkg = _knob_tree(tmp_path, "import os\nV = os.environ.get("
                                "'RAY_TPU_TORCH_ENV_ONLY_KNOB')\n")
    port = run_lint([pkg], project_root=str(tmp_path), rules=["R8"],
                    baseline_path=None)
    ref = jax_run_lint([pkg], project_root=str(tmp_path), rules=["R8"],
                       baseline_path=None)
    assert _dead(port) == ["unread_knob"]
    # the reference looks for RAY_TPU_ENV_ONLY_KNOB only
    assert _dead(ref) == ["env_only_knob", "unread_knob"]


def test_r8_reference_env_form_alone_is_dead_in_the_port(tmp_path):
    pkg = _knob_tree(tmp_path, "import os\nV = os.environ.get("
                                "'RAY_TPU_ENV_ONLY_KNOB')\n")
    port = run_lint([pkg], project_root=str(tmp_path), rules=["R8"],
                    baseline_path=None)
    assert _dead(port) == ["env_only_knob", "unread_knob"]


def test_r8_readme_knobs_are_checked_by_name(tmp_path):
    """The shared README documents the reference's RAY_TPU_<NAME> form;
    the port checks the bare name against its own table."""
    readme = ("# x\n\n**Knobs** (all overridable via `RAY_TPU_<NAME>`): "
              "`env_only_knob`,\n`unread_knob`, `missing_knob`.\n")
    pkg = _knob_tree(tmp_path, "from c import CONFIG\n"
                               "A = CONFIG.env_only_knob\n"
                               "B = CONFIG.unread_knob\n", readme)
    res = run_lint([pkg], project_root=str(tmp_path), rules=["R8"],
                   baseline_path=None)
    (v,) = res.violations
    assert v.path == "README.md" and v.line == 4
    assert "'missing_knob'" in v.message
    assert "RAY_TPU_TORCH_MISSING_KNOB" in v.message


_SPAWNS = """\
import subprocess
from ray_tpu_torch._private.lifecycle import die_with_parent
from ray_tpu_torch._private import lifecycle


def plain(cmd):
    return subprocess.Popen(cmd)  # expect-R7


def fate_shared(cmd):
    return subprocess.Popen(cmd, preexec_fn=die_with_parent)


def fate_shared_attr(cmd):
    return subprocess.Popen(cmd, preexec_fn=lifecycle.die_with_parent)


def other_hook(cmd):
    return subprocess.Popen(cmd, preexec_fn=lambda: None)  # expect-R7


def registered(cmd, session_dir):
    p = subprocess.Popen(cmd)
    lifecycle.register_process(session_dir, "x", p.pid)
    return p
"""


def test_r7_takes_a_child_that_dies_with_its_parent(tmp_path):
    f = tmp_path / "spawns.py"
    f.write_text(_SPAWNS)
    port = run_lint([str(f)], project_root=str(tmp_path), rules=["R7"],
                    baseline_path=None)
    ref = jax_run_lint([str(f)], project_root=str(tmp_path), rules=["R7"],
                       baseline_path=None)
    assert _pairs(port) == _expected(str(f))
    assert {v.symbol for v in port.violations} == {"plain", "other_hook"}
    assert {v.symbol for v in ref.violations} == {
        "plain", "fate_shared", "fate_shared_attr", "other_hook"}


_PARENT = """
import subprocess, sys
import ray_tpu_torch.dryrun as dryrun

real = subprocess.Popen
spawned = []


def sleeper(argv, **kwargs):
    # the rank processes' own spawn arguments, a long sleep for a command
    p = real([sys.executable, "-c", "import time; time.sleep(120)"], **kwargs)
    spawned.append(p.pid)
    if len(spawned) == 4:
        print("PIDS", *spawned, flush=True)
    return p


dryrun.subprocess.Popen = sleeper
dryrun._run_entry_workers("--two-slice-worker", "127.0.0.1:1", 600)
"""


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


@pytest.mark.skipif(not sys.platform.startswith("linux"),
                    reason="PR_SET_PDEATHSIG is Linux's")
def test_dryrun_ranks_die_with_a_killed_parent():
    """SIGKILL the process that runs ``_run_entry_workers``: its ``finally``
    never runs, and its rank processes die all the same."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    parent = subprocess.Popen([sys.executable, "-c", _PARENT], cwd=REPO_ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not line.startswith("PIDS"):
            line = parent.stdout.readline()
            if not line and parent.poll() is not None:
                break
        assert line.startswith("PIDS"), parent.stderr.read()
        pids = [int(p) for p in line.split()[1:]]
        assert len(pids) == 4 and all(_alive(p) for p in pids)
        os.kill(parent.pid, signal.SIGKILL)
        parent.wait(30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(map(_alive, pids)):
            time.sleep(0.1)
        assert not [p for p in pids if _alive(p)]
    finally:
        if parent.poll() is None:
            parent.kill()
            parent.wait(30)


def test_die_with_parent_kills_the_orphan():
    """A grandchild spawned with ``die_with_parent`` dies with the child
    that spawned it, when that child is SIGKILLed."""
    code = textwrap.dedent("""
        import subprocess, sys, time
        from ray_tpu_torch._private.lifecycle import die_with_parent
        p = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"],
                             preexec_fn=die_with_parent)
        print(p.pid, flush=True)
        time.sleep(120)
    """)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdout=subprocess.PIPE, text=True)
    try:
        pid = int(child.stdout.readline())
        assert _alive(pid)
        os.kill(child.pid, signal.SIGKILL)
        child.wait(30)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and _alive(pid):
            time.sleep(0.1)
        assert not _alive(pid)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(30)


# ---------------------------------------------------------------------------
# 5. R5's dynamic half over the port's exceptions
# ---------------------------------------------------------------------------
def _public_exception_classes():
    out = []
    for name in dir(exc_mod):
        if name.startswith("_"):
            continue
        obj = getattr(exc_mod, name)
        if (inspect.isclass(obj) and issubclass(obj, BaseException)
                and obj.__module__ == exc_mod.__name__):
            out.append(obj)
    return sorted(out, key=lambda c: c.__name__)


_SAMPLES = {
    "timeline": [(1.5, "detected"), (2.5, "fenced")],
    "queue_depths": {"replica-a": 3, "replica-b": 0},
    "incarnation": 7,
    "cause": None,
    "failed_ranks": [0, 3],
    "chain": [{"object_id": "aa" * 18, "task": "f", "why": "replayed"}],
}


def _synthesize_kwargs(cls):
    kwargs = {}
    params = list(inspect.signature(cls.__init__).parameters.values())[1:]
    for p in params:
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if p.name in _SAMPLES:
            val = _SAMPLES[p.name]
        elif isinstance(p.default, bool):
            val = p.default
        elif isinstance(p.default, int):
            val = 3
        elif isinstance(p.default, float):
            val = 2.5
        else:
            val = f"v-{p.name}"
        if val is not None:
            kwargs[p.name] = val
    return kwargs


def _fields(e):
    out = {"__type__": type(e).__name__, "__str__": str(e), "args": e.args}
    for k, v in vars(e).items():
        out[k] = v.to_dict() if isinstance(v, exc_mod.DeathContext) else v
    return out


def test_exception_hierarchy_is_the_references():
    import ray_tpu.exceptions as jax_exc

    names = [c.__name__ for c in _public_exception_classes()]
    assert len(names) == 22
    assert names == sorted(
        n for n in dir(jax_exc) if not n.startswith("_")
        and inspect.isclass(getattr(jax_exc, n))
        and issubclass(getattr(jax_exc, n), BaseException)
        and getattr(jax_exc, n).__module__ == jax_exc.__name__)


@pytest.mark.parametrize("cls", _public_exception_classes(),
                         ids=lambda c: c.__name__)
def test_exception_pickle_round_trip(cls):
    kwargs = _synthesize_kwargs(cls)
    exc = cls(**kwargs) if kwargs else cls("v-message")
    clone = pickle.loads(pickle.dumps(exc))
    assert type(clone) is cls
    assert _fields(clone) == _fields(exc)


# ---------------------------------------------------------------------------
# 6. The lock graph the sanitizer reads
# ---------------------------------------------------------------------------
def _without_witness(graph):
    return {"locks": graph["locks"],
            "edges": sorted([a, b] for a, b, _w in graph["edges"])}


def test_committed_lock_graph_is_fresh(trees):
    fresh = concurrency.get(trees["port"]._index).static_graph()
    with open(LOCK_GRAPH) as f:
        committed = json.load(f)
    assert _without_witness(committed) == _without_witness(
        json.loads(json.dumps(fresh))), (
        f"lock_graph.json is stale (a lock moved, came or went): "
        f"regenerate it with `{REGENERATE}`")
    assert len(committed["locks"]) >= 30 and committed["edges"]


def test_lock_graph_edges_are_the_references():
    """The port's edges with its package prefix mapped are the reference's;
    no difference is deliberate today. The lock sets differ by the port's
    kernel-build lock (``ops/cuda/_build.py``), which takes no other."""
    def mapped(lock_id):
        return lock_id.replace("ray_tpu_torch/", "ray_tpu/", 1)

    with open(LOCK_GRAPH) as f:
        port = json.load(f)
    with open(JAX_LOCK_GRAPH) as f:
        ref = json.load(f)
    assert ({(mapped(a), mapped(b)) for a, b, _w in port["edges"]}
            == {(a, b) for a, b, _w in ref["edges"]})
    assert {mapped(k) for k in port["locks"]} - set(ref["locks"]) == {
        "ray_tpu/ops/cuda/_build.py::_lock"}
    assert set(ref["locks"]) <= {mapped(k) for k in port["locks"]}
