"""The port's runtime concurrency sanitizer
(``ray_tpu_torch._private.sanitizer``) on the CPU: ``test_sanitizer.py``'s
cases on the port, the same lock scripts through both packages'
sanitizers, the static lock-order graph it loads from
``ray_tpu_torch/devtools/lint/lock_graph.json``, and a kill -9 chaos run
of the port's runtime with the sanitizer live in every process.

Everything that needs ``maybe_install()`` runs in its own ``python -c``
subprocess: installing monkeypatches ``threading.Lock``/``RLock`` for the
life of the process, with no uninstall. Only locks created from a frame
inside the package are wrapped, so the scripts compile their lock-making
code with a filename under ``ray_tpu_torch/`` (``exec_in_pkg``) and
write no file there."""

import ast
import json
import os
import subprocess
import sys

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

from ray_tpu_torch._private import sanitizer  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK_GRAPH = os.path.join(REPO, "ray_tpu_torch", "devtools", "lint",
                          "lock_graph.json")

_PROLOGUE = """
import os, threading
from {pkg}._private import sanitizer
assert sanitizer.maybe_install(), "{knob}=1 must install"
assert threading.Lock is sanitizer._lock_factory

import {pkg}
_PKG = os.path.dirname(os.path.abspath({pkg}.__file__))

def exec_in_pkg(src, filename="_san_probe.py"):
    g = {{"threading": threading}}
    exec(compile(src, os.path.join(_PKG, filename), "exec"), g)
    return g
"""

_PACKAGES = {"ray_tpu_torch": "RAY_TPU_TORCH_SANITIZE",
             "ray_tpu": "RAY_TPU_SANITIZE"}


def _run_sanitized(body, pkg="ray_tpu_torch", timeout=120):
    """``body`` in a fresh interpreter with ``pkg``'s sanitizer knob on."""
    knob = _PACKAGES[pkg]
    env = dict(os.environ, PYTHONPATH=REPO)
    for key in _PACKAGES.values():
        env.pop(key, None)
    env[knob] = "1"
    return subprocess.run(
        [sys.executable, "-c", _PROLOGUE.format(pkg=pkg, knob=knob) + body],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _check(proc):
    assert proc.returncode == 0, (
        f"sanitized child failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}")


# ---------------------------------------------------------------- disabled path
def test_disabled_guard_overhead_probe():
    assert not sanitizer.ENABLED, \
        "the tier must not run pre-sanitized; the probe measures the OFF path"
    ns = sanitizer.overhead_probe(100_000)
    assert ns < 1500, f"disabled guard costs {ns:.0f}ns/site"


def test_not_installed_without_knob():
    import threading

    assert not sanitizer.ENABLED
    assert threading.Lock is sanitizer._real_lock
    assert not sanitizer._static_edges


# ---------------------------------------------------------------- lock order
def test_reversed_acquisition_is_a_witnessed_cycle():
    _check(_run_sanitized("""
g = exec_in_pkg("a = threading.Lock()\\nb = threading.Lock()\\n")
a, b = g["a"], g["b"]
assert type(a) is sanitizer._SanLock, a
assert a._site == "ray_tpu_torch/_san_probe.py:1", a._site
with a:
    with b:
        pass
assert not sanitizer.VIOLATIONS, sanitizer.VIOLATIONS
with b:
    with a:
        pass
kinds = [k for k, _ in sanitizer.VIOLATIONS]
assert kinds == ["order"], sanitizer.VIOLATIONS
msg = sanitizer.VIOLATIONS[0][1]
assert "lock-order cycle" in msg and "_san_probe.py" in msg, msg
try:
    sanitizer.assert_clean()
except AssertionError:
    pass
else:
    raise SystemExit("assert_clean must raise on violations")
sanitizer.reset()
sanitizer.assert_clean()
"""))


def test_consistent_order_and_trylock_stay_clean():
    _check(_run_sanitized("""
g = exec_in_pkg("a = threading.Lock()\\nb = threading.Lock()\\n")
a, b = g["a"], g["b"]
for _ in range(3):
    with a:
        with b:
            pass
with b:
    got = a.acquire(blocking=False)
    assert got
    a.release()
assert ("ray_tpu_torch/_san_probe.py:2",
        "ray_tpu_torch/_san_probe.py:1") not in sanitizer._pairs
assert not sanitizer.VIOLATIONS, sanitizer.VIOLATIONS
sanitizer.assert_clean()
"""))


def test_runtime_order_contradicting_static_graph():
    _check(_run_sanitized("""
sanitizer._static_edges.add(("x.py:1", "y.py:2"))
sanitizer._static_sites.update(("x.py:1", "y.py:2"))
a = sanitizer._SanLock(sanitizer._real_lock(), "y.py:2")
b = sanitizer._SanLock(sanitizer._real_lock(), "x.py:1")
with a:
    with b:
        pass
kinds = [k for k, _ in sanitizer.VIOLATIONS]
assert kinds == ["static"], sanitizer.VIOLATIONS
assert "contradicts the static lock-order graph" in sanitizer.VIOLATIONS[0][1]
"""))


def test_rlock_reentry_and_condition_wait_keep_stack_truthful():
    _check(_run_sanitized("""
g = exec_in_pkg(
    "mu = threading.RLock()\\ncond = threading.Condition(mu)\\n")
mu, cond = g["mu"], g["cond"]
assert type(mu) is sanitizer._SanRLock, mu
with mu:
    with mu:
        pass
assert not sanitizer._pairs, sanitizer._pairs

done = []
def waiter():
    with cond:
        cond.wait(timeout=5)
        done.append(True)

t = threading.Thread(target=waiter)
t.start()
import time
time.sleep(0.2)
with cond:
    cond.notify_all()
t.join(5)
assert done == [True]
assert not getattr(sanitizer._held, "stack", None)
assert not sanitizer.VIOLATIONS, sanitizer.VIOLATIONS
"""))


def test_foreign_locks_stay_native():
    _check(_run_sanitized("""
lk = threading.Lock()   # made by this -c script: not the package's
assert type(lk) is type(sanitizer._real_lock()), lk
"""))


# ---------------------------------------------------------------- affinity
def test_affinity_calibrates_then_flags_the_second_thread():
    _check(_run_sanitized("""
sanitizer.note_affinity("Probe._buf", "loop")
sanitizer.note_affinity("Probe._buf", "loop")
assert not sanitizer.VIOLATIONS

t = threading.Thread(
    target=lambda: sanitizer.note_affinity("Probe._buf", "loop"))
t.start(); t.join(5)
kinds = [k for k, _ in sanitizer.VIOLATIONS]
assert kinds == ["affinity"], sanitizer.VIOLATIONS
assert "Probe._buf" in sanitizer.VIOLATIONS[0][1]
t2 = threading.Thread(
    target=lambda: sanitizer.note_affinity("Probe._buf", "loop"))
t2.start(); t2.join(5)
assert len(sanitizer.VIOLATIONS) >= 1
"""))


# ------------------------------------------------- (a) both packages agree
# Lock scripts run through each package's sanitizer in turn; each prints
# the violation kinds it recorded, and the two lists must be equal.
_SCRIPTS = {
    "cycle": """
g = exec_in_pkg("a = threading.Lock()\\nb = threading.Lock()\\n")
with g["a"]:
    with g["b"]:
        pass
with g["b"]:
    with g["a"]:
        pass
""",
    "three_lock_cycle": """
g = exec_in_pkg("a = threading.Lock()\\nb = threading.RLock()\\n"
                "c = threading.Lock()\\n")
for x, y in (("a", "b"), ("b", "c"), ("c", "a"), ("b", "a")):
    with g[x]:
        with g[y]:
            pass
""",
    "consistent": """
g = exec_in_pkg("a = threading.Lock()\\nb = threading.Lock()\\n")
for _ in range(3):
    with g["a"]:
        with g["b"]:
            pass
with g["b"]:
    assert g["a"].acquire(blocking=False)
    g["a"].release()
""",
    "static": """
sanitizer._static_edges.add(("x.py:1", "y.py:2"))
sanitizer._static_sites.update(("x.py:1", "y.py:2"))
a = sanitizer._SanLock(sanitizer._real_lock(), "y.py:2")
b = sanitizer._SanLock(sanitizer._real_lock(), "x.py:1")
with a:
    with b:
        pass
with b:
    with a:
        pass
""",
    "rlock_reentry": """
g = exec_in_pkg("mu = threading.RLock()\\nother = threading.Lock()\\n")
with g["mu"]:
    with g["mu"]:
        with g["other"]:
            pass
""",
    "affinity": """
sanitizer.note_affinity("Probe._buf", "loop")
t = threading.Thread(
    target=lambda: sanitizer.note_affinity("Probe._buf", "loop"))
t.start(); t.join(5)
""",
}

_AGREE = """
import json
out = {{}}
for name, src in {scripts!r}.items():
    sanitizer.reset()
    sanitizer._static_edges.clear()
    sanitizer._static_sites.clear()
    exec(src, {{"sanitizer": sanitizer, "exec_in_pkg": exec_in_pkg,
               "threading": threading}})
    out[name] = [k for k, _ in sanitizer.VIOLATIONS]
print("KINDS", json.dumps(out))
"""


def _kinds(pkg):
    proc = _run_sanitized(_AGREE.format(scripts=_SCRIPTS), pkg=pkg)
    _check(proc)
    (line,) = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("KINDS ")]
    return json.loads(line[len("KINDS "):])


def test_both_sanitizers_record_the_same_kinds():
    port, ref = _kinds("ray_tpu_torch"), _kinds("ray_tpu")
    assert port == ref
    assert port == {"cycle": ["order"], "three_lock_cycle": ["order"],
                    "consistent": [], "static": ["static", "order"],
                    "rlock_reentry": [], "affinity": ["affinity"]}


# ------------------------------------------------- (b) the static graph
def _creates_a_lock(path, line, kind):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.lineno == line
                and isinstance(node.func, (ast.Attribute, ast.Name))
                and (getattr(node.func, "attr", None)
                     or getattr(node.func, "id", None)) == kind):
            return True
    return False


def test_every_decl_names_a_line_that_creates_its_lock():
    with open(LOCK_GRAPH) as f:
        graph = json.load(f)
    stale = []
    for lock_id, meta in sorted(graph["locks"].items()):
        path, line = meta["decl"].rsplit(":", 1)
        if not _creates_a_lock(path, int(line), meta["kind"]):
            stale.append(f"{lock_id} at {meta['decl']}")
    assert not stale, (
        "lock_graph.json names lines that create no such lock (lines "
        "moved): regenerate it with `python -m ray_tpu_torch.devtools.lint "
        "ray_tpu_torch --dump-lock-graph "
        "ray_tpu_torch/devtools/lint/lock_graph.json`: " + ", ".join(stale))


def test_sanitized_process_loads_the_committed_graph():
    """The knob on, ``maybe_install`` loads every edge of the committed
    graph; the runtime's own locks carry the graph's decl sites; and the
    reverse of a graph edge, taken on those real locks, is reported."""
    with open(LOCK_GRAPH) as f:
        graph = json.load(f)
    decl = {k: v["decl"] for k, v in graph["locks"].items()}
    edges = sorted((decl[a], decl[b]) for a, b, _w in graph["edges"])
    proc = _run_sanitized(f"""
from ray_tpu_torch._private.memory_store import MemoryStore
from ray_tpu_torch._private.worker import LineageLedger, ReferenceCounter
edges = sorted(sanitizer._static_edges)
assert edges == {edges!r}, edges
store, ledger = MemoryStore(), LineageLedger(None)
rc = ReferenceCounter(None)
assert store._lock._site == {decl['MemoryStore._lock']!r}, store._lock
assert ledger._lock._site == {decl['LineageLedger._lock']!r}, ledger._lock
assert rc._lock._site == {decl['ReferenceCounter._lock']!r}, rc._lock
with store._lock:          # the graph's order
    with ledger._lock:
        pass
assert not sanitizer.VIOLATIONS, sanitizer.VIOLATIONS
sanitizer._pairs.clear()
with ledger._lock:         # its reverse
    with store._lock:
        pass
kinds = [k for k, _ in sanitizer.VIOLATIONS]
assert kinds == ["static"], sanitizer.VIOLATIONS
print("EDGES", len(edges))
""")
    _check(proc)
    assert f"EDGES {len(edges)}" in proc.stdout
    assert len(edges) >= 10


# ------------------------------------------------- (c) kill -9 chaos
_CHAOS = """
import os, signal, subprocess, sys, tempfile, time
from itertools import repeat

import ray_tpu_torch
from ray_tpu_torch._private import sanitizer
from ray_tpu_torch.exceptions import RayTaskError, WorkerCrashedError

ray_tpu_torch.init(num_cpus=4)
assert sanitizer.ENABLED and sanitizer._static_edges
gate = tempfile.mkdtemp(prefix="san_chaos_")


def stall(i, d):
    with open(os.path.join(d, f"{os.getpid()}.{i}.pid"), "w") as f:
        f.write(str(i))
    while not os.path.exists(os.path.join(d, "go")):
        time.sleep(0.05)
    return i


def probe():
    from ray_tpu_torch._private import sanitizer as s
    return s.ENABLED, len(s._static_edges), list(s.VIOLATIONS)


stall = ray_tpu_torch.remote(max_retries=0)(stall)
refs = stall.map(range(4), repeat(gate))
deadline = time.monotonic() + 60
pids = set()
while time.monotonic() < deadline and not pids:
    pids = {int(p.split(".")[0]) for p in os.listdir(gate)
            if p.endswith(".pid")}
    time.sleep(0.05)
assert pids, "no batch entry started within 60 s"
os.kill(sorted(pids)[0], signal.SIGKILL)
time.sleep(0.3)
with open(os.path.join(gate, "go"), "w") as f:
    f.write("1")
outcomes = []
for i, r in enumerate(refs):
    try:
        outcomes.append(("ok", ray_tpu_torch.get(r, timeout=90)))
    except WorkerCrashedError:
        outcomes.append(("crash", i))
    except RayTaskError as e:
        assert "died" in str(e).lower() or "crash" in str(e).lower(), e
        outcomes.append(("crash", i))
crashes = [o for o in outcomes if o[0] == "crash"]
assert crashes, outcomes
assert [v for k, v in outcomes if k == "ok"] == [
    i for i in range(4) if ("crash", i) not in outcomes], outcomes

# recovery: the cluster still runs tasks, in sanitized workers
probes = ray_tpu_torch.get(
    [ray_tpu_torch.remote(probe).remote() for _ in range(4)], timeout=90)
assert all(on and n for on, n, _v in probes), probes
assert not [v for *_x, v in probes if v], probes

logs = os.path.join(ray_tpu_torch._global_node.session_dir, "logs")
lines = subprocess.run(["grep", "-r", "SANITIZE ", logs],
                       capture_output=True, text=True).stdout
assert not lines, lines
sanitizer.assert_clean()
ray_tpu_torch.shutdown()
print("CHAOS-CLEAN", len(crashes), flush=True)
"""


def test_kill9_chaos_under_sanitizer():
    """A task batch whose worker is SIGKILLed: typed errors for its
    entries, the others' values, then fresh tasks in sanitized workers,
    no violation in the driver, the workers or the session's logs."""
    env = dict(os.environ, PYTHONPATH=REPO, RAY_TPU_TORCH_SANITIZE="1")
    proc = subprocess.run([sys.executable, "-c", _CHAOS], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "CHAOS-CLEAN" in proc.stdout, (
        f"rc={proc.returncode}\n--- stdout ---\n{proc.stdout}\n"
        f"--- stderr ---\n{proc.stderr[-6000:]}")


def test_sanitizer_actually_live_in_a_sanitized_child():
    proc = _run_sanitized("""
assert sanitizer.ENABLED
assert threading.Lock is sanitizer._lock_factory
assert sanitizer._static_edges
print("SAN-LIVE")
""")
    _check(proc)
    assert "SAN-LIVE" in proc.stdout


@pytest.mark.parametrize("value", ["0", ""])
def test_knob_off_does_not_install(value):
    env = dict(os.environ, PYTHONPATH=REPO, RAY_TPU_TORCH_SANITIZE=value)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import threading\n"
         "from ray_tpu_torch._private import sanitizer\n"
         "assert not sanitizer.maybe_install()\n"
         "assert threading.Lock is sanitizer._real_lock\n"
         "assert not sanitizer._static_edges\n"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    _check(proc)
