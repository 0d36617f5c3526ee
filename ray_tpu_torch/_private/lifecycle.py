# Copied from ray_tpu/_private/lifecycle.py (ray_tpu -> ray_tpu_torch, RAY_TPU_ -> RAY_TPU_TORCH_).
"""Session lifecycle supervisor: pid registry, guaranteed teardown,
parent fate-sharing, and stale-session garbage collection.

Every daemon or worker a session spawns registers its pid+pgid in a
registry directory under ``session_dir/pids/`` (one JSON file per pid, so
concurrent writers never need a lock). Teardown walks the registry with
escalating SIGTERM→SIGKILL, which catches processes that escaped their
spawner's process group (forkserver grandchildren setsid into foreign
pgids — reference parity: ``ray stop`` sweeps by session, not by child
handle). Daemons additionally fate-share with the process that spawned
them via ``PR_SET_PDEATHSIG`` plus a ppid-poll watchdog fallback, so a
SIGKILL'd driver strands nothing.

Registry record (``session_dir/pids/<pid>.json``)::

    {"pid": 123, "pgid": 123, "role": "agent", "node_id": "ab12...",
     "create_time": 1690000000.0, "registered_at": 1690000001.2}

``create_time`` is the process start time (clock ticks since boot when
read from /proc, psutil epoch seconds otherwise); liveness checks compare
it so a recycled pid is never mistaken for — or killed as — the
registered process.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

REGISTRY_DIRNAME = "pids"

# Roles whose processes a session may spawn; used by the leak gate to
# recognize ray_tpu_torch daemons by registry record, not by cmdline grepping.
DAEMON_ROLES = ("gcs", "agent", "forkserver", "worker")

# A session dir younger than this with an EMPTY registry is assumed to be
# mid-bootstrap (the spawner registers pids right after Popen, so the
# window is really milliseconds); never GC it.
_BOOTSTRAP_GRACE_S = 120.0


def session_root_name() -> str:
    """The name of this checkout's session root, ``ray_tpu_torch-<hash of
    the package's directory>``: two checkouts side by side keep their
    sessions, and their stale-session GC, apart."""
    pkg = os.path.realpath(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return "ray_tpu_torch-" + hashlib.sha1(pkg.encode()).hexdigest()[:8]


def default_session_roots() -> List[str]:
    """Every base dir sessions may live under (shm preferred, tmp
    fallback — keep in sync with node.default_session_root)."""
    roots = []
    if os.path.isdir("/dev/shm"):
        roots.append(os.path.join("/dev/shm", session_root_name()))
    roots.append(os.path.join(tempfile.gettempdir(), session_root_name()))
    return roots


# ---------------------------------------------------------------------------
# pid identity
# ---------------------------------------------------------------------------


def _proc_create_time(pid: int) -> Optional[float]:
    """Start time of ``pid`` (ticks-since-boot from /proc on Linux), or
    None when it cannot be determined. Only equality matters — the value
    is an identity token against pid recycling, not a timestamp."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read().decode("ascii", "replace")
        # field 22 (1-indexed) after the parenthesized comm, which may
        # itself contain spaces — split after the LAST ')'
        tail = data.rsplit(")", 1)[1].split()
        return float(tail[19])
    except Exception:
        try:
            import psutil

            return psutil.Process(pid).create_time()
        except Exception:
            return None


def _pid_alive(pid: int, create_time: Optional[float] = None) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass  # exists, owned by someone else
    except OSError:
        return False
    if create_time is not None:
        now_ct = _proc_create_time(pid)
        if now_ct is not None and abs(now_ct - create_time) > 1e-6:
            return False  # pid was recycled by an unrelated process
    # zombies hold their pid but are already dead for teardown purposes
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read().decode("ascii", "replace")
        if data.rsplit(")", 1)[1].split()[0] == "Z":
            return False
    except Exception:
        pass
    return True


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def registry_dir(session_dir: str) -> str:
    return os.path.join(session_dir, REGISTRY_DIRNAME)


def register_process(session_dir: str, role: str, pid: int,
                     node_id: str = "") -> None:
    """Record one spawned process in the session registry. Called by the
    SPAWNER immediately after fork/Popen (so a crash of the child can
    never leave it unregistered) and idempotently by the child itself."""
    try:
        reg = registry_dir(session_dir)
        os.makedirs(reg, exist_ok=True)
        try:
            pgid = os.getpgid(pid)
        except OSError:
            pgid = pid
        rec = {
            "pid": pid,
            "pgid": pgid,
            "role": role,
            "node_id": node_id,
            "create_time": _proc_create_time(pid),
            "registered_at": time.time(),
        }
        tmp = os.path.join(reg, f".{pid}.json.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, os.path.join(reg, f"{pid}.json"))
    except OSError:
        pass  # registry is best-effort; teardown still signals known procs


def register_self(role: str, session_dir: Optional[str] = None,
                  node_id: str = "") -> None:
    session_dir = session_dir or os.environ.get("RAY_TPU_TORCH_SESSION_DIR")
    if session_dir:
        register_process(session_dir, role, os.getpid(), node_id)


def unregister_process(session_dir: str, pid: int) -> None:
    try:
        os.unlink(os.path.join(registry_dir(session_dir), f"{pid}.json"))
    except OSError:
        pass


def list_registered(session_dir: str) -> List[Dict]:
    reg = registry_dir(session_dir)
    records: List[Dict] = []
    try:
        names = os.listdir(reg)
    except OSError:
        return records
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(reg, name)) as f:
                rec = json.load(f)
            if isinstance(rec, dict) and rec.get("pid"):
                records.append(rec)
        except (OSError, ValueError):
            continue
    return records


def live_registered(session_dir: str,
                    node_id: Optional[str] = None) -> List[Dict]:
    """Registered processes still alive (pid-recycling-safe), excluding
    the calling process itself."""
    me = os.getpid()
    out = []
    for rec in list_registered(session_dir):
        if node_id and rec.get("node_id") != node_id:
            continue
        if rec["pid"] == me:
            continue
        if _pid_alive(rec["pid"], rec.get("create_time")):
            out.append(rec)
    return out


# ---------------------------------------------------------------------------
# reaper
# ---------------------------------------------------------------------------


def _signal_record(rec: Dict, sig: int) -> None:
    """Signal a registered process, preferring its whole process group
    (forkserver children setsid, so the group IS the escape hatch)."""
    pid = rec["pid"]
    if not _pid_alive(pid, rec.get("create_time")):
        return
    pgid = rec.get("pgid") or pid
    me_pgid = os.getpgid(0)
    try:
        if pgid and pgid != me_pgid:
            os.killpg(pgid, sig)
            return
    except (ProcessLookupError, PermissionError, OSError):
        pass
    try:
        os.kill(pid, sig)
    except OSError:
        pass


def reap_session(session_dir: str, node_id: Optional[str] = None,
                 sigterm_timeout_s: float = 3.0,
                 remove: bool = False) -> List[int]:
    """Walk the session registry with escalating SIGTERM→SIGKILL.

    ``node_id`` limits the sweep to one node's processes (a worker node
    leaving a shared session must not take the cluster down). Returns the
    pids that were still alive when the sweep started. ``remove`` also
    unlinks the session dir (shm segments live inside it)."""
    victims = live_registered(session_dir, node_id)
    for rec in victims:
        _signal_record(rec, signal.SIGTERM)
    deadline = time.monotonic() + sigterm_timeout_s
    pending = list(victims)
    while pending and time.monotonic() < deadline:
        time.sleep(0.05)
        pending = [r for r in pending
                   if _pid_alive(r["pid"], r.get("create_time"))]
    for rec in pending:
        _signal_record(rec, signal.SIGKILL)
    for rec in victims:
        if not _pid_alive(rec["pid"], rec.get("create_time")):
            unregister_process(session_dir, rec["pid"])
    if remove:
        import shutil

        shutil.rmtree(session_dir, ignore_errors=True)
    return [r["pid"] for r in victims]


# ---------------------------------------------------------------------------
# stale-session garbage collection
# ---------------------------------------------------------------------------


def list_sessions(session_roots: Optional[List[str]] = None) -> List[Dict]:
    """Every session dir under the roots with its live/dead registered
    pids: [{"path", "live": [rec...], "dead": [rec...]}]."""
    out: List[Dict] = []
    seen = set()
    for root in session_roots or default_session_roots():
        try:
            names = sorted(os.listdir(root))
        except OSError:
            continue
        for name in names:
            if not name.startswith("session_"):
                continue
            path = os.path.join(root, name)
            if path in seen or not os.path.isdir(path):
                continue
            seen.add(path)
            records = list_registered(path)
            live = [r for r in records
                    if _pid_alive(r["pid"], r.get("create_time"))]
            dead = [r for r in records if r not in live]
            out.append({"path": path, "live": live, "dead": dead})
    return out


def gc_stale_sessions(session_roots: Optional[List[str]] = None,
                      kill_live: bool = False) -> List[str]:
    """Remove session dirs whose registered pids are all dead (their shm
    segments starve later runs — the round-5 gate failure). With
    ``kill_live`` (CLI ``stop --all``) live sessions are reaped first.
    Returns the removed paths."""
    import shutil

    removed: List[str] = []
    my_session = os.environ.get("RAY_TPU_TORCH_SESSION_DIR") or ""
    for sess in list_sessions(session_roots):
        path = sess["path"]
        if my_session and os.path.normpath(path) == \
                os.path.normpath(my_session):
            continue  # never GC the session we are part of
        if sess["live"]:
            if not kill_live:
                continue
            reap_session(path, remove=True)
            removed.append(path)
            continue
        if not sess["live"] and not sess["dead"]:
            # no registry at all: only collect once clearly abandoned
            try:
                age = time.time() - os.stat(path).st_mtime
            except OSError:
                continue
            if age < _BOOTSTRAP_GRACE_S:
                continue
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    return removed


# ---------------------------------------------------------------------------
# parent fate-sharing
# ---------------------------------------------------------------------------

_PR_SET_PDEATHSIG = 1


def _resolve_prctl():
    try:
        import ctypes

        return ctypes.CDLL(None, use_errno=True).prctl
    except (OSError, AttributeError):
        return None


# resolved once at import, so that a forked child (``die_with_parent``)
# calls into libc without taking the dynamic loader's lock
_PRCTL = _resolve_prctl()


def _set_pdeathsig(sig: int) -> bool:
    return _PRCTL is not None and _PRCTL(_PR_SET_PDEATHSIG, sig, 0, 0, 0) == 0


def die_with_parent() -> None:
    """``preexec_fn`` for a ``Popen`` whose child must not outlive its
    spawner where no session registry is there to sweep it: the child gets
    SIGKILL when the spawning thread dies, a SIGKILL of the spawner
    included. Linux only; elsewhere it does nothing."""
    _set_pdeathsig(signal.SIGKILL)


def fate_share_with_parent(
        expected_ppid: Optional[int] = None,
        on_parent_death: Optional[Callable[[], None]] = None,
        poll_s: float = 1.0,
        grace_s: float = 5.0) -> None:
    """Die when the supervising process does: ``PR_SET_PDEATHSIG`` for
    the immediate parent, plus a watchdog thread polling the designated
    supervisor pid (``RAY_TPU_TORCH_PARENT_PID`` or the parent at call time) —
    the poll covers forkserver grandchildren whose prctl parent is not
    the supervisor, and non-Linux fallback.

    On detection: ``on_parent_death`` (default SIGTERM to self for a
    graceful stop), escalating to ``os._exit`` after ``grace_s`` if the
    process wedges mid-shutdown.
    """
    if expected_ppid is None:
        env_pid = os.environ.get("RAY_TPU_TORCH_PARENT_PID")
        try:
            expected_ppid = int(env_pid) if env_pid else os.getppid()
        except ValueError:
            expected_ppid = os.getppid()
    _set_pdeathsig(signal.SIGTERM)
    if not _pid_alive(expected_ppid):
        # Unverifiable supervisor: either a foreign pid namespace
        # (container workers can't see the host agent's pid — polling
        # would self-kill a healthy worker) or the parent died in the
        # fork window. PDEATHSIG stays armed; the died-in-window case is
        # covered by the spawner-side registry sweep.
        return
    # the parent may still die between here and the first poll
    parent_ct = _proc_create_time(expected_ppid)

    def _parent_gone(check_create_time: bool = True) -> bool:
        return not _pid_alive(expected_ppid,
                              parent_ct if check_create_time else None)

    def _watch() -> None:
        # Cheap steady-state poll: kill(pid, 0) alone (one syscall) with
        # the /proc create-time recycling check only every 10th round —
        # at 1,000 fate-sharing workers the full check was ~4 syscalls
        # per worker-second of pure liveness noise.
        n = 0
        while True:
            n += 1
            if _parent_gone(check_create_time=(n % 10 == 0)):
                break
            time.sleep(poll_s)
        if on_parent_death is not None:
            try:
                on_parent_death()
            except Exception:
                pass
        else:
            try:
                os.kill(os.getpid(), signal.SIGTERM)
            except OSError:
                pass
        time.sleep(grace_s)
        os._exit(1)

    t = threading.Thread(target=_watch, daemon=True,
                         name="lifecycle-fate-share")
    t.start()


# ---------------------------------------------------------------------------
# process-tree teardown helpers (spawner side)
# ---------------------------------------------------------------------------


def terminate_tree(procs: List, sigterm_timeout_s: float = 2.0) -> None:
    """SIGTERM (by pgid when possible) then SIGKILL a set of handles with
    ``pid``/``poll()``. Shared by the agent's worker teardown and tests."""
    live = [p for p in procs if p is not None and getattr(p, "pid", None)
            and p.poll() is None]
    for p in live:
        try:
            os.killpg(os.getpgid(p.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                p.terminate()
            except Exception:
                pass
    deadline = time.monotonic() + sigterm_timeout_s
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in live):
            return
        time.sleep(0.05)
    for p in live:
        if p.poll() is None:
            try:
                os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                try:
                    p.kill()
                except Exception:
                    pass


def format_sessions(sessions: Optional[List[Dict]] = None) -> str:
    """Human-readable session table for the CLI ``status`` verb."""
    sessions = list_sessions() if sessions is None else sessions
    if not sessions:
        return "Sessions: none"
    lines = [f"Sessions ({len(sessions)})", "-" * 40]
    for sess in sessions:
        state = "LIVE" if sess["live"] else "STALE"
        roles: Dict[str, int] = {}
        for rec in sess["live"]:
            roles[rec.get("role", "?")] = roles.get(rec.get("role", "?"), 0) + 1
        role_s = ", ".join(f"{n} {r}" for r, n in sorted(roles.items()))
        lines.append(f"  {state:5s} {sess['path']}"
                     + (f" [{role_s}]" if role_s else ""))
    return "\n".join(lines)
