"""The port's CLI (``python -m ray_tpu_torch.scripts.cli``) on the CPU: the
JAX package's ``tests/test_cli.py::test_cli_lifecycle`` on the port (start,
status, list nodes, summary tasks, stop), each subcommand's options equal
to the JAX CLI's, ``status``, ``memory``, ``list actors`` and ``serve
status`` in-process on a driver joined to a CLI-started head, and ``up`` /
``down`` of a local cluster config (the launcher runs ``start`` and
``stop`` on each node).

The CLI's address and pid files live under the temporary directory, which
every file of one run shares, so this one file drives it, one head at a
time. ``stop`` without ``--all``: ``--all`` would reap
the sessions of the other files' runtimes, which the tier runs beside this
one; for the same reason the reference's "live sessions: 0" after ``stop``
is checked here as "this head's session is not live"."""

import argparse
import json
import os
import subprocess
import sys

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch._private import lifecycle  # noqa: E402
from ray_tpu_torch.scripts import cli  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, timeout=120):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def _live(session_dir):
    return [s for s in lifecycle.list_sessions()
            if os.path.normpath(s["path"]) == os.path.normpath(session_dir)
            and s["live"]]


def _session_of(start_out):
    """The session directory ``start`` printed."""
    line, = [x for x in start_out.splitlines()
             if x.startswith("node started")]
    return line.rsplit(": ", 1)[1].strip()


def test_cli_lifecycle():
    r = _cli("start", "--head", "--num-cpus", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    session_dir = _session_of(r.stdout)
    try:
        assert os.path.exists(cli.ADDR_FILE)
        assert ":" in open(cli.ADDR_FILE).read()

        r = _cli("status")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "ALIVE" in r.stdout and "CPU" in r.stdout

        r = _cli("list", "nodes")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "ALIVE" in r.stdout

        r = _cli("summary", "tasks")
        assert r.returncode == 0, r.stdout + r.stderr
    finally:
        r = _cli("stop")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "stopped 1 node(s)" in r.stdout

    # headless status is valid (the lifecycle view): the stopped head's
    # session is reaped
    r = _cli("status")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "live sessions:" in r.stdout
    assert not _live(session_dir)
    assert not os.path.exists(cli.ADDR_FILE)


def test_joined_driver_status_memory_and_serve(capsys):
    """A driver joined to a CLI-started head (a node of its own, declaring
    no GPU) runs ``status``, ``memory``, ``list actors`` and ``serve status`` in its
    own process, as ``tests/test_memory_debugger.py`` does for the JAX
    CLI."""
    from ray_tpu_torch import serve

    assert cli.main(["start", "--head", "--num-cpus", "2"]) == 0
    session_dir = _session_of(capsys.readouterr().out)
    with open(cli.ADDR_FILE) as f:
        address = f.read().strip()
    try:
        ray_tpu_torch.init(address=address, num_gpus=0)
        own = ray_tpu_torch._global_node.session_dir
        try:
            held = ray_tpu_torch.put(b"x" * 300_000)

            @serve.deployment
            class Echo:
                def __call__(self, x):
                    return x

            serve.start(http_options={"port": 0})
            handle = serve.run(Echo.bind(), name="echo")
            assert handle.remote(7).result(timeout_s=60) == 7
            capsys.readouterr()

            assert cli.main(["status"]) == 0
            out = capsys.readouterr().out
            assert "ALIVE" in out and "Object plane" in out
            assert " CPU" in out

            assert cli.main(["memory", "--group-by", "tier"]) == 0
            out = capsys.readouterr().out
            assert "Grouped by tier" in out and "shm" in out

            assert cli.main(["list", "actors"]) == 0
            actors = json.loads(capsys.readouterr().out)
            assert any(a.get("class_name") == "ServeController"
                       for a in actors), actors

            assert cli.main(["serve", "status"]) == 0
            apps = json.loads(capsys.readouterr().out)["applications"]
            assert apps["echo"]["status"] == "RUNNING"

            assert cli.main(["summary", "tasks"]) == 0
            json.loads(capsys.readouterr().out)
            del held
        finally:
            serve.shutdown()
            ray_tpu_torch.shutdown()
        port_session_leak_check(own)
    finally:
        assert cli.main(["stop"]) == 0
    assert not _live(session_dir)


def _parser_of(mod):
    """The parser ``mod.main`` builds, caught as it parses."""
    caught = {}

    class _Caught(Exception):
        pass

    def parse_args(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Caught

    old = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = parse_args
    try:
        with pytest.raises(_Caught):
            mod.main(["status"])
    finally:
        argparse.ArgumentParser.parse_args = old
    return caught["parser"]


def _options(parser):
    """{subcommand path: [(option strings, dest, default, choices, nargs,
    action)]} over every subparser."""
    out = {}

    def walk(p, path):
        rows = []
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sub in a.choices.items():
                    walk(sub, path + (name,))
                continue
            rows.append((tuple(a.option_strings), a.dest, a.default,
                         tuple(a.choices or ()), a.nargs, type(a).__name__))
        out[path] = rows

    walk(parser, ())
    return out


def test_subcommand_options_match_jax():
    from ray_tpu.scripts import cli as jax_cli

    port, ref = _options(_parser_of(cli)), _options(_parser_of(jax_cli))
    assert sorted(port) == sorted(ref)
    assert len(port) == 17
    for path in ref:
        assert port[path] == ref[path], path


def test_up_and_down_of_a_local_config(tmp_path, monkeypatch):
    """``up`` of a local config (a head and a worker on this machine, the
    JAX package's ``test_cluster_launcher.py`` end to end) runs this CLI's
    ``start`` on each node through the launcher; a driver joins at the
    address ``up`` prints and runs a task on the worker; ``down`` runs
    ``stop``, and the head's session is no longer live."""
    import contextlib
    import io
    import time

    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    config = tmp_path / "cluster.json"
    config.write_text(json.dumps({
        "cluster_name": "local-e2e",
        "provider": {"type": "local"},
        "head_node": {"host": "127.0.0.1",
                      "resources": {"CPU": 2, "head_marker": 1}},
        "worker_nodes": [{"host": "127.0.0.1",
                          "resources": {"CPU": 1, "worker_marker": 1}}],
    }))

    def run(*argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = cli.main(list(argv))
        return code, buf.getvalue()

    code, out = run("up", str(config))
    assert code == 0, out
    assert out.startswith("cluster 'local-e2e' up; head address: ")
    address = out.splitlines()[0].rsplit(": ", 1)[1]
    with open(cli.ADDR_FILE) as f:
        assert f.read().strip() == address
    with open(cli.PID_FILE) as f:
        nodes = json.load(f)
    assert len(nodes) == 2
    try:
        ray_tpu_torch.init(address=address, num_cpus=0, num_gpus=0)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            total = ray_tpu_torch.cluster_resources()
            if total.get("head_marker") and total.get("worker_marker"):
                break
            time.sleep(0.5)
        assert total.get("head_marker") == 1.0, total
        assert total.get("worker_marker") == 1.0, total

        @ray_tpu_torch.remote(resources={"worker_marker": 1})
        def on_worker():
            return "hi"

        assert ray_tpu_torch.get(on_worker.remote(), timeout=120) == "hi"
        own = ray_tpu_torch._global_node.session_dir
    finally:
        ray_tpu_torch.shutdown()
        code, out = run("down", str(config))
    assert code == 0 and out == "cluster 'local-e2e' down\n", out
    assert not any(lifecycle._pid_alive(p) for p in nodes)
    assert not _live(own)
    assert not os.path.exists(cli.ADDR_FILE)


def test_cli_module_runs_as_a_script():
    """``python -m ray_tpu_torch.scripts.cli`` answers ``--help`` with the
    reference's subcommands."""
    r = _cli("--help")
    assert r.returncode == 0, r.stderr
    for cmd in ("start", "stop", "up", "down", "status", "list", "summary",
                "timeline", "trace", "memory", "train-resume", "metrics",
                "serve"):
        assert cmd in r.stdout, cmd
