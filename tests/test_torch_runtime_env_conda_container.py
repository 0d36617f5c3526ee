"""The port's conda and container runtime envs
(``ray_tpu_torch.runtime_env.{conda,container}``) on the CPU, held against
the JAX package's: the reference's suites (``tests/test_runtime_env_conda.py``,
``tests/test_runtime_env_container.py``) run on both packages where they
are pure functions, whose outputs must be equal (spec checks, the digest,
the environment.yml, the create command, prefix resolution, the container
command), and the worker commands equal but for the worker's module.

Then the port's runtime (the file's one session, which declares one GPU):
a task under a bootable prefix runs with the prefix's interpreter and
imports torch there, a ``num_gpus=1`` task under it sees
``CUDA_VISIBLE_DEVICES=0``, a host task never rides the conda worker, and
a missing env fails fast. The container end to end runs only where podman
or docker is installed, as the reference's does."""

import json
import os
import shutil
import stat
import sys

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.runtime_env import conda as jax_conda  # noqa: E402
from ray_tpu.runtime_env import container as jax_container  # noqa: E402
from ray_tpu.runtime_env import runtime_env as jax_renv  # noqa: E402
from ray_tpu_torch.runtime_env import conda as port_conda  # noqa: E402
from ray_tpu_torch.runtime_env import container as port_container  # noqa: E402
from ray_tpu_torch.runtime_env import runtime_env as port_renv  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

HAVE_ENGINE = bool(shutil.which("podman") or shutil.which("docker"))
PKG_PARENT = os.path.dirname(os.path.dirname(
    os.path.abspath(ray_tpu_torch.__file__)))


def make_fake_env(root, name="fakeenv"):
    """A prefix whose bin/python is this interpreter (symlink)."""
    prefix = root / name
    (prefix / "bin").mkdir(parents=True)
    os.symlink(sys.executable, prefix / "bin" / "python")
    return prefix


def make_bootable_env(root, name="taskenv"):
    """A prefix a worker can boot under (tests/test_runtime_env_conda.py's
    helper): a venv whose site-packages chain to this interpreter's, so
    numpy and torch import there."""
    import glob
    import site
    import subprocess

    prefix = root / name
    subprocess.run(
        [sys.executable, "-m", "venv", "--system-site-packages",
         "--without-pip", str(prefix)], check=True, timeout=120)
    site_dir = glob.glob(str(prefix / "lib" / "python*" /
                             "site-packages"))[0]
    with open(os.path.join(site_dir, "_parent_env.pth"), "w") as f:
        f.write("\n".join(site.getsitepackages()))
    return prefix


def _outcome(fn, *args, **kw):
    """What a call gives: ("ok", value) or (error type name, message)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return (type(e).__name__, str(e))


def _both(name, *args, **kw):
    """The same conda function on both packages: equal outcomes."""
    got = [_outcome(getattr(mod, name), *args, **kw)
           for mod in (port_conda, jax_conda)]
    assert got[0] == got[1], got
    return got[0]


# ---------------------------------------------------------------- conda
@pytest.mark.parametrize("spec", [
    "myenv", {"dependencies": ["python=3.11", {"pip": ["requests"]}]},
    "", {"channels": ["conda-forge"]}, {"dependencies": [42]}, 42],
    ids=["name", "dict", "empty", "no_deps", "bad_dep", "int"])
def test_conda_spec_checks_match_jax(spec):
    out = _both("validate_conda_spec", spec)
    assert (out[0] == "ok") == (spec in ("myenv", {"dependencies": [
        "python=3.11", {"pip": ["requests"]}]}))


@pytest.mark.parametrize("fields", [
    {"conda": "base"}, {"conda": {"channels": ["x"]}},
    {"conda": "base", "container": {"image": "x"}},
    {"container": {"image": "python:3.12-slim"}},
    {"container": {"no_image": True}},
    {"container": {"image": "x", "run_options": "oops"}}],
    ids=["conda", "bad_conda", "both", "container", "no_image",
         "bad_run_options"])
def test_runtime_env_fields_match_jax(fields):
    got = [_outcome(lambda: dict(mod.RuntimeEnv(**fields)))
           for mod in (port_renv, jax_renv)]
    assert got[0] == got[1], got
    if len(fields) == 2:
        assert got[0][0] == "ValueError" and "container" in got[0][1]


SPEC = {"dependencies": ["python=3.11", "numpy", {"pip": ["einops==0.7.0"]}],
        "channels": ["conda-forge"]}


def test_digest_and_yaml_match_jax():
    same = {"channels": ["conda-forge"],
            "dependencies": ["python=3.11", "numpy",
                             {"pip": ["einops==0.7.0"]}]}
    d = _both("spec_digest", SPEC)[1]
    assert d == _both("spec_digest", same)[1]
    assert d != _both("spec_digest",
                      {**SPEC, "dependencies": ["python=3.12"]})[1]
    text = _both("emit_environment_yaml", {**SPEC, "name": "e"})[1]
    for line in ('name: "e"', '  - "conda-forge"', '  - "python=3.11"',
                 '  - "pip":', '    - "einops==0.7.0"'):
        assert line in text


@pytest.mark.parametrize("binary", ["/u/bin/conda", "/u/bin/mamba",
                                    "/u/bin/micromamba"])
def test_create_env_command_matches_jax(binary):
    cmd = _both("create_env_command", binary, "/p", "/f.yml")[1]
    assert cmd[0] == binary and cmd[-4:] == ["-p", "/p", "-f", "/f.yml"]


def test_prefix_resolution_matches_jax(tmp_path, monkeypatch):
    prefix = make_fake_env(tmp_path)
    assert _both("resolve_env_prefix", str(prefix)) == ("ok", str(prefix))
    (tmp_path / "empty").mkdir()
    out = _both("resolve_env_prefix", str(tmp_path / "empty"))
    assert out[0] == "RuntimeEnvSetupError" and "bin/python" in out[1]
    envs = tmp_path / "envs"
    named = make_fake_env(envs, "research")
    monkeypatch.setenv("CONDA_ENVS_PATH", str(envs))
    assert _both("resolve_env_prefix", "research") == ("ok", str(named))
    monkeypatch.delenv("CONDA_ENVS_PATH")
    monkeypatch.delenv("CONDA_PREFIX", raising=False)
    out = _both("resolve_env_prefix", "definitely-not-an-env", binary=None)
    assert out[0] == "RuntimeEnvSetupError" and "not found" in out[1]


def test_worker_conda_command_matches_jax_but_for_the_module(
        tmp_path, monkeypatch):
    prefix = make_fake_env(tmp_path)
    for pythonpath in (None, "/extra"):
        if pythonpath is None:
            monkeypatch.delenv("PYTHONPATH", raising=False)
        else:
            monkeypatch.setenv("PYTHONPATH", pythonpath)
        port_cmd, port_env = port_conda.worker_conda_command(
            str(prefix), {"RAY_TPU_TORCH_WORKER_ID": "abc"})
        jax_cmd, jax_env = jax_conda.worker_conda_command(
            str(prefix), {"RAY_TPU_TORCH_WORKER_ID": "abc"})
        assert port_cmd == [str(prefix / "bin" / "python"), "-m",
                            "ray_tpu_torch._private.worker_process"]
        assert jax_cmd[:-1] == port_cmd[:-1]
        assert jax_cmd[-1] == "ray_tpu._private.worker_process"
        # both packages live in this checkout: one package parent
        assert port_env == jax_env
        assert port_env["PYTHONPATH"].split(os.pathsep)[0] == PKG_PARENT
        assert "" not in port_env["PYTHONPATH"].split(os.pathsep)
        assert port_env["CONDA_PREFIX"] == str(prefix)
        assert port_env["PATH"].startswith(str(prefix / "bin"))
        assert port_env["RAY_TPU_TORCH_WORKER_ID"] == "abc"


def _fake_conda(tmp_path):
    """A stand-in solver: records its argv, then creates the prefix with
    bin/python as ``conda env create`` would."""
    script = tmp_path / "conda"
    log = tmp_path / "calls.jsonl"
    script.write_text(f"""#!{sys.executable}
import json, os, sys
args = sys.argv[1:]
with open({str(log)!r}, "a") as f:
    f.write(json.dumps(args) + "\\n")
p = args[args.index("-p") + 1]
os.makedirs(os.path.join(p, "bin"), exist_ok=True)
os.symlink({sys.executable!r}, os.path.join(p, "bin", "python"))
""")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), log


def test_materialization_matches_jax(tmp_path):
    """A dict spec is created once under its digest and then cached; the
    solver gets the same argv and environment.yml from both packages."""
    binary, log = _fake_conda(tmp_path)
    spec = {"dependencies": ["python=3.11"]}
    prefixes, ymls = [], []
    for name, mod in (("port", port_conda), ("jax", jax_conda)):
        cache = str(tmp_path / name)
        p1 = mod.ensure_conda_env(spec, cache, binary=binary)
        assert mod.ensure_conda_env(spec, cache, binary=binary) == p1
        prefixes.append(os.path.relpath(p1, cache))
        ymls.append(open(p1 + ".yml").read())
    calls = [json.loads(x) for x in log.read_text().splitlines()]
    assert len(calls) == 2 and calls[0][:2] == ["env", "create"]
    assert prefixes[0] == prefixes[1]
    assert ymls[0] == ymls[1] and '"python=3.11"' in ymls[0]


def test_failed_create_and_missing_binary_match_jax(tmp_path, monkeypatch):
    bad = tmp_path / "badconda"
    bad.write_text(f"#!{sys.executable}\nraise SystemExit(1)\n")
    bad.chmod(bad.stat().st_mode | stat.S_IEXEC)
    got = []
    for name, mod in (("port", port_conda), ("jax", jax_conda)):
        cache = tmp_path / name
        failed = _outcome(mod.ensure_conda_env, {"dependencies": ["x"]},
                          str(cache), binary=str(bad))
        left = sorted(os.listdir(cache / "conda_envs"))
        monkeypatch.setattr(mod, "conda_binary", lambda: None)
        missing = _outcome(mod.ensure_conda_env, {"dependencies": ["y"]},
                           str(cache))
        got.append((failed, left, missing))
    assert got[0] == got[1]
    (failed, left, missing) = got[0]
    assert failed[0] == "RuntimeEnvSetupError" and \
        "create failed" in failed[1]
    assert all(x.endswith((".lock", ".yml")) for x in left)
    assert missing[0] == "RuntimeEnvSetupError" and \
        "no conda/mamba/micromamba" in missing[1]


# ------------------------------------------------------------ container
CSPEC = {"image": "raytpu-worker:dev", "run_options": ["--cap-drop", "ALL"]}


@pytest.mark.parametrize("spec", [{}, {"image": "x", "run_options": "oops"},
                                  {"image": "x"}, CSPEC, "img"],
                         ids=["no_image", "bad_run_options", "image",
                              "options", "str"])
def test_container_spec_checks_match_jax(spec):
    got = [_outcome(mod.validate_container_spec, spec)
           for mod in (port_container, jax_container)]
    assert got[0] == got[1]


@pytest.mark.parametrize("engine,mounts", [
    ("docker", ["/tmp/session"]), ("podman", ["/s", "/s"])])
def test_build_container_command_matches_jax(engine, mounts):
    got = [mod.build_container_command(CSPEC, ["python", "-m", "w"],
                                       mounts=mounts, env={"A": "1"},
                                       engine=engine)
           for mod in (port_container, jax_container)]
    assert got[0] == got[1]
    cmd = got[0]
    assert cmd[:3] == [engine, "run", "--rm"]
    img = cmd.index("raytpu-worker:dev")
    assert cmd[img - 2:img] == ["--cap-drop", "ALL"]
    assert cmd.count(f"{mounts[0]}:{mounts[0]}") == 1


def test_worker_container_command_matches_jax_but_for_the_module(tmp_path):
    """The port mounts its package's parent and runs its own worker; it
    adds no device flag of its own (devices ride ``run_options``)."""
    args = (CSPEC, str(tmp_path / "sess"), str(tmp_path / "store"),
            {"RAY_TPU_TORCH_WORKER_ID": "abc"})
    port = port_container.worker_container_command(*args, engine="docker")
    ref = jax_container.worker_container_command(*args, engine="docker")
    assert port[-3:] == ["python", "-m",
                         "ray_tpu_torch._private.worker_process"]
    assert ref[-3:] == ["python", "-m", "ray_tpu._private.worker_process"]
    assert port[:-1] == ref[:-1]
    joined = " ".join(port)
    assert f"{PKG_PARENT}:{PKG_PARENT}" in joined
    assert f"{tmp_path}/store:{tmp_path}/store" in joined
    assert not any(a.startswith("--gpus") or a == "--device" for a in port)


def test_no_engine_is_a_setup_error_in_both(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda *_: None)
    got = [_outcome(mod.worker_container_command, {"image": "x"},
                    str(tmp_path), str(tmp_path), {})
           for mod in (port_container, jax_container)]
    assert got[0] == got[1]
    assert got[0][0] == "RuntimeEnvSetupError" and \
        "podman nor docker" in got[0][1]


def test_spawn_time_plugins_are_registered():
    from ray_tpu_torch.runtime_env.plugin import get_plugin

    for name in ("conda", "container"):
        assert get_plugin(name).spawn_time


def test_tagged_lease_never_takes_a_pristine_worker():
    """``_pop_idle_worker(tagged_only=True)`` skips untagged workers: a
    host process cannot enter an image or another interpreter."""
    import ray_tpu_torch._private.agent as agent_mod

    class FakeProc:
        def poll(self):
            return None

    class FakeAgent:
        _pop_idle_worker = agent_mod.NodeAgent._pop_idle_worker

    a = FakeAgent()
    pristine = agent_mod.WorkerHandle("w1", proc=FakeProc())
    pristine.registered.set()
    a.idle_workers = [pristine]
    assert a._pop_idle_worker("envhash", tagged_only=True) is None
    tagged = agent_mod.WorkerHandle("w2", proc=FakeProc())
    tagged.registered.set()
    tagged.env_key = "envhash"
    a.idle_workers = [pristine, tagged]
    assert a._pop_idle_worker("envhash", tagged_only=True) is tagged


# ------------------------------------------------- the port's runtime
@pytest.fixture(scope="module")
def port_gpu():
    ray_tpu_torch.init(num_cpus=2, resources={"GPU": 1})
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_task_runs_under_the_prefix_interpreter(port_gpu, tmp_path):
    prefix = make_bootable_env(tmp_path, "taskenv")

    @ray_tpu_torch.remote(runtime_env={"conda": str(prefix)})
    def whereami():
        import torch

        return (sys.executable, os.environ.get("CONDA_PREFIX"),
                torch.__version__, "jax" in sys.modules)

    exe, env_prefix, version, jax_loaded = ray_tpu_torch.get(
        whereami.remote(), timeout=120)
    import torch

    assert exe == str(prefix / "bin" / "python")
    assert env_prefix == str(prefix)
    assert version == torch.__version__ and not jax_loaded

    @ray_tpu_torch.remote(num_gpus=1, runtime_env={"conda": str(prefix)})
    def gpu_lease():
        return sys.executable, os.environ.get("CUDA_VISIBLE_DEVICES")

    assert ray_tpu_torch.get(gpu_lease.remote(), timeout=120) == (
        str(prefix / "bin" / "python"), "0")

    @ray_tpu_torch.remote
    def host():
        return sys.executable

    assert ray_tpu_torch.get(host.remote(), timeout=60) == sys.executable


def test_missing_env_fails_fast(port_gpu):
    from ray_tpu_torch.runtime_env import RuntimeEnvSetupError

    @ray_tpu_torch.remote(runtime_env={"conda": "no-such-env-anywhere"})
    def f():
        return 1

    with pytest.raises(RuntimeEnvSetupError, match="not found"):
        ray_tpu_torch.get(f.remote(), timeout=60)


@pytest.mark.skipif(not HAVE_ENGINE, reason="no podman/docker on this host")
def test_worker_starts_in_container(port_gpu):
    @ray_tpu_torch.remote(runtime_env={
        "container": {"image": "python:3.12-slim"}})
    def whoami():
        import os

        return os.path.exists("/.dockerenv") or \
            os.path.exists("/run/.containerenv")

    assert ray_tpu_torch.get(whoami.remote(), timeout=300)


def test_jax_package_is_untouched_by_the_port():
    """The reference's plugins stay the reference's (one registry each)."""
    from ray_tpu.runtime_env.plugin import get_plugin as jax_get
    from ray_tpu_torch.runtime_env.plugin import get_plugin as port_get

    assert type(port_get("conda")).__module__ == \
        "ray_tpu_torch.runtime_env.conda"
    assert type(jax_get("conda")).__module__ == "ray_tpu.runtime_env.conda"
