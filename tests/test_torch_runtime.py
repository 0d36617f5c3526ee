"""ray_tpu_torch's copy of the runtime on the CPU: the same small programs
through ``ray_tpu`` and ``ray_tpu_torch`` give the same results; tensors
cross process boundaries with their dtype and shape; the port's sessions,
daemons and settings stay apart from the JAX package's; a GPU lease sets
``CUDA_VISIBLE_DEVICES`` without touching CUDA.

One port cluster per module. The JAX package's cluster runs the parity
programs once, in a module fixture, and is shut down straight after; its
session lies outside the JAX package's session roots (``jax_session``), so
that the other test processes' session-end reaping never sees it. Remote
functions and classes are defined inside the tests, so that they travel by
value and no worker imports this module (and with it jax)."""

import asyncio
import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu._private import lifecycle as jax_lifecycle  # noqa: E402
from ray_tpu_torch._private import lifecycle as port_lifecycle  # noqa: E402
from ray_tpu_torch._private.accelerators import nvidia_gpu  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the other workers' files end well inside the tier's time limit
OTHER_SESSIONS_WAIT_S = 600.0


def port_session_leak_check(session_dir: str) -> None:
    """Fail if the port's session outlived its shutdown. The JAX package's
    session-end gate does not see the port's root, so the port's files
    check their own sessions."""
    left = [s for s in port_lifecycle.list_sessions()
            if os.path.normpath(s["path"]) == os.path.normpath(session_dir)]
    if left:
        live = ", ".join(f"{r.get('role', '?')}:{r['pid']}"
                         for r in left[0]["live"])
        port_lifecycle.reap_session(session_dir, remove=True)
        pytest.fail(f"ray_tpu_torch session {session_dir} outlived its "
                    f"shutdown [live: {live or 'none'}]", pytrace=False)


def spawner(pid: int, var: str = "RAY_TPU_PARENT_PID"):
    """The pid that started a daemon: its ``RAY_TPU_PARENT_PID`` (the JAX
    package's) or ``RAY_TPU_TORCH_PARENT_PID`` (the port's)."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            env = f.read().split(b"\0")
    except OSError:
        return None
    for kv in env:
        if kv.startswith(var.encode() + b"="):
            try:
                return int(kv.split(b"=", 1)[1])
            except ValueError:
                return None
    return None


def _is_mine(pid: int) -> bool:
    """``pid`` is this process or one of its descendants."""
    me = os.getpid()
    for _ in range(64):
        if pid == me:
            return True
        try:
            with open(f"/proc/{pid}/stat") as f:
                pid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            return False
        if pid <= 1:
            return False
    return False


def other_processes_jax_sessions():
    """The JAX sessions under ``default_session_roots()`` whose head or
    agent another live process started: under ``pytest -n``, the sessions
    of the other workers' running tests."""
    out = []
    for sess in jax_lifecycle.list_sessions():
        for rec in sess["live"]:
            if rec.get("role") not in ("gcs", "agent"):
                continue
            owner = spawner(rec["pid"])
            if owner and not _is_mine(owner) and \
                    os.path.exists(f"/proc/{owner}"):
                out.append(sess["path"])
                break
    return out


def port_sessions_started_here():
    """The port's live sessions whose head or agent this process started."""
    return [s["path"] for s in port_lifecycle.list_sessions()
            if any(r.get("role") in ("gcs", "agent") and
                   spawner(r["pid"], "RAY_TPU_TORCH_PARENT_PID") ==
                   os.getpid() for r in s["live"])]


@pytest.fixture
def no_port_session_left():
    """For a test that boots and shuts down port clusters of its own: none
    of them outlives it."""
    assert port_sessions_started_here() == []
    yield
    assert port_sessions_started_here() == []


@pytest.fixture(scope="session", autouse=True)
def other_workers_jax_sessions_end():
    """Hold this process's session end until the other workers' live JAX
    sessions have ended (at most ``OTHER_SESSIONS_WAIT_S``). Under ``pytest
    -n``, each worker's session-end ``lifecycle_leak_gate`` lists every
    session under the JAX package's roots that its own baseline lacked: a
    session another worker's test is running then is reaped under that
    test, and reported as a leak against this worker's last test. Set up
    after the gate, this fixture is torn down before it. A session whose
    starter is this process, or has died, is not waited for: the gate
    still reports and reaps every real leak."""
    yield
    deadline = time.monotonic() + OTHER_SESSIONS_WAIT_S
    while other_processes_jax_sessions() and time.monotonic() < deadline:
        time.sleep(0.5)


@contextlib.contextmanager
def jax_session(num_cpus: int = 4, nodes=()):
    """``ray_tpu.init(num_cpus=num_cpus)`` on a node whose session dir lies
    outside the JAX package's ``lifecycle.default_session_roots()``: under
    ``pytest -n``, every other worker's session-end ``lifecycle_leak_gate``
    reaps the live sessions under those roots, and this one it never lists.
    ``nodes`` are the resources of more nodes to join, as
    ``Cluster.add_node`` would. The dir is short (unix socket paths under
    ``<session>/sockets`` are limited to 108 bytes) and is removed after.
    Yields the root that holds the session, for
    ``list_sessions(session_roots=[root])``."""
    from ray_tpu._private.node import Node

    base = "/dev/shm" if os.path.isdir("/dev/shm") else \
        tempfile.gettempdir()
    top = tempfile.mkdtemp(prefix="rtj-", dir=base)
    root = os.path.join(top, "ray_tpu")
    session_dir = os.path.join(root, "session_ref")
    node, joined = None, []
    try:
        node = Node(head=True, resources={"CPU": float(num_cpus)},
                    session_dir=session_dir)
        node.start()
        for res in nodes:
            joined.append(Node(head=False, head_port=node.head_port,
                               resources=dict(res), session_dir=session_dir))
            joined[-1].start()
        # init(_node=...) attaches to a started node and leaves
        # _global_node unset; set it, so that shutdown() stops the node
        # and removes its session as it does after a plain init()
        ray_tpu.init(_node=node)
        ray_tpu._global_node = node
        deadline = time.monotonic() + 30
        while sum(n["alive"] for n in ray_tpu.nodes()) < 1 + len(joined):
            assert time.monotonic() < deadline, "nodes did not join"
            time.sleep(0.1)
        yield root
    finally:
        for n in joined:
            n.stop()
        ray_tpu.shutdown()
        if node is not None:
            node.stop(cleanup_session=True)
        shutil.rmtree(top, ignore_errors=True)


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


@pytest.fixture(scope="module")
def jax_reference(port_cluster, tmp_path_factory):
    """The parity programs' results through ``ray_tpu``, and both packages'
    session lists while both clusters were up."""
    tmp = str(tmp_path_factory.mktemp("jax_reference"))
    with jax_session() as root:
        return {"session": ray_tpu._global_node.session_dir,
                "results": {p.__name__: p(ray_tpu, tmp) for p in PROGRAMS},
                "jax_paths": {s["path"] for s in jax_lifecycle.list_sessions(
                    session_roots=[root])},
                "port_paths": {s["path"] for s in
                               port_lifecycle.list_sessions()}}


# ---------------------------------------------------------------- daemons

def _mapped_libs(pid: int) -> str:
    with open(f"/proc/{pid}/maps") as f:
        return f.read()


def test_daemons_and_parked_workers_import_neither_torch_nor_jax(
        port_cluster):
    """Runs first in the module: the head, the agent, the forkserver
    template and the warm workers it forked have neither torch's nor jax's
    libraries mapped, and a task landing on a parked worker finds neither
    in ``sys.modules``."""
    records = port_lifecycle.list_registered(port_cluster)
    roles = {r["role"] for r in records}
    assert {"gcs", "agent"} <= roles, roles
    for rec in records:
        try:
            maps = _mapped_libs(rec["pid"])
        except OSError:
            continue  # a worker that exited meanwhile
        for lib in ("libtorch", "jaxlib", "xla_extension"):
            assert lib not in maps, f"{rec['role']} {rec['pid']} maps {lib}"

    # built by exec: a function of no importable module travels by value
    ns = {"__name__": "_probe"}
    exec("def probe():\n"
         "    import sys\n"
         "    return sorted(m for m in ('torch', 'jax', 'ray_tpu')\n"
         "                  if m in sys.modules)\n", ns)
    probe = ray_tpu_torch.remote(ns["probe"])
    assert ray_tpu_torch.get([probe.remote() for _ in range(4)],
                             timeout=60) == [[]] * 4


def test_package_import_keeps_torch_out():
    """``import ray_tpu_torch`` and the modules its daemons run import no
    torch; ``resolve_device`` loads it on first use."""
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.serve\n"
        "import ray_tpu_torch._private.gcs, ray_tpu_torch._private.agent\n"
        "import ray_tpu_torch._private.worker_process\n"
        "import ray_tpu_torch._private.worker_forkserver\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
        "ray_tpu_torch.resolve_device('cpu')\n"
        "assert 'torch' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# ---------------------------------------------------------------- parity

def _fanout(rt, tmp):
    @rt.remote
    def square(x):
        return x * x

    return rt.get([square.remote(i) for i in range(16)], timeout=60)


def _actor_state(rt, tmp):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def add(self, k):
            self.n += k
            return self.n

    c = Counter.remote(10)
    out = [rt.get(c.add.remote(k), timeout=60) for k in (1, 2, 3)]
    rt.kill(c)
    return out


def _shm_put_get(rt, tmp):
    arr = np.random.default_rng(3).standard_normal((512, 512))  # 2 MiB
    ref = rt.put(arr)
    got = rt.get(ref, timeout=60)
    return [got.shape, got.dtype.str, float(got.sum()),
            bool(np.array_equal(got, arr))]


def _refs_as_args(rt, tmp):
    @rt.remote
    def make(n):
        import numpy

        return numpy.arange(n, dtype=numpy.int64)

    @rt.remote
    def total(a, b):
        return int(a.sum() + b.sum())

    return rt.get(total.remote(make.remote(300_000), make.remote(5)),
                  timeout=60)


def _crash_retry(rt, tmp):
    marker = os.path.join(tmp, f"crashed-{rt.__name__}")

    @rt.remote(max_retries=2)
    def flaky(path):
        import os

        if not os.path.exists(path):
            open(path, "w").close()
            os._exit(1)
        return "recovered"

    return rt.get(flaky.remote(marker), timeout=90)


PROGRAMS = [_fanout, _actor_state, _shm_put_get, _refs_as_args,
            _crash_retry]


@pytest.mark.parametrize("program", PROGRAMS,
                         ids=lambda f: f.__name__.strip("_"))
def test_runtime_parity(program, port_cluster, jax_reference, tmp_path):
    got = program(ray_tpu_torch, str(tmp_path))
    assert got == jax_reference["results"][program.__name__]


# ---------------------------------------------------------------- tensors

def _tensor(dtype, layout):
    vals = np.random.default_rng(5).standard_normal((256, 1024))
    if dtype == torch.int64:
        vals = vals * 1000
    base = torch.from_numpy(vals).to(dtype)
    return base if layout == "contiguous" else base.t()[::3]


@pytest.mark.parametrize("layout", ["contiguous", "non_contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64],
                         ids=["fp32", "bf16", "int64"])
def test_tensor_round_trip_through_a_worker(dtype, layout, port_cluster):
    """A CPU tensor goes to a worker and comes back (and through
    ``put``/``get``): a ``torch.Tensor`` of the same dtype, shape and
    values each way. Contiguous tensors of numpy's dtypes take the zero-copy
    array path, the rest torch's own pickling."""
    t = _tensor(dtype, layout)
    assert t.is_contiguous() == (layout == "contiguous")

    @ray_tpu_torch.remote
    def echo(x):
        import torch as _torch

        return (type(x) is _torch.Tensor, str(x.dtype), tuple(x.shape), x)

    is_tensor, dt, shape, back = ray_tpu_torch.get(echo.remote(t),
                                                   timeout=60)
    assert (is_tensor, dt, shape) == (True, str(dtype), tuple(t.shape))
    assert type(back) is torch.Tensor and back.device.type == "cpu"
    assert back.dtype == dtype and back.shape == t.shape
    assert torch.equal(back, t)
    got = ray_tpu_torch.get(ray_tpu_torch.put(t), timeout=60)
    assert got.dtype == dtype and got.shape == t.shape
    assert torch.equal(got, t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64],
                         ids=["fp32", "bf16", "int64"])
def test_writing_a_received_tensor_leaves_the_object_as_it_was(
        dtype, port_cluster):
    """Sealed objects are immutable: an in-place op on a tensor from
    ``get`` (or on a task's argument) changes neither a second ``get`` of
    the same ref nor what a task reading that ref sees."""
    t = _tensor(dtype, "contiguous")
    ref = ray_tpu_torch.put(t)
    first = ray_tpu_torch.get(ref, timeout=60)
    first.add_(1)
    assert not torch.equal(first, t)

    @ray_tpu_torch.remote
    def write_then_sum(x):
        before = x.double().sum().item()
        x += 1
        return before

    @ray_tpu_torch.remote
    def total(x):
        return x.double().sum().item()

    want = t.double().sum().item()
    assert ray_tpu_torch.get(write_then_sum.remote(ref), timeout=60) == want
    assert ray_tpu_torch.get(total.remote(ref), timeout=60) == want
    assert torch.equal(ray_tpu_torch.get(ref, timeout=60), t)


def test_zero_copy_path_is_taken_for_numpy_dtypes():
    from ray_tpu_torch._private.serialization import (
        SerializationContext, is_zero_copy)

    ctx = SerializationContext()
    for dtype, want in ((torch.float32, True), (torch.int64, True),
                        (torch.bfloat16, False)):
        t = _tensor(dtype, "contiguous")
        blob = ctx.serialize(t).to_bytes()
        assert is_zero_copy(memoryview(blob)) is want, dtype
        assert not is_zero_copy(memoryview(
            ctx.serialize(_tensor(dtype, "non_contiguous")).to_bytes()))


# ------------------------------------------------------- sessions, GPUs

def test_sessions_apart_from_the_jax_package(port_cluster, jax_reference):
    port_root = os.path.dirname(port_cluster)
    jax_session = jax_reference["session"]
    # the root is this checkout's own: ray_tpu_torch-<hash of the package
    # directory>, so a second checkout's GC never walks this one's sessions
    assert os.path.basename(port_root) == port_lifecycle.session_root_name()
    assert port_lifecycle.session_root_name().startswith("ray_tpu_torch-")
    assert port_root in port_lifecycle.default_session_roots()
    assert os.path.basename(os.path.dirname(jax_session)) == "ray_tpu"
    jax_paths, port_paths = (jax_reference["jax_paths"],
                             jax_reference["port_paths"])
    assert port_cluster in port_paths and jax_session in jax_paths
    assert not any(p.startswith(port_root + os.sep) for p in jax_paths)
    assert jax_session not in port_paths
    # settings: the port reads RAY_TPU_TORCH_*, its workers get its own
    # session dir under that name
    @ray_tpu_torch.remote
    def env():
        import os as _os

        return (_os.environ.get("RAY_TPU_TORCH_SESSION_DIR"),
                _os.environ.get("RAY_TPU_SESSION_DIR"))

    assert ray_tpu_torch.get(env.remote(), timeout=60) == (port_cluster,
                                                            None)


def test_gpu_lease_sets_cuda_visible_devices(port_cluster):
    """``init(resources={"GPU": 1})``: an actor with ``num_gpus=1`` sees
    ``CUDA_VISIBLE_DEVICES=0``, and the lease touches no CUDA: a fresh
    process with the actor's environment that loads the worker's stack and
    applies the lease's device ids has not imported torch. (The actor's own
    process may be an idle worker that ran a tensor task before, so it is
    not the one asked.)"""
    assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0

    @ray_tpu_torch.remote(num_gpus=1)
    class GpuHolder:
        def where(self):
            import os as _os
            import subprocess as _sp
            import sys as _sys

            import ray_tpu_torch as _pkg

            code = ("import os, sys\n"
                    "from ray_tpu_torch._private import worker_process\n"
                    "worker_process._apply_accelerator_env({'GPU': [0]})\n"
                    "print(os.environ['CUDA_VISIBLE_DEVICES'], "
                    "'torch' in sys.modules)\n")
            root = _os.path.dirname(_os.path.dirname(_pkg.__file__))
            env = dict(_os.environ, PYTHONPATH=root)
            res = _sp.run([_sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
            return (_os.environ.get("CUDA_VISIBLE_DEVICES"),
                    res.stdout.split(), res.stderr[-2000:])

    actor = GpuHolder.remote()
    try:
        visible, fresh, err = ray_tpu_torch.get(actor.where.remote(),
                                                timeout=90)
        assert visible == "0"
        assert fresh == ["0", "False"], err
    finally:
        ray_tpu_torch.kill(actor)


def test_nvidia_gpu_count_falls_back_to_nvidia_smi(monkeypatch):
    import glob
    import subprocess as sp

    mgr = nvidia_gpu.NvidiaGPUAcceleratorManager
    monkeypatch.delenv("RAY_TPU_TORCH_NUM_GPUS", raising=False)
    monkeypatch.setattr(glob, "glob", lambda pattern: [])
    listing = ("GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-0)\n"
               "GPU 1: NVIDIA H100 80GB HBM3 (UUID: GPU-1)\n")
    calls = []

    def fake_run(cmd, **kw):
        calls.append((cmd, kw.get("timeout")))
        return types.SimpleNamespace(returncode=0, stdout=listing)

    monkeypatch.setattr(sp, "run", fake_run)
    assert mgr.get_current_node_num_accelerators() == 2
    assert calls == [(["nvidia-smi", "-L"], 10)]

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(sp, "run", missing)
    assert mgr.get_current_node_num_accelerators() == 0
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "3")
    assert mgr.get_current_node_num_accelerators() == 3


# ------------------------------------------------ ported touch points

def test_capture_torch_trace_writes_a_chrome_trace(tmp_path):
    from ray_tpu_torch._private.worker_process import (
        _handle_capture_torch_trace)

    rep = asyncio.run(_handle_capture_torch_trace(
        None, {"duration_s": 0.05, "out_dir": str(tmp_path)}))
    assert "error" not in rep, rep
    assert rep["pid"] == os.getpid() and len(rep["files"]) == 1
    with open(tmp_path / rep["files"][0]) as f:
        assert '"traceEvents"' in f.read()


def test_usage_stats_report_torch_only_where_loaded(tmp_path):
    from ray_tpu_torch._private.usage import usage_lib

    data = usage_lib._collect()
    assert data["torch_version"] == torch.__version__
    assert data["num_devices"] == torch.cuda.device_count()
    code = ("import sys, json\n"
            "from ray_tpu_torch._private.usage import usage_lib\n"
            "d = usage_lib._collect()\n"
            "assert 'torch' not in sys.modules\n"
            "assert 'torch_version' not in d, d\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_conda_spec_without_a_binary_is_a_setup_error(port_cluster):
    """A dict conda spec needs a conda, mamba or micromamba binary on the
    node to materialize the env: without one the lease fails with
    ``RuntimeEnvSetupError`` (the reference's
    ``test_no_binary_is_setup_error``, through the agent). The DAG API is
    ported: ``bind`` builds a node."""
    import shutil

    from ray_tpu_torch.dag import FunctionNode
    from ray_tpu_torch.runtime_env import RuntimeEnvSetupError

    assert not any(shutil.which(b) for b in ("conda", "mamba",
                                             "micromamba"))

    @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["pip"]}})
    def f():
        return 1

    with pytest.raises(RuntimeEnvSetupError,
                       match="no conda/mamba/micromamba"):
        ray_tpu_torch.get(f.remote(), timeout=60)
    assert isinstance(f.bind(), FunctionNode)
