"""The port's cross-language calls, dynamic resources and ``tqdm_ray`` on
its runtime, on the CPU: the Python-side cases of the JAX package's
``tests/test_cpp_client.py`` and, where g++ is found (gated as there), its
C++ driver and C++ worker cases, with ``cpp/`` built into a temporary
directory (``make -C cpp BUILD=<dir>``, so nothing under ``cpp/`` changes);
the two ``dynamic_resources`` cases of ``tests/test_util_extras.py``; a
``tqdm_ray`` round trip; an actor looked up while it is pending, whose
calls the JAX package's worker loses and the port's delivers; and each
new module's public names against the JAX package's.

One port cluster a module: the C++ worker registers with its agent."""

import importlib
import inspect
import os
import shutil
import subprocess
import sys
import time

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

CPP_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cpp")
HAVE_GXX = shutil.which("g++") is not None and shutil.which("make") is not None


@pytest.fixture(scope="module")
def port2():
    ray_tpu_torch.init(num_cpus=2)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


@pytest.fixture(scope="module")
def cpp_build(tmp_path_factory):
    build = tmp_path_factory.mktemp("cpp_build")
    subprocess.run(["make", "-s", "-C", CPP_DIR, f"BUILD={build}"],
                   check=True, timeout=300)
    return str(build)


def _agent_tcp_port():
    w = ray_tpu_torch._private.worker.global_worker
    view = w._acall(w.head.call("GetClusterView", {}))
    return list(view.values())[0]["addr"]["port"]


@pytest.fixture(scope="module")
def cpp_worker(port2, cpp_build):
    proc = subprocess.Popen(
        [os.path.join(cpp_build, "example_worker"), "127.0.0.1",
         str(_agent_tcp_port())],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    time.sleep(1.0)
    yield proc
    proc.terminate()
    proc.wait(timeout=30)


# ------------------------------------ tests/test_cpp_client.py, Python side
def test_load_pyref_colon_and_dotted():
    from ray_tpu_torch._private.function_table import load_pyref

    assert load_pyref("operator:add")(2, 3) == 5
    assert load_pyref("os.path.join")("a", "b") == os.path.join("a", "b")
    with pytest.raises(Exception):
        load_pyref("nonexistent_module_xyz:fn")


def test_xlang_fid_resolves_by_name():
    from ray_tpu_torch._private.function_table import (
        XLANG_PYREF_FID, load_function)

    fn = load_function(XLANG_PYREF_FID, None, None, name="operator:mul")
    assert fn(6, 7) == 42


def test_xlang_task_end_to_end_from_python(port2):
    """A spec shaped exactly like the C++ client's through a real worker:
    by-name function, 'x' msgpack args, msgpack return."""
    import msgpack

    from ray_tpu_torch._private.function_table import XLANG_PYREF_FID
    from ray_tpu_torch._private.protocol import AsyncRpcClient

    worker = ray_tpu_torch._private.worker.global_worker

    async def push():
        reply = await worker.agent.call("RequestWorkerLease", {
            "resources": {"CPU": 10000},
            "owner": "xlang-test", "retriable": False,
        })
        grant = reply["grant"]
        client = AsyncRpcClient()
        await client.connect_tcp(grant["addr"]["host"],
                                 grant["addr"]["port"])
        spec = {
            "task_id": os.urandom(16), "job_id": b"xlg0",
            "task_type": 0, "function_id": XLANG_PYREF_FID,
            "function_name": "operator:add",
            "args": [("x", msgpack.packb(19)), ("x", msgpack.packb(23))],
            "kwargs": {}, "num_returns": 1, "resources": {},
            "owner_addr": {"host": "", "port": 0, "worker_id": "00" * 16},
        }
        result = await client.call("PushTask", spec)
        await worker.agent.call(
            "ReturnWorker", {"lease_id": grant["lease_id"]})
        await client.aclose()
        return result

    result = worker._acall(push(), timeout=120)
    assert not result.get("error")
    assert msgpack.unpackb(result["returns"][0]["xlang"]) == 42


# --------------------------------------- tests/test_cpp_client.py, g++ side
@pytest.mark.skipif(not HAVE_GXX, reason="no g++ on this box")
def test_cpp_driver_against_live_cluster(port2, cpp_build):
    binary = os.path.join(cpp_build, "example_driver")
    out = subprocess.run(
        [binary, "127.0.0.1", str(ray_tpu_torch._global_node.head_port)],
        capture_output=True, text=True, timeout=240)
    sys.stdout.write(out.stdout)
    sys.stderr.write(out.stderr)
    assert out.returncode == 0
    assert "KV from-cpp" in out.stdout
    assert "SUM 42" in out.stdout
    assert "TOTAL 30" in out.stdout
    assert "CAUGHT" in out.stdout and "int" in out.stdout
    assert "CPP_DRIVER_OK" in out.stdout
    from ray_tpu_torch.experimental import internal_kv

    assert internal_kv._internal_kv_get(b"cpp_key") == b"from-cpp"


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ on this box")
def test_python_calls_cpp_function(cpp_worker):
    from ray_tpu_torch.cross_language import cpp_function

    assert ray_tpu_torch.get(cpp_function("cpp.add").remote(2, 3, 5),
                             timeout=60) == 10
    assert ray_tpu_torch.get(cpp_function("cpp.fib").remote(20),
                             timeout=60) == 6765
    assert ray_tpu_torch.get(
        cpp_function("cpp.echo").remote({"k": [1, 2, "three"]}),
        timeout=60) == {"k": [1, 2, "three"]}


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ on this box")
def test_cpp_error_propagates(cpp_worker):
    from ray_tpu_torch.cross_language import cpp_function

    with pytest.raises(Exception, match="deliberate C\\+\\+ failure"):
        ray_tpu_torch.get(cpp_function("cpp.fail").remote(), timeout=60)
    with pytest.raises(Exception, match="no such C"):
        ray_tpu_torch.get(cpp_function("cpp.nope").remote(), timeout=60)


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ on this box")
def test_burst_rides_stream_batches(cpp_worker):
    from ray_tpu_torch.cross_language import cpp_function

    refs = [cpp_function("cpp.add").remote(i, i) for i in range(60)]
    assert sum(ray_tpu_torch.get(refs, timeout=120)) == sum(
        2 * i for i in range(60))


@pytest.mark.skipif(not HAVE_GXX, reason="no g++ on this box")
def test_roundtrip_python_task_calls_cpp(cpp_worker):
    """Py driver -> Py worker task -> C++ worker -> back."""

    @ray_tpu_torch.remote
    def via_python(x):
        from ray_tpu_torch.cross_language import cpp_function

        return ray_tpu_torch.get(cpp_function("cpp.fib").remote(x)) + 1

    assert ray_tpu_torch.get(via_python.remote(10), timeout=120) == 56


# ---------------------------------- tests/test_util_extras.py, dynamic
def test_dynamic_resources_gate_scheduling(port2):
    from ray_tpu_torch.experimental.dynamic_resources import set_resource

    @ray_tpu_torch.remote
    def probe():
        return "ran"

    ref = probe.options(resources={"slots": 1}).remote()
    ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=2)
    assert not ready  # infeasible until declared
    set_resource("slots", 2)
    assert ray_tpu_torch.get(ref, timeout=60) == "ran"
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            ray_tpu_torch.cluster_resources().get("slots") != 2:
        time.sleep(0.3)
    assert ray_tpu_torch.cluster_resources().get("slots") == 2
    set_resource("slots", 0)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and \
            ray_tpu_torch.cluster_resources().get("slots", 0):
        time.sleep(0.3)
    assert ray_tpu_torch.cluster_resources().get("slots", 0) == 0


def test_dynamic_resources_rejects_builtins(port2):
    from ray_tpu_torch.experimental.dynamic_resources import set_resource

    with pytest.raises(ValueError, match="built-in"):
        set_resource("CPU", 16)
    with pytest.raises(ValueError, match="built-in"):
        set_resource("GPU", 1)


# ------------------------------------------------------------ tqdm_ray
def test_tqdm_ray_round_trip(port2):
    """Bars in a task report through the driver's aggregator actor: its
    state holds each bar's last count, closed."""
    from ray_tpu_torch.experimental import tqdm_ray

    @ray_tpu_torch.remote
    def work(n):
        from ray_tpu_torch.experimental import tqdm_ray as tq

        total = 0
        for i in tq.tqdm(range(n), desc=f"bar{n}"):
            total += i
        return total

    assert ray_tpu_torch.get([work.remote(5), work.remote(7)],
                             timeout=120) == [10, 21]
    agg = tqdm_ray._get_aggregator()
    deadline = time.monotonic() + 30
    bars = {}
    while time.monotonic() < deadline:
        bars = {b["desc"]: b for b in ray_tpu_torch.get(
            agg.state.remote(), timeout=30).values()}
        if all(bars.get(d, {}).get("closed") for d in ("bar5", "bar7")):
            break
        time.sleep(0.2)
    assert bars["bar5"]["n"] == 5 and bars["bar5"]["total"] == 5
    assert bars["bar7"]["n"] == 7 and bars["bar7"]["closed"]
    ray_tpu_torch.kill(agg)


# ------------------------------- an actor looked up while it is pending
def test_actor_looked_up_while_pending_answers(port2):
    """The window that lost ``tqdm_ray`` bars: an actor looked up while
    PENDING_CREATION whose ALIVE lands before the lookup is tracked. The
    JAX package's worker (``get_named_actor``, the same code) drops the
    events of an untracked actor and never reads the view again, so its
    handle's calls wait forever; the port's reads the view again after
    tracking, and the call answers.

    A task creates a named actor that waits for a custom resource; this
    driver looks it up while it is pending and, before tracking it,
    declares the resource and waits until the actor is ALIVE and its
    ALIVE event has reached this process."""
    import uuid

    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.experimental.dynamic_resources import set_resource

    w = worker_mod.global_worker
    tag = uuid.uuid4().hex[:8]
    name, res = f"late_{tag}", f"late_res_{tag}"

    @ray_tpu_torch.remote
    class Late:
        def ping(self):
            return "pong"

    @ray_tpu_torch.remote
    def make():
        Late.options(name=name, lifetime="detached",
                     resources={res: 1}).remote()

    ray_tpu_torch.get(make.remote(), timeout=60)
    seen = []

    def late_track(actor_id, view):
        if view.get("state") == "PENDING_CREATION":
            seen.append(view["state"])
            set_resource(res, 1)
            deadline = time.monotonic() + 30
            while w.head_call("GetActor", {"actor_id": actor_id.hex()}
                              ).get("state") != "ALIVE":
                assert time.monotonic() < deadline
                time.sleep(0.05)
            time.sleep(0.5)
        return type(w)._track_actor(w, actor_id, view)

    w._track_actor = late_track
    try:
        handle = ray_tpu_torch.get_actor(name)
    finally:
        del w._track_actor
    try:
        assert seen == ["PENDING_CREATION"]
        assert ray_tpu_torch.get(handle.ping.remote(), timeout=30) == "pong"
    finally:
        ray_tpu_torch.kill(handle)
        set_resource(res, 0)


# --------------------------------------------- public names, both packages
NEW_MODULES = ["job_submission", "dashboard", "dashboard.web",
               "dashboard.grafana", "scripts", "scripts.cli", "workflow",
               "experimental.tqdm_ray", "experimental.dynamic_resources",
               "cross_language"]
RENAMED = {"generate_tpu_dashboard": "generate_gpu_dashboard"}


def _public(mod):
    """The public names a module defines or binds, modules left out."""
    out = set()
    for name, value in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(value):
            continue
        if (inspect.isfunction(value) or inspect.isclass(value)) and \
                not value.__module__.startswith(mod.__name__.split(".")[0]):
            continue  # imported from outside the package: typing, stdlib
        out.add(name)
    return out


@pytest.mark.parametrize("name", NEW_MODULES)
def test_public_names_match_jax(name):
    port = importlib.import_module(f"ray_tpu_torch.{name}")
    ref = importlib.import_module(f"ray_tpu.{name}")
    want = {RENAMED.get(n, n) for n in _public(ref)}
    assert _public(port) == want
