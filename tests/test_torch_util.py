"""The port's ``util`` modules on its runtime, on the CPU: the cases of the
JAX package's ``tests/test_util.py`` for ``ActorPool``, ``Queue``,
``check_serialize`` and the state API, and the four cases of
``tests/test_chaos.py`` against the port's ``Cluster``, to the same
expectations. Where a result does not depend on the runtime's timing it is
held against the JAX package's: ``inspect_serializability``'s verdicts and
the names of what it blames, the state API's filters, and the public
names of each module. The state API's trace capture
(``capture_torch_trace``, the port of ``capture_jax_trace``) traces a
worker running torch ops.

The chaos cases boot and shut down their own clusters first; the other
cases share one port cluster (``num_cpus=4``). Remote functions and
actors are defined inside the tests, so that they travel by value and no
worker imports this module (and with it jax)."""

import json
import os
import threading
import time

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.util import ActorPool, Queue  # noqa: E402
from ray_tpu_torch.util.queue import Empty, Full  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


# ------------------------------------------------------------------- chaos
def test_tasks_survive_worker_killer():
    from ray_tpu_torch.util.chaos import WorkerKiller

    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    try:
        @ray_tpu_torch.remote(max_retries=5)
        def slow_square(x):
            import time

            time.sleep(0.3)
            return x * x

        killer = WorkerKiller(interval_s=0.4, max_kills=3, seed=1).run()
        try:
            refs = [slow_square.remote(k) for k in range(24)]
            results = ray_tpu_torch.get(refs, timeout=240)
        finally:
            kills = killer.stop()
        assert sorted(results) == sorted(k * k for k in range(24))
        assert len(kills) >= 1, "WorkerKiller never found a target"
    finally:
        ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_actor_restarts_under_worker_killer():
    from ray_tpu_torch.util.chaos import WorkerKiller

    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    try:
        @ray_tpu_torch.remote(max_restarts=10, max_task_retries=10)
        class Counter:
            def __init__(self):
                self.n = 0

            def bump(self):
                import time

                self.n += 1
                time.sleep(0.2)
                return self.n

        counter = Counter.remote()
        assert ray_tpu_torch.get(counter.bump.remote(), timeout=60) == 1
        killer = WorkerKiller(interval_s=0.5, max_kills=2, seed=2).run()
        try:
            values = [ray_tpu_torch.get(counter.bump.remote(), timeout=120)
                      for _ in range(12)]
        finally:
            kills = killer.stop()
        assert all(v >= 1 for v in values)
        assert ray_tpu_torch.get(counter.bump.remote(), timeout=120) >= 1
        assert len(kills) >= 1
    finally:
        ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def _alive():
    return sum(1 for n in ray_tpu_torch.nodes() if n["alive"])


def test_node_killer_marks_node_dead():
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.chaos import kill_random_node

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    session_dir = cluster.session_dir
    try:
        cluster.add_node(num_cpus=1)
        ray_tpu_torch.init(_node=cluster.head_node)
        cluster.wait_for_nodes()
        assert _alive() == 2
        record = kill_random_node(cluster)
        assert record and record.startswith("node ")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and _alive() != 1:
            time.sleep(0.5)
        assert _alive() == 1

        @ray_tpu_torch.remote
        def ping():
            return "ok"

        assert ray_tpu_torch.get(ping.remote(), timeout=60) == "ok"
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    port_session_leak_check(session_dir)


def test_node_killer_periodic_against_fleet():
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.chaos import NodeKiller

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    session_dir = cluster.session_dir
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=1)
        ray_tpu_torch.init(_node=cluster.head_node)
        cluster.wait_for_nodes()
        killer = NodeKiller(cluster, interval_s=0.5, max_kills=2,
                            seed=3).run()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and len(killer.kills) < 2:
            time.sleep(0.3)
        kills = killer.stop()
        assert len(kills) == 2, kills

        @ray_tpu_torch.remote
        def ping():
            return 1

        assert ray_tpu_torch.get(ping.remote(), timeout=60) == 1
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    port_session_leak_check(session_dir)


# ------------------------------------------------- one cluster for the rest
@pytest.fixture(scope="module")
def port4():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_actor_pool_map_ordered(port4):
    @ray_tpu_torch.remote
    class Worker:
        def double(self, v):
            return v * 2

    pool = ActorPool([Worker.remote(), Worker.remote()])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [0, 2, 4, 6, 8, 10, 12, 14]
    out = sorted(pool.map_unordered(
        lambda a, v: a.double.remote(v), range(8)))
    assert out == [0, 2, 4, 6, 8, 10, 12, 14]


def test_queue_basics(port4):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    with pytest.raises(Full):
        q.put(3, block=False)
    assert q.qsize() == 2
    assert q.get() == 1
    assert q.get() == 2
    with pytest.raises(Empty):
        q.get(block=False)
    with pytest.raises(Empty):
        q.get(timeout=0.2)
    q.shutdown()


def test_queue_producer_consumer(port4):
    q = Queue()

    @ray_tpu_torch.remote
    def produce(q, n):
        for i in range(n):
            q.put(i)
        return True

    ref = produce.remote(q, 10)
    got = [q.get(timeout=30) for _ in range(10)]
    assert got == list(range(10))
    assert ray_tpu_torch.get(ref)
    q.shutdown()


def test_state_api(port4):
    from ray_tpu_torch.util import state as state_api

    @ray_tpu_torch.remote
    class Stateful:
        def ping(self):
            return "pong"

    a = Stateful.remote()
    ray_tpu_torch.get(a.ping.remote())
    actors = state_api.list_actors()
    assert any(x.get("class_name") == "Stateful" for x in actors)
    nodes = state_api.list_nodes()
    assert nodes and nodes[0]["state"] == "ALIVE"

    @ray_tpu_torch.remote
    def named_task():
        return 1

    ray_tpu_torch.get(named_task.remote())
    tasks = state_api.list_tasks()
    assert any("named_task" in t.get("name", "") for t in tasks)
    summary = state_api.summarize_actors()
    assert "Stateful" in summary
    ray_tpu_torch.kill(a)


def test_capture_torch_trace_of_a_running_worker(port4, tmp_path):
    """The trace of an actor that runs torch ops on its main thread while
    the capture runs on its executor: a Chrome trace holding those ops.
    The actor spins from before the capture begins (``started``) until
    after it ends (``stop``). The worker's ``*.profiling`` file stands in
    the trace dir while the profiler records, and is gone after."""
    from ray_tpu_torch.util import state as state_api

    started, stop = str(tmp_path / "started"), str(tmp_path / "stop")

    @ray_tpu_torch.remote
    class Busy:
        def ids(self):
            ctx = ray_tpu_torch.get_runtime_context()
            return ctx.get_worker_id()

        def spin(self, started, stop):
            import os
            import time

            import torch

            x = torch.randn(64, 64)
            open(started, "w").close()
            end = time.monotonic() + 120
            n = 0
            while not os.path.exists(stop) and time.monotonic() < end:
                x = torch.tanh(x @ x.T / 64.0)
                n += 1
            return n

    busy = Busy.remote()
    worker_id = ray_tpu_torch.get(busy.ids.remote(), timeout=60)
    spinning = busy.spin.remote(started, stop)
    deadline = time.monotonic() + 60
    while not os.path.exists(started) and time.monotonic() < deadline:
        time.sleep(0.02)
    trace_dir = str(tmp_path / "trace")

    def marked():
        return os.path.isdir(trace_dir) and any(
            n.endswith(".profiling") for n in os.listdir(trace_dir))

    box = {}
    th = threading.Thread(target=lambda: box.setdefault(
        "out", state_api.capture_torch_trace(
            worker_id, duration_s=1.5, out_dir=trace_dir)))
    try:
        th.start()
        while th.is_alive() and not marked():
            time.sleep(0.01)
        saw_marker = marked()
        th.join(timeout=240)
    finally:
        open(stop, "w").close()
    out = box["out"]
    assert saw_marker
    assert not marked()
    assert ray_tpu_torch.get(spinning, timeout=60) > 0
    assert "error" not in out, out
    assert out["files"]
    path = os.path.join(out["trace_dir"], out["files"][0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("tanh" in n for n in names), sorted(names)[:40]
    ray_tpu_torch.kill(busy)


def test_state_names_and_filters_match_jax():
    """``__all__`` is the reference's with ``capture_jax_trace`` mapped to
    ``capture_torch_trace``; the filters give the reference's rows."""
    from ray_tpu.util import state as jstate
    from ray_tpu_torch.util import state as tstate

    want = ["capture_torch_trace" if n == "capture_jax_trace" else n
            for n in jstate.__all__]
    assert tstate.__all__ == want
    for name in tstate.__all__:
        assert callable(getattr(tstate, name))
    rows = [{"name": f"f{i}", "n": i, "state": "FINISHED" if i % 2 else
             "RUNNING"} for i in range(12)]
    for filters in ([("n", ">=", 5)], [("n", "<", "3")],
                    [("state", "=", "RUNNING"), ("n", ">", 4)],
                    [("name", "contains", "1")],
                    [("name", "!contains", "1"), ("state", "!=", "RUNNING")]):
        assert tstate._apply_filters(rows, filters) == \
            jstate._apply_filters(rows, filters)
    with pytest.raises(ValueError):
        tstate._apply_filters(rows, [("n", "~", 1)])


def test_util_names_match_jax():
    import ray_tpu.util as ju
    import ray_tpu.util.chaos as jchaos
    import ray_tpu_torch.util as tu
    import ray_tpu_torch.util.chaos as tchaos

    assert tu.__all__ == ju.__all__
    for name in ("ResourceKiller", "WorkerKiller", "NodeKiller",
                 "DaemonKiller", "HeadKiller", "NetworkPartitioner",
                 "kill_random_node"):
        assert hasattr(jchaos, name) and hasattr(tchaos, name)


def _lock_closure():
    import threading

    lock = threading.Lock()

    def f():
        return lock
    return f


def _deep_closure():
    import threading

    lock = threading.Lock()

    def f0():
        def f1():
            def f2():
                def f3():
                    def f4():
                        def f5():
                            return lock
                        return f5
                    return f4
                return f3
            return f2
        return f1
    return f0


@pytest.mark.parametrize("make", [
    lambda: (lambda x: x + 1), _lock_closure, _deep_closure],
    ids=["serializable", "offending_closure_var", "deep_nesting"])
def test_check_serialize_matches_jax(make):
    from ray_tpu.util.check_serialize import (
        inspect_serializability as jinspect)
    from ray_tpu_torch.util.check_serialize import inspect_serializability

    obj = make()
    ok, failures = inspect_serializability(obj, print_failures=False)
    jok, jfailures = jinspect(obj, print_failures=False)
    assert ok == jok
    assert sorted(t.name for t in failures) == \
        sorted(t.name for t in jfailures)
    if make is _lock_closure:
        assert not ok and any("lock" in t.name for t in failures)
    if make is _deep_closure:
        assert not ok and failures
