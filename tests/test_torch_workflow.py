"""The port's durable workflows on its runtime, on the CPU: the 5 cases of
the JAX package's ``tests/test_workflow_continuation.py`` (continuations,
resume after a kill across a continuation, durable HTTP events, a remote
store, virtual actors) on a one-node ``cluster_utils.Cluster`` of the port,
then what is the port's own: a step that returns a torch tensor is
checkpointed as a CPU tensor of the same bits and resumed as one, and a
resume reruns no step. Last, one DAG of plain Python values runs through
both packages' durable executors in this process over a temporary store,
held result for result, step for step and key for key.

One port cluster a module; the kill case runs its two drivers in
processes of their own, each with its own runtime, as the reference's
does."""

import json
import os
import subprocess
import sys
import uuid

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.cluster_utils import Cluster  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    session_dir = c.session_dir
    try:
        ray_tpu_torch.init(_node=c.head_node)
        c.wait_for_nodes()
        yield ray_tpu_torch
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    port_session_leak_check(session_dir)


def test_continuation_dynamic_steps(cluster, tmp_path):
    """A step decides at run time to fan into more steps (recursive
    factorial via continuation)."""
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))
    calls = str(tmp_path / "calls")

    @ray_tpu_torch.remote
    def fact(n, acc):
        open(calls, "a").write("x")
        if n <= 1:
            return acc
        return workflow.continuation(fact.bind(n - 1, acc * n))

    out = workflow.run(fact.bind(5, 1), workflow_id="wf_fact")
    assert out == 120
    assert len(open(calls).read()) == 5
    assert workflow.get_status("wf_fact") == "SUCCESSFUL"


def test_resume_after_kill_across_continuation(cluster, tmp_path):
    """Kill the driver mid-continuation; a fresh process resumes from the
    continuation's own checkpoints: pre-crash steps don't re-run."""
    script = r"""
import os, sys
import ray_tpu_torch
from ray_tpu_torch import workflow

storage, counters, mode = sys.argv[1], sys.argv[2], sys.argv[3]
ray_tpu_torch.init(num_cpus=2)
workflow.init(storage)

@ray_tpu_torch.remote(max_retries=0)
def chain(i, n):
    open(os.path.join(counters, f"ran_{i}"), "a").write("x")
    if i == 2 and os.path.exists(os.path.join(counters, "do_crash")):
        os.unlink(os.path.join(counters, "do_crash"))
        os._exit(7)  # worker dies mid-continuation; no retries -> fail
    if i + 1 >= n:
        return i
    return workflow.continuation(chain.bind(i + 1, n))

out = workflow.run(chain.bind(0, 5), workflow_id="wf_kill")
print("RESULT", out)
ray_tpu_torch.shutdown()
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    counters = tmp_path / "counters"
    counters.mkdir()
    (counters / "do_crash").touch()
    storage = str(tmp_path / "wf_storage")

    first = subprocess.run(
        [sys.executable, "-c", script, storage, str(counters), "crash"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert first.returncode != 0, first.stdout + first.stderr
    assert (counters / "ran_0").exists() and (counters / "ran_1").exists()
    assert not (counters / "ran_3").exists()

    second = subprocess.run(
        [sys.executable, "-c", script, storage, str(counters), "resume"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "RESULT 4" in second.stdout
    assert open(counters / "ran_0").read() == "x"
    assert open(counters / "ran_1").read() == "x"
    assert open(counters / "ran_2").read() == "xx"
    assert open(counters / "ran_4").read() == "x"


def test_http_event_durable_delivery(cluster, tmp_path):
    """The HTTP provider commits the payload to storage before acking; a
    workflow that starts after delivery still sees the event."""
    import threading
    import time
    import urllib.request

    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))
    key = f"evt-{uuid.uuid4().hex[:6]}"
    listener = workflow.HTTPEventProvider(key, timeout_s=60)

    def send():
        port_rel = f"_events/{key}.port"
        store = workflow._Store(workflow._storage_root)
        for _ in range(200):
            data = store.read_bytes(port_rel)
            if data:
                port = int(data)
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/event/{key}",
                    data=b"payload-42", method="POST")
                urllib.request.urlopen(req, timeout=10)
                return
            time.sleep(0.05)

    t = threading.Thread(target=send, daemon=True)
    t.start()
    payload = listener.poll_for_event()
    t.join(timeout=30)
    assert payload == b"payload-42"
    again = workflow.HTTPEventProvider(key, timeout_s=1).poll_for_event()
    assert again == b"payload-42"


def test_workflow_remote_storage(cluster):
    """Checkpoints land in a (fake) bucket via the storage registry."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch._private.storage import get_storage_backend

    bucket = f"mock://wfbucket-{uuid.uuid4().hex[:8]}"
    try:
        workflow.init(bucket)

        @ray_tpu_torch.remote
        def double(x):
            return x * 2

        out = workflow.run(double.bind(21), workflow_id="wf_remote")
        assert out == 42
        assert workflow.get_status("wf_remote") == "SUCCESSFUL"
        backend = get_storage_backend(bucket)
        assert backend.exists(bucket + "/wf_remote/status.json")
        assert workflow.resume("wf_remote", double.bind(21)) == 42
    finally:
        get_storage_backend(bucket).delete(bucket)
        workflow.init(os.path.expanduser("~/ray_tpu_torch_workflows"))


def test_virtual_actor_durable_state(cluster, tmp_path):
    """Durable actor: state survives a fresh handle, every method call is a
    real task, and commits are atomic."""
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))

    @workflow.virtual_actor
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

        def get(self):
            return self.n

    c = Counter.get_or_create("c1", 10)
    assert c.incr.run() == 11
    assert c.incr.run(5) == 16
    c2 = Counter.get_or_create("c1")
    assert c2.get.run() == 16
    assert c2.state()["n"] == 16
    assert c2.incr.run_async(4).result(timeout=60) == 20
    other = Counter.get_or_create("c2", 100)
    assert other.get.run() == 100


def test_tensor_step_resumes_as_the_same_cpu_tensor(cluster, tmp_path):
    """A step that returns a torch tensor: the driver gets a CPU tensor of
    the same dtype, shape and bits, the checkpoint holds it, and a resume
    returns it again without running a step."""
    import torch

    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))
    ran = str(tmp_path / "ran")

    @ray_tpu_torch.remote
    def make(seed):
        import torch as t

        open(ran, "a").write("m")
        g = t.Generator().manual_seed(seed)
        return t.randn(4, 8, generator=g).to(t.bfloat16)

    @ray_tpu_torch.remote
    def reduce(x):
        open(ran, "a").write("r")
        return {"x": x, "sum": x.double().sum(dim=-1)}

    dag = reduce.bind(make.bind(3))
    out = workflow.run(dag, workflow_id="wf_tensor")
    want = torch.randn(4, 8, generator=torch.Generator().manual_seed(3)
                       ).to(torch.bfloat16)
    assert out["x"].device.type == "cpu" and out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"], want)
    assert torch.equal(out["sum"], want.double().sum(dim=-1))
    assert open(ran).read() == "mr"

    again = workflow.resume("wf_tensor", dag)
    assert open(ran).read() == "mr"  # no step ran
    assert again["x"].device.type == "cpu"
    assert torch.equal(again["x"], out["x"])
    assert torch.equal(again["sum"], out["sum"])
    assert workflow.get_status("wf_tensor") == "SUCCESSFUL"


def test_resume_of_a_finished_dag_reruns_no_step(cluster, tmp_path):
    """``resume`` of a finished two-step workflow serves every step from its
    checkpoint: no step runs again, and its status stays SUCCESSFUL."""
    from ray_tpu_torch import workflow

    workflow.init(str(tmp_path))
    ran = str(tmp_path / "ran")

    @ray_tpu_torch.remote
    def inc(x):
        open(ran, "a").write("x")
        return x + 1

    dag = inc.bind(inc.bind(40))
    assert workflow.run(dag, workflow_id="wf_twice") == 42
    assert open(ran).read() == "xx"
    assert workflow.resume("wf_twice", dag) == 42
    assert open(ran).read() == "xx"
    assert workflow.get_status("wf_twice") == "SUCCESSFUL"


def _durable_run(pkg, root, monkeypatch):
    """A four-step DAG of plain Python values (one step fails on its first
    call, one hands off to a three-deep continuation) through ``pkg``'s own
    ``workflow`` in this process, each step's ``remote`` a direct call and
    ``get`` the identity: what each run, resume and listing returns, which
    steps each ran, and every file it left in the store with its value."""
    import importlib
    from types import SimpleNamespace

    wf = importlib.import_module(f"{pkg}.workflow")
    dag = importlib.import_module(f"{pkg}.dag")
    ser = importlib.import_module(f"{pkg}._private.serialization")
    store = root / pkg
    monkeypatch.setattr(wf, "_storage_root", str(store))
    monkeypatch.setattr(wf.ray_tpu if pkg == "ray_tpu" else wf.ray_tpu_torch,
                        "get", lambda ref: ref)
    calls, failed = [], []

    def remote(fn):
        def call(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return SimpleNamespace(__name__=fn.__name__, remote=call)

    def double(x):
        return 2 * x

    def inc(x):
        if not failed:
            failed.append(1)
            raise RuntimeError("first call fails")
        return x + 1

    def fact(n, acc):
        if n <= 1:
            return acc
        return wf.continuation(dag.FunctionNode(r_fact, (n - 1, acc * n), {}))

    def combine(a, b, c):
        return {"a": a, "b": b, "c": c}

    r_fact = remote(fact)
    x = dag.FunctionNode(remote(double), (3,), {})
    y = dag.FunctionNode(remote(inc), (x,), {})
    f = dag.FunctionNode(r_fact, (4, 1), {})
    root_node = dag.FunctionNode(remote(combine), (x, y, f), {})

    got = {}
    with pytest.raises(RuntimeError, match="first call fails"):
        wf.run(root_node, workflow_id="wf_parity")
    got["after_failure"] = (wf.get_status("wf_parity"), list(calls))
    calls.clear()
    got["resume"] = (wf.resume("wf_parity", root_node), list(calls))
    calls.clear()
    got["resume_again"] = (wf.resume("wf_parity", root_node), list(calls))
    got["status"] = wf.get_status("wf_parity")
    got["list_all"] = wf.list_all()
    files = {}
    for dirpath, _, names in os.walk(store):
        for name in names:
            rel = os.path.relpath(os.path.join(dirpath, name), store)
            with open(os.path.join(dirpath, name), "rb") as fh:
                data = fh.read()
            if rel.endswith(".pkl"):
                value = ser.loads(data)
                files[rel] = (type(value).__name__
                              if isinstance(value, wf.Continuation) else value)
            else:
                files[rel] = json.loads(data)["status"]
    got["files"] = files
    return got


def test_durable_executor_matches_jax(tmp_path, monkeypatch):
    """The same DAG through both packages' ``_DurableExecutor`` over a
    temporary store: the same results, the same steps run by the failed
    run and by each resume (the second reruns nothing), the same status
    and ``list_all``, and the same step keys written with the same values."""
    jax_got = _durable_run("ray_tpu", tmp_path, monkeypatch)
    port_got = _durable_run("ray_tpu_torch", tmp_path, monkeypatch)
    assert port_got == jax_got
    assert port_got["resume"] == ({"a": 6, "b": 7, "c": 24},
                                  ["inc", "fact", "fact", "fact", "fact",
                                   "combine"])
    assert port_got["resume_again"][1] == []
    assert port_got["after_failure"] == ("FAILED", ["double", "inc"])
    assert port_got["list_all"] == [{"workflow_id": "wf_parity",
                                     "status": "SUCCESSFUL"}]
    # status.json and a checkpoint each for double, inc, fact, the three
    # levels of fact's continuation and combine
    assert len(port_got["files"]) == 8
