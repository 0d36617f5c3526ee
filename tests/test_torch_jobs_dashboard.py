"""The port's job submission and dashboard on its runtime, on the CPU: the
5 cases of the JAX package's ``tests/test_job_submission.py`` and the 10 of
``tests/test_dashboard.py``, then what ties them to the reference:

- the record a supervisor writes, and its status, for the same entrypoints
  in both packages (each supervisor run in this process over a dict for
  its KV, so no JAX runtime starts);
- the dashboard's route table, the reference's with ``jax_trace`` renamed
  ``torch_trace``; ``generate_core_dashboard()`` equal to the reference's;
- the variables the supervisor sets for its entrypoint, and the
  entrypoint's registration in the session;
- the reference's bare ``init()``, which the port keeps: it starts a new
  local cluster and never reads ``RAY_TPU_TORCH_ADDRESS``;
- ``PUT /api/serve/applications`` of the ``tiny`` ``build_llama_app``
  through ``import_path`` + ``args``, then a job whose entrypoint streams
  through the app's handle the tokens of the port's in-process generator.

One port cluster a module. Entrypoints run ``sys.executable``."""

import ast
import inspect
import json
import os
import shlex
import sys
import tempfile
import time
import urllib.error
import urllib.request
import uuid

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.dashboard import start_dashboard  # noqa: E402
from ray_tpu_torch.job_submission import (  # noqa: E402
    JobStatus, JobSubmissionClient)
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = shlex.quote(sys.executable)


@pytest.fixture(scope="module")
def port4():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    from ray_tpu_torch import serve

    serve.shutdown()
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


@pytest.fixture(scope="module")
def dash_port(port4):
    @ray_tpu_torch.remote
    def warm():
        return 1

    ray_tpu_torch.get(warm.remote(), timeout=60)
    return start_dashboard(port=0)


@pytest.fixture(scope="module")
def client(port4):
    return JobSubmissionClient()


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


# ----------------------------------------------- tests/test_dashboard.py
def test_healthz(dash_port):
    status, _, body = _get(dash_port, "/healthz")
    assert status == 200
    assert b"success" in body.lower()


def test_api_nodes(dash_port):
    status, ctype, body = _get(dash_port, "/api/nodes")
    assert status == 200 and "json" in ctype
    nodes = json.loads(body)
    assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"


def test_api_actors_and_tasks(dash_port):
    status, _, body = _get(dash_port, "/api/actors")
    assert status == 200
    actors = json.loads(body)
    assert isinstance(actors, list)
    assert any(a.get("class_name") == "DashboardActor" for a in actors)

    # driver task events flush on a ~2s cadence; poll for arrival
    deadline = time.time() + 15
    seen = False
    while time.time() < deadline and not seen:
        status, _, body = _get(dash_port, "/api/tasks")
        assert status == 200
        tasks = json.loads(body)
        seen = any(t.get("name", "").endswith("warm") for t in tasks)
        if not seen:
            time.sleep(0.5)
    assert seen, "warm task never appeared in /api/tasks"


def test_api_cluster_status(dash_port):
    status, _, body = _get(dash_port, "/api/cluster_status")
    assert status == 200
    payload = json.loads(body)
    assert payload["total"].get("CPU") == 4.0
    assert "available" in payload


def test_metrics_prometheus_text(dash_port):
    status, ctype, body = _get(dash_port, "/metrics")
    assert status == 200
    assert "text/plain" in ctype
    text = body.decode()
    assert "# HELP" in text or "# TYPE" in text or text.strip() != ""


def test_unknown_route_404s(dash_port):
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        _get(dash_port, "/api/definitely_not_a_route")
    assert exc_info.value.code == 404


def test_index_page_serves_ui(dash_port):
    """The web UI: one static page over the REST API, its TPU tile and
    column read as GPU."""
    status, ctype, body = _get(dash_port, "/")
    assert status == 200 and "text/html" in ctype
    html = body.decode()
    for anchor in ('id="nodes"', 'id="actors"', 'id="jobs"',
                   'id="events"', 'id="tiles"'):
        assert anchor in html, anchor
    for ep in ("/api/nodes", "/api/actors", "/api/jobs", "/api/events",
               "/api/cluster_status", "/api/node_stats"):
        assert ep in html, ep
        st, _, _ = _get(dash_port, ep)
        assert st == 200, ep
    assert "GPU in use" in html and "total.GPU" in html
    assert "TPU" not in html


def test_grafana_dashboards_endpoint(dash_port):
    status, ctype, body = _get(dash_port, "/grafana/dashboards")
    assert status == 200 and "json" in ctype
    dashboards = json.loads(body)["dashboards"]
    assert {d["uid"] for d in dashboards} == {"raytpu-core", "raytpu-gpu"}


def test_grafana_factory_offline(tmp_path):
    """Factory output is valid Grafana JSON wired to the published gauges;
    the GPU dashboard reads the agent's GPU duty and leasing gauges, the
    reference's TPU dashboard's two panels, and the GPUs leased."""
    from ray_tpu_torch.dashboard.grafana import (
        generate_core_dashboard, generate_gpu_dashboard,
        save_grafana_dashboards)

    dash = generate_core_dashboard()
    assert dash["schemaVersion"] >= 36
    exprs = [t["expr"] for p in dash["panels"] for t in p["targets"]]
    for metric in ("ray_tpu_node_cpu_percent", "ray_tpu_node_mem_used_bytes",
                   "ray_tpu_tpu_utilization", "ray_tpu_cluster_up",
                   "ray_tpu_object_store_used_bytes"):
        assert any(metric in e for e in exprs), metric
    assert all(p["datasource"]["uid"] == "${datasource}"
               for p in dash["panels"])
    gpu = [t["expr"] for p in generate_gpu_dashboard()["panels"]
           for t in p["targets"]]
    from ray_tpu.dashboard.grafana import generate_tpu_dashboard

    tpu = [t["expr"] for p in generate_tpu_dashboard()["panels"]
           for t in p["targets"]]
    assert gpu == [e.replace("_tpu_tpu_", "_tpu_gpu_") for e in tpu] + [
        'ray_tpu_resource_in_use{resource="GPU"}']

    paths = save_grafana_dashboards(str(tmp_path))
    assert len(paths) == 3
    for p in paths:
        with open(p) as f:
            json.load(f)


class _StatsAgent:
    """The agent's stats methods over a resource ledger, no runtime."""

    def __init__(self, agent_mod, rs_mod, name, total, leased):
        self._tpu_stats = agent_mod.NodeAgent._tpu_stats.__get__(self)
        if hasattr(agent_mod.NodeAgent, "_gpu_stats"):
            self._gpu_stats = agent_mod.NodeAgent._gpu_stats.__get__(self)
            self._gpu_duty = agent_mod.NodeAgent._gpu_duty.__get__(self)
        self.resources = rs_mod.NodeResources(
            rs_mod.ResourceSet({"CPU": 4, name: total}),
            accelerator_ids={name: list(range(int(total)))})
        self.resources.allocate(rs_mod.ResourceSet({name: leased}),
                                owner="w")


@pytest.mark.parametrize("total,leased,duty", [(2, 1, "42.5"), (1, 1, "0"),
                                               (4, 0, "100")])
def test_gpu_stats_match_the_references_tpu_stats(total, leased, duty,
                                                  monkeypatch):
    """``_gpu_stats`` under ``RAY_TPU_TORCH_FAKE_GPU_DUTY`` gives the
    fields the reference's ``_tpu_stats`` gives under
    ``RAY_TPU_FAKE_TPU_DUTY`` for the same ledger; without GPUs and
    without the override, nothing."""
    from ray_tpu._private import agent as jax_agent
    from ray_tpu._private import resources as jax_res
    from ray_tpu_torch._private import agent as port_agent
    from ray_tpu_torch._private import resources as port_res

    monkeypatch.setenv("RAY_TPU_TORCH_FAKE_GPU_DUTY", duty)
    monkeypatch.setenv("RAY_TPU_FAKE_TPU_DUTY", duty)
    got = _StatsAgent(port_agent, port_res, "GPU", total,
                      leased)._gpu_stats()
    want = _StatsAgent(jax_agent, jax_res, "TPU", total,
                       leased)._tpu_stats()
    assert got == want
    assert got["utilization"] == leased / total
    assert got["duty_cycle_percent"] == float(duty)
    monkeypatch.delenv("RAY_TPU_TORCH_FAKE_GPU_DUTY")
    assert _StatsAgent(port_agent, port_res, "TPU", 4,
                       0)._gpu_stats() == {}


def test_gpu_utilization_parser():
    from ray_tpu_torch._private.agent import parse_gpu_utilization

    assert parse_gpu_utilization("37\n0\n100\n") == [37.0, 0.0, 100.0]
    assert parse_gpu_utilization(" 5 \n\n") == [5.0]
    for bad in ("[N/A]\n", "[Not Supported]\n", "101\n", "-1\n"):
        with pytest.raises(ValueError):
            parse_gpu_utilization(bad)


def _fake_nvidia_smi(tmp_path, monkeypatch, body):
    """An ``nvidia-smi`` on PATH that records its argv and runs ``body``."""
    script = tmp_path / "nvidia-smi"
    log = tmp_path / "argv.txt"
    script.write_text(f"""#!{sys.executable}
import sys
open({str(log)!r}, "a").write(" ".join(sys.argv[1:]) + "\\n")
{body}
""")
    script.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.delenv("RAY_TPU_TORCH_FAKE_GPU_DUTY", raising=False)
    return log


def test_gpu_duty_reads_nvidia_smi_for_the_nodes_devices(tmp_path,
                                                         monkeypatch):
    """The duty is the mean ``utilization.gpu`` of the node's devices (its
    ids through the agent's ``CUDA_VISIBLE_DEVICES``), queried at most
    once a stats period."""
    from ray_tpu_torch._private import agent as port_agent
    from ray_tpu_torch._private import resources as port_res

    log = _fake_nvidia_smi(tmp_path, monkeypatch,
                           'print("30"); print("50")')
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    a = _StatsAgent(port_agent, port_res, "GPU", 2, 1)
    got = a._gpu_stats()
    assert got == {"chips_total": 2.0, "chips_in_use": 1.0,
                   "utilization": 0.5, "duty_cycle_percent": 40.0}
    assert a._gpu_stats() == got
    assert log.read_text().splitlines() == [
        "--query-gpu=utilization.gpu --format=csv,noheader,nounits -i 3,5"]


@pytest.mark.parametrize("body", ['print("[N/A]")', "raise SystemExit(9)",
                                  'print("30")'],
                         ids=["not_supported", "exit", "one_of_two"])
def test_failed_gpu_query_leaves_the_duty_out(body, tmp_path, monkeypatch,
                                              caplog):
    """A query that fails, or answers for fewer devices than the node
    has, leaves the duty out (the leasing fields stay) and logs once."""
    import logging

    from ray_tpu_torch._private import agent as port_agent
    from ray_tpu_torch._private import resources as port_res

    _fake_nvidia_smi(tmp_path, monkeypatch, body)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    a = _StatsAgent(port_agent, port_res, "GPU", 2, 0)
    with caplog.at_level(logging.WARNING, logger="ray_tpu_torch"):
        first = a._gpu_stats()
        a._gpu_duty_cache = None
        second = a._gpu_stats()
    assert first == second == {"chips_total": 2.0, "chips_in_use": 0.0,
                               "utilization": 0.0}
    assert [r.getMessage() for r in caplog.records].count(
        caplog.records[0].getMessage()) == 1
    assert "GPU duty gauge left out" in caplog.records[0].getMessage()


def test_system_metric_breadth(dash_port):
    """Scheduler, object store, head control plane and driver-side series
    all export through /metrics, under the reference's names."""
    import re

    from ray_tpu_torch.util.metrics import flush_now

    @ray_tpu_torch.remote
    def touch():
        return 1

    ray_tpu_torch.get([touch.remote() for _ in range(3)], timeout=60)
    ray_tpu_torch.get(ray_tpu_torch.put(b"z" * 200_000), timeout=30)
    deadline = time.time() + 30
    needed = [
        "ray_tpu_node_cpu_percent", "ray_tpu_node_load_avg_1m",
        "ray_tpu_node_disk_total_bytes", "ray_tpu_node_idle_workers",
        "ray_tpu_scheduler_active_leases",
        "ray_tpu_scheduler_leases_granted_total",
        "ray_tpu_resource_in_use",
        "ray_tpu_object_store_capacity_bytes",
        "ray_tpu_object_store_num_objects",
        "ray_tpu_object_store_created_total",
        "ray_tpu_gcs_nodes_alive", "ray_tpu_gcs_actors",
        "ray_tpu_gcs_kv_entries",
        "ray_tpu_tasks_submitted_total", "ray_tpu_puts_total",
        "ray_tpu_gets_total", "ray_tpu_owned_refs",
    ]
    while time.time() < deadline:
        flush_now()
        _, _, body = _get(dash_port, "/metrics")
        text = body.decode()
        missing = [n for n in needed if n not in text]
        if not missing:
            break
        time.sleep(1)
    assert not missing, f"missing series: {missing}"
    series = set(re.findall(r"^# TYPE (\S+)", text, re.M))
    assert len(series) >= 25, sorted(series)


# ---------------------------------------- tests/test_job_submission.py
def test_submit_and_succeed(client):
    job_id = client.submit_job(
        entrypoint=f"{PY} -c \"print('hello from job')\"")
    status = client.wait_until_finish(job_id, timeout_s=120)
    assert status == JobStatus.SUCCEEDED
    logs = client.get_job_logs(job_id)
    assert "hello from job" in logs
    info = client.get_job_info(job_id)
    assert info["status"] == "SUCCEEDED"
    assert info["entrypoint"].startswith(f"{PY} -c")


def test_failing_entrypoint_reports_failed(client):
    job_id = client.submit_job(
        entrypoint=f"{PY} -c 'import sys; sys.exit(3)'")
    status = client.wait_until_finish(job_id, timeout_s=120)
    assert status == JobStatus.FAILED


def test_submit_with_env_vars(client):
    job_id = client.submit_job(
        entrypoint=f"{PY} -c \"import os; print('V=' + os.environ['X1'])\"",
        runtime_env={"env_vars": {"X1": "42"}})
    assert client.wait_until_finish(job_id, timeout_s=120) == \
        JobStatus.SUCCEEDED
    assert "V=42" in client.get_job_logs(job_id)


def test_list_jobs_contains_submissions(client):
    jobs = client.list_jobs()
    assert len(jobs) >= 2
    assert all("status" in j and "entrypoint" in j for j in jobs)


def test_stop_running_job(client, port4):
    """Stop a running job; while it runs, its entrypoint is registered in
    the session under the role ``job``."""
    from ray_tpu_torch._private import lifecycle

    job_id = client.submit_job(
        entrypoint=f"{PY} -c 'import time; time.sleep(600)'")
    deadline = time.time() + 60
    while time.time() < deadline:
        st = client.get_job_status(job_id)
        if st == JobStatus.RUNNING:
            break
        time.sleep(0.3)
    deadline = time.time() + 30
    jobs = []
    while time.time() < deadline and not jobs:
        jobs = [r for r in lifecycle.list_registered(port4)
                if r["role"] == "job"]
        time.sleep(0.1)
    assert jobs, lifecycle.list_registered(port4)
    assert client.stop_job(job_id)
    deadline = time.time() + 30
    while time.time() < deadline:
        st = client.get_job_status(job_id)
        if st is not None and st.is_terminal():
            break
        time.sleep(0.3)
    assert st == JobStatus.STOPPED


# --------------------------------------------- held against the reference
class _DictKV:
    def __init__(self):
        self.data = {}

    def put(self, key, value, namespace=None):
        self.data[(namespace, key)] = value


def _supervise(mod, entrypoint, runtime_env=None):
    """One entrypoint through ``mod._JobSupervisor.run`` in this process,
    its KV a dict: (the returned status, the last record, the log)."""
    job_id = f"parity_{uuid.uuid4().hex[:8]}"
    sup = mod._JobSupervisor(job_id, entrypoint, runtime_env,
                             {"who": "test"}, "127.0.0.1:6379")
    kv = _DictKV()
    sup._kv = lambda: kv
    try:
        status = sup.run()
        log = sup.logs()
    finally:
        if os.path.exists(sup._log_path):
            os.remove(sup._log_path)
    (ns, key), = kv.data
    assert ns == mod._JOBS_NS and key == f"job::{job_id}".encode()
    return status, json.loads(kv.data[(ns, key)]), log, job_id


@pytest.mark.parametrize("entrypoint,want", [
    (f"{PY} -c \"print('hello from job')\"", "SUCCEEDED"),
    (f"{PY} -c 'import sys; sys.exit(3)'", "FAILED"),
    (f"{PY} -c \"import os; print('V=' + os.environ['X1'])\"", "SUCCEEDED"),
], ids=["succeeds", "fails", "env_vars"])
def test_job_record_matches_jax(entrypoint, want):
    """The same entrypoint through both packages' supervisors: the same
    status, the same record keys, message and metadata; the log path has
    the port's prefix."""
    from ray_tpu import job_submission as jax_jobs
    from ray_tpu_torch import job_submission as port_jobs

    env = {"env_vars": {"X1": "42"}}
    j_status, j_rec, j_log, _ = _supervise(jax_jobs, entrypoint, env)
    p_status, p_rec, p_log, job_id = _supervise(port_jobs, entrypoint, env)
    assert str(p_status.value if hasattr(p_status, "value") else p_status) \
        == str(j_status.value if hasattr(j_status, "value") else j_status)
    assert p_rec["status"] == j_rec["status"] == want
    assert sorted(p_rec) == sorted(j_rec)
    for key in ("message", "entrypoint", "metadata"):
        assert p_rec[key] == j_rec[key], key
    assert p_rec["log_path"] == os.path.join(
        tempfile.gettempdir(), f"ray_tpu_torch_job_{job_id}.log")
    assert p_log == j_log


def test_supervisor_sets_the_ports_variables():
    """The entrypoint sees the port's ``RAY_TPU_TORCH_ADDRESS`` and
    ``RAY_TPU_TORCH_JOB_ID`` where the reference's sees ``RAY_TPU_*``."""
    from ray_tpu import job_submission as jax_jobs
    from ray_tpu_torch import job_submission as port_jobs

    show = ("import json, os; print(json.dumps({k: v for k, v in "
            "os.environ.items() if k.endswith(('_ADDRESS', '_JOB_ID')) "
            "and k.startswith('RAY_TPU')}))")
    got = {}
    for name, mod in (("jax", jax_jobs), ("port", port_jobs)):
        status, _, log, job_id = _supervise(mod, f"{PY} -c {shlex.quote(show)}")
        assert status == "SUCCEEDED", log
        got[name] = (json.loads(log.strip().splitlines()[-1]), job_id)
    (jax_env, jax_id), (port_env, port_id) = got["jax"], got["port"]
    assert jax_env["RAY_TPU_ADDRESS"] == "127.0.0.1:6379"
    assert jax_env["RAY_TPU_JOB_ID"] == jax_id
    assert port_env["RAY_TPU_TORCH_ADDRESS"] == "127.0.0.1:6379"
    assert port_env["RAY_TPU_TORCH_JOB_ID"] == port_id


def _routes(mod):
    """The route table of ``mod.DashboardActor``: each string its
    ``_dispatch`` and ``_api`` compare the request's method, path or path
    parts with, or test the path's prefix with."""
    tree = ast.parse(inspect.getsource(mod.DashboardActor))
    out = set()
    for fn in ast.walk(tree):
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name in ("_dispatch", "_api")):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Compare):
                left = node.left
                subject = (left.id if isinstance(left, ast.Name) else
                           f"parts[{left.slice.value}]"
                           if isinstance(left, ast.Subscript)
                           and isinstance(left.value, ast.Name)
                           and left.value.id == "parts" else None)
                if subject not in ("path", "method", "parts[0]", "parts[1]",
                                   "parts[2]"):
                    continue
                for comp in node.comparators:
                    elts = comp.elts if isinstance(comp, ast.Tuple) else [comp]
                    out |= {(fn.name, subject, e.value) for e in elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, str)}
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "startswith"
                  and isinstance(node.func.value, ast.Name)
                  and node.func.value.id == "path"):
                out.add((fn.name, "path.startswith", node.args[0].value))
    return out


def test_route_table_matches_jax():
    from ray_tpu import dashboard as jax_dash
    from ray_tpu_torch import dashboard as port_dash

    jax_routes = _routes(jax_dash)
    assert ("_api", "parts[0]", "jax_trace") in jax_routes
    assert len(jax_routes) == 24
    want = {(f, s, "torch_trace" if v == "jax_trace" else v)
            for f, s, v in jax_routes}
    assert _routes(port_dash) == want


def test_core_grafana_dashboard_is_the_references():
    from ray_tpu.dashboard import grafana as jax_grafana
    from ray_tpu_torch.dashboard import grafana as port_grafana

    assert json.dumps(port_grafana.generate_core_dashboard(),
                      sort_keys=True) == json.dumps(
        jax_grafana.generate_core_dashboard(), sort_keys=True)


def test_torch_trace_route_replaces_jax_trace(dash_port):
    """``/api/torch_trace`` is routed where the reference's ``jax_trace``
    was (a bad request without a worker id), and ``jax_trace`` is not."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(dash_port, "/api/torch_trace")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(dash_port, "/api/jax_trace?worker_id=x")
    assert e.value.code == 404


# ------------------------------------------- the port's entrypoint paths
_STREAM = r"""
import json, os, sys
import ray_tpu_torch
from ray_tpu_torch import serve

ray_tpu_torch.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"],
                   num_gpus=0)
spec = json.loads(os.environ["STREAM_SPEC"])
handle = serve.get_app_handle(spec["app"])
tokens = [list(handle.options(stream=True, multiplexed_model_id=a).remote(
    {"prompt": p, "max_new": spec["max_new"]}))
    for p, a in zip(spec["prompts"], spec["adapters"])]
print("TOKENS " + json.dumps({"tokens": tokens,
                              "torch": "torch" in sys.modules}))
ray_tpu_torch.shutdown()
"""


def test_put_app_then_a_job_streams_through_it(client, dash_port):
    """Deploy the ``tiny`` preset's ``build_llama_app`` with ``PUT
    /api/serve/applications`` (``import_path`` + ``args``), then stream
    requests through its handle from a job: one at a time, the tokens of
    the port's in-process generator, with no torch in the job's process."""
    from ray_tpu_torch.serve.llm import LlamaGenerator

    gen_kw = dict(lora_rank=2, max_batch_size=2, allowed_batch_sizes=(1, 2),
                  max_new_tokens=6, seq_bucket=16)
    config = {"http_options": {"port": 0}, "applications": [{
        "name": "tiny", "route_prefix": "/tiny",
        "import_path": "ray_tpu_torch.serve.llm:build_llama_app",
        "args": dict(config="tiny", device="cpu", **gen_kw)}]}
    req = urllib.request.Request(
        f"http://127.0.0.1:{dash_port}/api/serve/applications",
        data=json.dumps(config).encode(), method="PUT")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
    deadline = time.time() + 120
    app = {}
    while time.time() < deadline:
        _, _, body = _get(dash_port, "/api/serve/applications")
        app = json.loads(body)["applications"].get("tiny", {})
        if app.get("status") == "RUNNING":
            break
        time.sleep(0.5)
    assert app.get("status") == "RUNNING", app
    assert app["route_prefix"] == "/tiny"

    prompts = [[3, 5, 7], [11, 2, 9, 4, 1], [3, 5, 7]]
    adapters = ["", "a1", "a2"]
    spec = {"app": "tiny", "prompts": prompts, "adapters": adapters,
            "max_new": 6}
    job_id = client.submit_job(
        entrypoint=f"{PY} -c {shlex.quote(_STREAM)}",
        runtime_env={"env_vars": {"PYTHONPATH": REPO,
                                  "STREAM_SPEC": json.dumps(spec)}})
    assert client.wait_until_finish(job_id, timeout_s=180) == \
        JobStatus.SUCCEEDED, client.get_job_logs(job_id)
    _, _, body = _get(dash_port, f"/api/jobs/{job_id}/logs")
    line, = [x for x in json.loads(body)["logs"].splitlines()
             if x.startswith("TOKENS ")]
    out = json.loads(line[7:])
    _, _, body = _get(dash_port, f"/api/jobs/{job_id}")
    assert json.loads(body)["status"] == "SUCCEEDED"

    gen = LlamaGenerator(config="tiny", device="cpu", **gen_kw)
    try:
        want = []
        for p, a in zip(prompts, adapters):
            state = gen._prefill({"prompt": p, "max_new": 6}, a)
            toks, done = [], False
            while not done:
                (nxt, done), = gen._step(a, [state])
                toks.append(nxt)
            want.append(toks)
    finally:
        gen.engine.shutdown()
    assert out["tokens"] == want
    assert out["tokens"][0] != out["tokens"][1]
    assert out["torch"] is False


_JOIN = r"""
import json, os, sys
import ray_tpu_torch

out = {}
ray_tpu_torch.init(num_cpus=1)  # no address: a cluster of its own
out["bare"] = {"head_port": ray_tpu_torch._global_node.head_port,
               "nodes": len(ray_tpu_torch.nodes())}
ray_tpu_torch.shutdown()
ray_tpu_torch.init(address=os.environ["RAY_TPU_TORCH_ADDRESS"],
                   num_gpus=0)
out["joined"] = {"head_port": ray_tpu_torch._global_node.head_port,
                 "nodes": len([n for n in ray_tpu_torch.nodes()
                               if n["alive"]])}
ray_tpu_torch.shutdown()
out["address"] = os.environ["RAY_TPU_TORCH_ADDRESS"]
print("JOIN " + json.dumps(out))
"""


def test_bare_init_starts_its_own_cluster(client):
    """The reference's bare ``init()`` (kept by the port): in an
    entrypoint it starts a new local cluster, whose head is not the job's;
    ``init(address=os.environ["RAY_TPU_TORCH_ADDRESS"])`` joins the job's
    cluster as a node of its own. Last in the module: for the seconds
    until the head marks that node dead, a ``serve.start`` waits on a
    proxy there (the reference's code does the same)."""
    job_id = client.submit_job(
        entrypoint=f"{PY} -c {shlex.quote(_JOIN)}",
        runtime_env={"env_vars": {"PYTHONPATH": REPO}})
    assert client.wait_until_finish(job_id, timeout_s=180) == \
        JobStatus.SUCCEEDED, client.get_job_logs(job_id)
    line, = [x for x in client.get_job_logs(job_id).splitlines()
             if x.startswith("JOIN ")]
    out = json.loads(line[5:])
    head_port = int(out["address"].rsplit(":", 1)[1])
    assert head_port == ray_tpu_torch._global_node.head_port
    assert out["bare"]["head_port"] != head_port
    assert out["bare"]["nodes"] == 1
    assert out["joined"]["head_port"] == head_port
    assert out["joined"]["nodes"] == 2
