"""The port's autoscaler (``ray_tpu_torch.autoscaler``) on the CPU, held
against the JAX package's (``ray_tpu.autoscaler``):

- ``get_nodes_to_launch`` on both backends (the C++ bin-packer and the
  Python one, chosen by each package's own ``*_NATIVE_SCHED`` knob), the
  cases of ``tests/test_autoscaler.py`` and its native/Python fuzz;
- ``StandardAutoscaler.update`` over one fake provider and one fake GCS:
  the same launches, drains and terminations tick for tick;
- the GKE pod-slice provider and the GKE REST client under one scripted
  transport: the same request bodies, calls and errors;
- the cluster launcher's commands through a recording runner: equal but
  for the CLI's module;
- the v2 instance manager's lifecycle and versioning.

Then one ``AutoscalingCluster`` session of the port (the file's one
runtime): a ``min_workers`` node comes up and stays, a ``num_gpus=1`` task
scales a ``{"CPU": 2, "GPU": 1}`` node up (``CUDA_VISIBLE_DEVICES=0`` in
the task) and idleness scales it down, a ``request_resources`` pin holds a
node until it is cleared, and ``v2.get_cluster_status`` reads totals the
session set, ``GPU`` included."""

import copy
import json
import os
import random
import time

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu._private.resources import ResourceSet as JaxResourceSet  # noqa: E402
from ray_tpu.autoscaler import autoscaler as jax_autoscaler  # noqa: E402
from ray_tpu.autoscaler import gke as jax_gke  # noqa: E402
from ray_tpu.autoscaler import gke_rest as jax_gke_rest  # noqa: E402
from ray_tpu.autoscaler import launcher as jax_launcher  # noqa: E402
from ray_tpu.autoscaler import resource_demand_scheduler as jax_rds  # noqa: E402
from ray_tpu.autoscaler.v2 import instance_manager as jax_im  # noqa: E402
from ray_tpu_torch._private.resources import ResourceSet  # noqa: E402
from ray_tpu_torch.autoscaler import autoscaler as port_autoscaler  # noqa: E402
from ray_tpu_torch.autoscaler import gke as port_gke  # noqa: E402
from ray_tpu_torch.autoscaler import gke_rest as port_gke_rest  # noqa: E402
from ray_tpu_torch.autoscaler import launcher as port_launcher  # noqa: E402
from ray_tpu_torch.autoscaler import resource_demand_scheduler as rds  # noqa: E402
from ray_tpu_torch.autoscaler.v2 import instance_manager as port_im  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

PACKAGES = {"port": (rds, ResourceSet), "jax": (jax_rds, JaxResourceSet)}


def _pack(pkg, types, demands, pools, counts, max_workers, total):
    mod, rs = PACKAGES[pkg]
    return mod.get_nodes_to_launch(
        copy.deepcopy(types), [rs(d).to_wire() for d in demands],
        [rs(p).to_wire() for p in pools], dict(counts), max_workers, total)


def _backend(monkeypatch, name):
    flag = "1" if name == "native" else "0"
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_SCHED", flag)
    monkeypatch.setenv("RAY_TPU_NATIVE_SCHED", flag)


# ------------------------------------------------------------ bin packing
NODE_TYPES = {
    "cpu4": {"resources": {"CPU": 4}, "max_workers": 10},
    "tpu_slice": {"resources": {"TPU": 4, "CPU": 8}, "max_workers": 4},
}
GPU_TYPES = {
    "cpu2": {"resources": {"CPU": 2}, "max_workers": 4},
    "gpu": {"resources": {"CPU": 2, "GPU": 1}, "max_workers": 1},
}
# tests/test_autoscaler.py TestBinPacking, then the port's GPU node type:
# (node types, demands, pools, counts, max_workers, total, expected)
PACK_CASES = {
    "no_demand": (NODE_TYPES, [], [], {}, 8, 0, {}),
    "fits_existing": (NODE_TYPES, [{"CPU": 2}], [{"CPU": 4}], {}, 8, 1, {}),
    "unfulfilled": (NODE_TYPES, [{"CPU": 2}], [], {}, 8, 0, {"cpu4": 1}),
    "pack_two_onto_one": (NODE_TYPES, [{"CPU": 2}] * 2, [], {}, 8, 0,
                          {"cpu4": 1}),
    "tpu_demand": (NODE_TYPES, [{"TPU": 4}], [{"CPU": 4}], {}, 8, 1,
                   {"tpu_slice": 1}),
    "max_workers_cap": (NODE_TYPES, [{"CPU": 4}] * 5, [], {}, 2, 0, None),
    "infeasible": (NODE_TYPES, [{"GPU": 1}], [], {}, 8, 0, {}),
    "per_type_max": ({"cpu4": {"resources": {"CPU": 4}, "max_workers": 1}},
                     [{"CPU": 4}] * 3, [], {}, 8, 0, {"cpu4": 1}),
    "gpu_demand": (GPU_TYPES, [{"GPU": 1}, {"CPU": 1}], [{"CPU": 2}], {},
                   4, 1, {"gpu": 1}),
    "gpu_type_at_its_max": (GPU_TYPES, [{"GPU": 1}] * 2, [], {"gpu": 1}, 4,
                            1, {}),
}


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_bin_packing_matches_jax(case, backend, monkeypatch):
    types, demands, pools, counts, max_workers, total, want = \
        PACK_CASES[case]
    _backend(monkeypatch, backend)
    got = _pack("port", types, demands, pools, counts, max_workers, total)
    ref = _pack("jax", types, demands, pools, counts, max_workers, total)
    assert got == ref
    if want is None:
        assert sum(got.values()) <= max_workers
    else:
        assert got == want


def test_native_knob_is_the_ports(monkeypatch):
    """``RAY_TPU_TORCH_NATIVE_SCHED`` picks the port's backend; the JAX
    package's ``RAY_TPU_NATIVE_SCHED`` does not."""
    import ray_tpu_torch._native as native

    calls = []

    class Spy(native.NativeScheduler):
        def bin_pack(self, *a, **k):
            calls.append(1)
            return super().bin_pack(*a, **k)

    monkeypatch.setattr(native, "NativeScheduler", Spy)
    monkeypatch.delenv("RAY_TPU_TORCH_NATIVE_SCHED", raising=False)
    monkeypatch.setenv("RAY_TPU_NATIVE_SCHED", "0")
    args = (NODE_TYPES, [{"CPU": 2}], [], {}, 8, 0)
    assert _pack("port", *args) == {"cpu4": 1}
    assert calls == [1]
    monkeypatch.setenv("RAY_TPU_TORCH_NATIVE_SCHED", "0")
    assert _pack("port", *args) == {"cpu4": 1}
    assert calls == [1]


def test_fuzz_backends_match_each_other_and_jax(monkeypatch):
    """Random demand sets (tests/test_autoscaler.py's fuzz, with a GPU
    type): each backend of the port launches what the same backend of the
    JAX package launches, and the two backends the same node counts."""
    rng = random.Random(7)
    types = {
        "small": {"resources": {"CPU": 2}, "max_workers": 5},
        "big": {"resources": {"CPU": 8, "TPU": 4}, "max_workers": 3},
        "gpu": {"resources": {"CPU": 4, "GPU": 1}, "max_workers": 2},
    }
    for trial in range(25):
        demands = [
            {"CPU": rng.choice([1, 2, 4]),
             **({"TPU": rng.choice([1, 2])} if rng.random() < 0.3 else {}),
             **({"GPU": 1} if rng.random() < 0.2 else {})}
            for _ in range(rng.randint(0, 6))]
        pools = [{"CPU": rng.choice([0, 2, 4])}
                 for _ in range(rng.randint(0, 2))]
        args = (types, demands, pools, {}, 6, 0)
        out = {}
        for backend in ("native", "python"):
            _backend(monkeypatch, backend)
            out[backend] = _pack("port", *args)
            assert out[backend] == _pack("jax", *args), (trial, backend)
        assert sum(out["native"].values()) == sum(out["python"].values()), \
            (trial, demands, pools, out)


def test_review_repro_backends_agree(monkeypatch):
    """tests/test_autoscaler.py's regression: mixed demand sizes and a
    partial pool once made the two backends disagree."""
    types = {
        "small": {"resources": {"CPU": 2}, "max_workers": 5},
        "big": {"resources": {"CPU": 8, "TPU": 4}, "max_workers": 3},
    }
    args = (types, [{"CPU": 2}, {"CPU": 2}, {"CPU": 4}], [{"CPU": 4}], {},
            6, 0)
    got = []
    for backend in ("native", "python"):
        _backend(monkeypatch, backend)
        got += [_pack("port", *args), _pack("jax", *args)]
    assert all(g == got[0] for g in got), got


# ------------------------------------------------- StandardAutoscaler
class FakeProvider:
    """Provider nodes register as runtime node ``n-<pid>`` once told to."""

    def __init__(self):
        self.nodes = {}
        self.registered = set()
        self.count = 0
        self.log = []

    def non_terminated_nodes(self):
        return list(self.nodes)

    def node_tags(self, pid):
        t = self.nodes.get(pid)
        return {"node_type": t} if t else {}

    def create_node(self, node_type, count):
        out = []
        for _ in range(count):
            self.count += 1
            pid = f"{node_type}-{self.count}"
            self.nodes[pid] = node_type
            out.append(pid)
        self.log.append(("create", node_type, count))
        return out

    def terminate_node(self, pid):
        self.nodes.pop(pid, None)
        self.log.append(("terminate", pid))

    def runtime_node_ids(self, pid):
        return [f"n-{pid}"] if pid in self.registered else []

    def expected_runtime_nodes(self, pid):
        return 1


class FakeGcs:
    def __init__(self, rs):
        self.rs = rs
        self.view = {}
        self.pins = None
        self.drained = []

    def node(self, nid, total, available=None, pending=()):
        self.view[nid] = {
            "resources": {"total": self.rs(total).to_wire(),
                          "available": self.rs(
                              total if available is None else available)
                          .to_wire()},
            "pending": [self.rs(p).to_wire() for p in pending]}

    def __call__(self, method, payload):
        if method == "GetClusterView":
            return copy.deepcopy(self.view)
        if method == "KvGet":
            return self.pins
        if method == "DrainNode":
            self.drained.append(payload["node_id"])
            return True
        raise AssertionError(method)


AUTOSCALER_TYPES = {
    "cpu": {"resources": {"CPU": 2}, "max_workers": 2},
    "gpu": {"resources": {"CPU": 2, "GPU": 1}, "max_workers": 1},
    "pinned": {"resources": {"CPU": 1, "pinned": 1}, "min_workers": 1,
               "max_workers": 1},
}


def _drive_autoscaler(pkg, monkeypatch):
    """Ten reconcile ticks over a scripted cluster view; returns what each
    tick decided and what it asked of the provider and the GCS."""
    mod = {"port": port_autoscaler, "jax": jax_autoscaler}[pkg]
    rs = PACKAGES[pkg][1]
    monkeypatch.setenv("RAY_TPU_TORCH_AUTOSCALER_BOOT_TIMEOUT_S", "0.2")
    monkeypatch.setenv("RAY_TPU_AUTOSCALER_BOOT_TIMEOUT_S", "0.2")
    provider, gcs = FakeProvider(), FakeGcs(rs)
    scaler = mod.StandardAutoscaler(
        {"idle_timeout_minutes": 0.0, "max_workers": 4,
         "available_node_types": copy.deepcopy(AUTOSCALER_TYPES)},
        provider, gcs)
    ticks = []

    def tick():
        out = scaler.update()
        ticks.append({"launched": out["launched"],
                      "terminated": out["terminated"],
                      "num_nodes": out["num_nodes"],
                      "launches": scaler.num_launches,
                      "terminations": scaler.num_terminations,
                      "drained": list(gcs.drained),
                      "provider": list(provider.log)})

    # 1: a GPU and a CPU request queue on the full head; min_workers
    gcs.node("head", {"CPU": 2}, {"CPU": 0}, pending=[{"GPU": 1},
                                                      {"CPU": 1}])
    tick()
    # 2: the launched nodes boot: their spec capacity absorbs the demand
    tick()
    # 3: they register, the GPU node busy, the pinned node idle
    provider.registered.update(provider.nodes)
    gcs.node("head", {"CPU": 2})
    gcs.node("n-gpu-2", {"CPU": 2, "GPU": 1}, {"CPU": 1, "GPU": 0})
    gcs.node("n-pinned-1", {"CPU": 1, "pinned": 1})
    tick()
    # 4-5: the GPU node goes idle, then past the (zero) idle timeout;
    # the pinned node is kept at its min_workers
    gcs.node("n-gpu-2", {"CPU": 2, "GPU": 1})
    tick()
    time.sleep(0.01)
    tick()
    gcs.view.pop("n-gpu-2")
    # 6: a request_resources pin for a GPU launches a GPU node again
    gcs.pins = json.dumps([rs({"GPU": 1}).to_wire()])
    tick()
    # 7: it registers idle; the pin keeps it
    provider.registered.update(provider.nodes)
    gcs.node("n-gpu-3", {"CPU": 2, "GPU": 1})
    tick()
    time.sleep(0.01)
    tick()
    # 9: the pin is cleared: the idle node goes
    gcs.pins = json.dumps([])
    tick()
    gcs.view.pop("n-gpu-3", None)
    # 10-12: a CPU demand launches a node that never registers: its boot
    # window opens on the next tick, and once it has passed the node is
    # reclaimed as a failed launch (and the demand launches another)
    gcs.node("head", {"CPU": 2}, {"CPU": 0}, pending=[{"CPU": 2}])
    tick()
    tick()
    time.sleep(0.3)
    tick()
    return ticks


def test_standard_autoscaler_decisions_match_jax(monkeypatch):
    port = _drive_autoscaler("port", monkeypatch)
    ref = _drive_autoscaler("jax", monkeypatch)
    assert port == ref
    assert port[0]["launched"] == {"pinned": 1, "gpu": 1}
    assert port[1]["launched"] == {}
    assert port[4]["terminated"] == ["gpu-2"]
    assert port[4]["drained"] == ["n-gpu-2"]
    assert port[5]["launched"] == {"gpu": 1}
    assert port[7]["terminated"] == []
    assert port[8]["terminated"] == ["gpu-3"]
    assert port[9]["launched"] == {"cpu": 1}
    assert port[10]["launched"] == {}
    assert port[11]["provider"][-2:] == [("terminate", "cpu-4"),
                                         ("create", "cpu", 1)]
    assert port[11]["terminations"] == 3
    assert "pinned-1" not in sum(
        (t["terminated"] for t in port), [])


# ----------------------------------------------------------------- GKE
def test_tpu_tables_match_jax():
    assert port_gke.TPU_TOPOLOGIES == jax_gke.TPU_TOPOLOGIES
    assert port_gke_rest.GKE_TPU_SHAPES == jax_gke_rest.GKE_TPU_SHAPES
    assert port_gke.slice_shape("v5e-16") == (4, 4)
    for mod in (port_gke, jax_gke):
        with pytest.raises(ValueError, match="unknown TPU topology"):
            mod.slice_shape("v9z-1")


class Transport:
    def __init__(self, replies):
        self.calls = []
        self.replies = list(replies)

    def __call__(self, method, url, body):
        self.calls.append((method, url, copy.deepcopy(body)))
        if self.replies:
            reply = self.replies.pop(0)
            if isinstance(reply, Exception):
                raise reply
            return reply
        return {}


def _rest(mod, replies=(), **kw):
    t = Transport(replies)
    return mod.GkeRestClient("proj-1", "us-central2-b", "ray-cluster",
                             request_fn=t, poll_interval=0.0, **kw), t


@pytest.mark.parametrize("topology", sorted(port_gke_rest.GKE_TPU_SHAPES))
def test_create_request_bodies_match_jax(topology):
    hosts, _ = port_gke.slice_shape(topology)
    labels = {"tpu-slice": "ray-1", "ray": "Head:Node"}
    bodies = [_rest(mod)[0].build_create_request("ray-1", topology, hosts,
                                                 labels)
              for mod in (port_gke_rest, jax_gke_rest)]
    assert bodies[0] == bodies[1]
    json.dumps(bodies[0])


def test_create_request_errors_and_overrides_match_jax():
    over = {"config": {"diskSizeGb": 200}, "locations": ["us-central2-b"]}
    got = [_rest(mod, node_pool_overrides=over)[0].build_create_request(
        "p", "v5e-4", 1, {}) for mod in (port_gke_rest, jax_gke_rest)]
    assert got[0] == got[1]
    assert got[0]["nodePool"]["config"]["diskSizeGb"] == 200
    for args, match in ((("p", "v5e-16", 2, {}), "4-host slice"),
                        (("p", "v9e-999", 1, {}), "no GKE machine shape")):
        msgs = []
        for mod in (port_gke_rest, jax_gke_rest):
            with pytest.raises(ValueError, match=match) as e:
                _rest(mod)[0].build_create_request(*args)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _ig():
    return ("https://www.googleapis.com/compute/v1/projects/p/zones/z/"
            "instanceGroupManagers/gke-ray-pool-grp")


# tests/test_gke_rest.py TestLifecycle: (replies, call) a scenario
REST_SCENARIOS = {
    "create_polls": (lambda E: [{"name": "op-123", "status": "RUNNING"},
                                {"name": "op-123", "status": "DONE"}],
                     lambda c: c.create_tpu_node_pool(
                         "pool-a", "v5e-16", 4, {}, {}, {})),
    "operation_error": (lambda E: [{"name": "op-9", "status": "DONE",
                                    "error": {"code": 8,
                                              "message": "quota"}}],
                        lambda c: c.create_tpu_node_pool(
                            "pool-a", "v5e-16", 4, {}, {}, {})),
    "delete_404": (lambda E: [E(404, "not found")],
                   lambda c: c.delete_node_pool("gone-pool")),
    "delete_403": (lambda E: [E(403, "forbidden")],
                   lambda c: c.delete_node_pool("p")),
    "ids_until_running": (lambda E: [{"status": "PROVISIONING",
                                      "instanceGroupUrls": ["ig-1"]}],
                          lambda c: c.pool_runtime_node_ids("pool-a")),
    "ids_by_instance": (lambda E: [
        {"status": "RUNNING", "instanceGroupUrls": [_ig()]},
        {"managedInstances": [
            {"instance": ".../instances/gke-ray-pool-abcd",
             "instanceStatus": "RUNNING"},
            {"instance": ".../instances/gke-ray-pool-dead",
             "instanceStatus": "STOPPING"}]}],
        lambda c: c.pool_runtime_node_ids("pool-a")),
    "ids_group_materializing": (lambda E: [
        {"status": "RUNNING", "instanceGroupUrls": ["ig-1"]},
        E(503, "not ready")], lambda c: c.pool_runtime_node_ids("pool-a")),
    "ids_404": (lambda E: [E(404, "no pool")],
                lambda c: c.pool_runtime_node_ids("pool-a")),
}


@pytest.mark.parametrize("scenario", sorted(REST_SCENARIOS))
def test_rest_client_calls_match_jax(scenario):
    replies, call = REST_SCENARIOS[scenario]
    seen = []
    for mod in (port_gke_rest, jax_gke_rest):
        client, t = _rest(mod, replies(mod.GkeApiError))
        try:
            out = ("ok", call(client))
        except mod.GkeApiError as e:
            out = ("error", str(e), e.retryable)
        seen.append((out, t.calls))
    assert seen[0] == seen[1]


def test_provider_over_rest_matches_jax():
    """tests/test_gke_rest.py's provider integration: create -> ids ->
    slice-atomic delete, the same calls from both packages."""
    seen = []
    for gke, rest in ((port_gke, port_gke_rest), (jax_gke, jax_gke_rest)):
        client, t = _rest(rest, [
            {"name": "op-1", "status": "DONE"},
            {"status": "RUNNING", "instanceGroupUrls": ["ig-url"]},
            {"managedInstances": [
                {"instance": f".../instances/host-{i}",
                 "instanceStatus": "RUNNING"} for i in range(4)]},
            {"name": "op-2", "status": "DONE"}])
        provider = gke.GkeTpuPodSliceProvider({
            "node_types": {"v5e16": {"tpu_topology": "v5e-16",
                                     "cpus_per_host": 4}},
            "gke_client": client}, cluster_name="ray")
        [sid] = provider.create_node("v5e16", 1)
        row = (sid, provider.expected_runtime_nodes(sid),
               provider.runtime_node_ids(sid),
               provider.node_type_resources("v5e16"))
        provider.terminate_node(sid)
        seen.append((row, t.calls))
    assert seen[0] == seen[1]
    assert [m for m, _, _ in seen[0][1]] == ["POST", "GET", "POST",
                                            "DELETE"]


class FailingClient:
    def __init__(self, err):
        self.err = err
        self.create_calls = 0
        self.deleted = []

    def create_tpu_node_pool(self, pool_name, **kw):
        self.create_calls += 1
        raise self.err

    def delete_node_pool(self, pool_name):
        self.deleted.append(pool_name)

    def pool_runtime_node_ids(self, pool_name):
        return []


@pytest.mark.parametrize("status,message", [
    (429, "rateLimitExceeded: quota"),
    (200, '{"code": 8, "message": "ZONE_RESOURCE_POOL_EXHAUSTED"}'),
    (403, "PERMISSION_DENIED: container.nodePools")])
def test_provider_error_paths_match_jax(status, message):
    """tests/test_gke_rest.py TestErrorPaths: no ghost slice, cleanup, and
    the same backoff class in both packages."""
    seen = []
    for gke, rest in ((port_gke, port_gke_rest), (jax_gke, jax_gke_rest)):
        client = FailingClient(rest.GkeApiError(status, message))
        p = gke.GkeTpuPodSliceProvider(
            {"node_types": {"v5e-8": {"tpu_topology": "v5e-8",
                                      "resources": {"TPU": 8.0}}},
             "gke_client": client}, "t")
        first = p.create_node("v5e-8", 2)
        again = p.create_node("v5e-8", 1)
        backoff = p.create_failure_backoff("v5e-8")
        seen.append((first, again, p.num_slices(), client.create_calls,
                     client.deleted, backoff > 60,
                     client.err.retryable))
    assert seen[0] == seen[1]
    assert seen[0][:4] == ([], [], 0, 1)


class FakeNode:
    made = []

    def __init__(self, **kw):
        self.kw = kw
        self.node_id = f"node-{len(FakeNode.made)}"
        FakeNode.made.append(self)

    def start(self):
        pass

    def stop(self):
        pass


def test_launched_nodes_write_gpu(monkeypatch):
    """Every node of the local providers runs on this host: it advertises
    the GPUs its type gives, and 0 otherwise (never the host's cards)."""
    from ray_tpu_torch._private import node as node_mod
    from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider

    monkeypatch.setattr(node_mod, "Node", FakeNode)
    FakeNode.made = []
    provider = LocalNodeProvider(
        {"head_host": "127.0.0.1", "head_port": 1, "session_dir": "/s",
         "node_types": {"cpu": {"resources": {"CPU": 2}},
                        "gpu": {"resources": {"CPU": 2, "GPU": 1}}}}, "c")
    provider.create_node("cpu", 1)
    provider.create_node("gpu", 1)
    mock = port_gke.LocalMockGkeClient("127.0.0.1", 1, "/s")
    mock.create_tpu_node_pool("pool", "v5e-8", 2, {"CPU": 1, "TPU": 4},
                              {}, {"TPU-v5e-8-head": 1.0})
    assert [n.kw["resources"].get("GPU") for n in FakeNode.made] == \
        [0.0, 1.0, 0.0, 0.0]
    assert FakeNode.made[1].kw["resources"] == {"CPU": 2, "GPU": 1}
    assert provider.runtime_node_id("c-gpu-2") == "node-1"
    assert mock.pool_runtime_node_ids("pool") == ["node-2", "node-3"]


# ------------------------------------------------------------ launcher
LAUNCH_CONFIG = {
    "cluster_name": "t",
    "provider": {"type": "ssh", "ssh_user": "u", "ssh_private_key": "/k"},
    "head_node": {"host": "10.0.0.1", "port": 7399,
                  "resources": {"CPU": 4}},
    "worker_nodes": [
        {"host": "10.0.0.2", "resources": {"CPU": 4, "GPU": 1}},
        {"host": "10.0.0.3"},
    ],
    "setup_commands": ["echo ready"],
}


def _recording(mod):
    log = []

    class Runner(mod.CommandRunner):
        def run(self, cmd, timeout=300.0):
            log.append((self.host, cmd))
            if "cli start --head" in cmd.replace("'", ""):
                return 0, "node started\nhead address: 127.0.0.1:7399\n"
            return 0, "ok"

    return Runner, log


@pytest.mark.parametrize("verb", ["up", "down"])
def test_launcher_commands_match_jax_but_for_the_module(verb):
    logs, outs = [], []
    for mod in (port_launcher, jax_launcher):
        runner, log = _recording(mod)
        launcher = mod.ClusterLauncher(copy.deepcopy(LAUNCH_CONFIG),
                                       runner_factory=runner,
                                       python="python")
        outs.append(getattr(launcher, verb)())
        logs.append(log)
    assert outs[0] == outs[1]
    port = [(h, c.replace("-m ray_tpu_torch.scripts.cli",
                          "-m ray_tpu.scripts.cli")) for h, c in logs[0]]
    assert port == logs[1]
    assert all("-m ray_tpu_torch.scripts.cli" in c
               for _, c in logs[0] if "python" in c)
    if verb == "up":
        assert outs[0] == "10.0.0.1:7399"
        assert [h for h, _ in logs[0]] == ["10.0.0.1"] * 2 + \
            ["10.0.0.2"] * 2 + ["10.0.0.3"] * 2
        assert '"GPU": 1' in logs[0][3][1]
    else:
        assert [h for h, _ in logs[0]] == ["10.0.0.2", "10.0.0.3",
                                           "10.0.0.1"]


@pytest.mark.parametrize("config,match", [
    ({"worker_nodes": []}, "head_node"),
    ({"head_node": {"host": "h"}, "provider": {"type": "k8s"}},
     "provider.type"),
    ({"head_node": {"host": "h"}, "worker_nodes": [{"port": 1}]},
     "missing host")])
def test_launcher_validation_matches_jax(config, match):
    msgs = []
    for mod in (port_launcher, jax_launcher):
        with pytest.raises(ValueError, match=match) as e:
            mod.validate_cluster_config(config)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_launcher_ssh_and_config_files_match_jax(tmp_path):
    bases = [mod.SSHCommandRunner("10.0.0.9", user="u", private_key="/k",
                                  ssh_options=["-p", "2222"])._base()
             for mod in (port_launcher, jax_launcher)]
    assert bases[0] == bases[1]
    assert bases[0][-1] == "u@10.0.0.9"
    y = tmp_path / "c.yaml"
    y.write_text("head_node:\n  host: h1\n")
    j = tmp_path / "c.json"
    j.write_text(json.dumps(LAUNCH_CONFIG))
    for path in (str(y), str(j)):
        assert port_launcher.load_cluster_config(path) == \
            jax_launcher.load_cluster_config(path)


# ---------------------------------------------------------- v2 manager
class V2Provider:
    def __init__(self):
        self.nodes = {}
        self.count = 0
        self.joined = {}

    def create_node(self, node_type, count):
        out = []
        for _ in range(count):
            self.count += 1
            cid = f"cloud-{self.count}"
            self.nodes[cid] = node_type
            out.append(cid)
        return out

    def non_terminated_nodes(self):
        return list(self.nodes)

    def terminate_node(self, cid):
        self.nodes.pop(cid, None)

    def runtime_node_id(self, cid):
        return self.joined.get(cid)


def _drive_v2(im):
    """tests/test_autoscaler_v2.py's lifecycle: each step's transitions
    and the instances' (cloud id, status, version), in request order."""
    provider, mgr, cluster = V2Provider(), im.InstanceManager(), []
    rec = im.Reconciler(mgr, provider, lambda: cluster)
    order = [i.instance_id for i in mgr.request_instances("worker", 2)]
    steps = []

    def snap(t):
        steps.append((t, [(mgr.storage.get(i).cloud_instance_id,
                           mgr.storage.get(i).status,
                           mgr.storage.get(i).version) for i in order]))

    snap(rec.reconcile())
    snap(rec.reconcile())
    for inst in mgr.instances(im.ALLOCATED):
        provider.joined[inst.cloud_instance_id] = \
            "node-" + inst.cloud_instance_id
        cluster.append("node-" + inst.cloud_instance_id)
    snap(rec.reconcile())
    mgr.terminate_instance(order[0])
    snap(rec.reconcile())
    provider.nodes.pop(mgr.storage.get(order[1]).cloud_instance_id)
    snap(rec.reconcile())
    return steps


def test_v2_lifecycle_matches_jax():
    port, ref = _drive_v2(port_im), _drive_v2(jax_im)
    assert port == ref
    assert port[0][0] == {"launched": 2, "allocated": 2}
    assert [s for _, s, _ in port[2][1]] == [port_im.RAY_RUNNING] * 2
    assert port[3][1][0][1] == port_im.TERMINATED
    assert port[4][0] == {"lost": 1}


def test_v2_storage_versioning_matches_jax():
    seen = []
    for im in (port_im, jax_im):
        mgr = im.InstanceManager()
        (inst,) = mgr.request_instances("worker", 1)
        v0 = inst.version
        inst.transition(im.REQUESTED)
        clone = im.Instance(instance_id=inst.instance_id,
                            instance_type="worker")
        seen.append((v0, inst.version,
                     mgr.storage.upsert(clone, expected_version=v0),
                     mgr.storage.upsert(clone, expected_version=inst.version),
                     [i.status for i in mgr.instances()]))
    assert seen[0] == seen[1]
    assert seen[0] == (0, 1, False, True, ["QUEUED"])


# ------------------------------------------- one AutoscalingCluster
IDLE_S = 3.0  # idle_timeout_minutes=0.05


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = pred()
        if out:
            return out
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


def _provider_nodes(cluster, node_type):
    p = cluster.provider
    return [pid for pid in p.non_terminated_nodes()
            if p.node_tags(pid).get("node_type") == node_type]


def _alive(node_id):
    return any(n["node_id"] == node_id and n["alive"]
               for n in ray_tpu_torch.nodes())


@pytest.fixture(scope="module")
def autoscaling():
    from ray_tpu_torch.cluster_utils import AutoscalingCluster

    cluster = AutoscalingCluster(
        head_resources={"CPU": 2},
        worker_node_types={
            "gpu": {"resources": {"CPU": 2, "GPU": 1}, "max_workers": 1},
            "pinned": {"resources": {"CPU": 1, "pinned": 1},
                       "min_workers": 1, "max_workers": 1},
            "extra": {"resources": {"CPU": 1, "extra": 2},
                      "max_workers": 1},
        },
        idle_timeout_minutes=IDLE_S / 60, update_interval_s=0.3)
    cluster.start()
    session_dir = cluster.cluster.session_dir
    try:
        ray_tpu_torch.init(address=cluster.address, num_cpus=1, num_gpus=0)
        yield cluster
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    port_session_leak_check(session_dir)


def _totals(status):
    return {k: v for k, v in status.total_resources.items()
            if k in ("CPU", "GPU", "pinned", "extra")}


def test_min_workers_node_and_cluster_status(autoscaling):
    """The ``min_workers`` node comes up unasked; ``get_cluster_status``
    then reads the totals this session set: the head's 2 CPUs, the
    driver's 1, the pinned node's 1, and no GPU (the head and the
    launched CPU node write ``GPU`` 0)."""
    from ray_tpu_torch.autoscaler.v2 import get_cluster_status

    [pid] = _wait(lambda: _provider_nodes(autoscaling, "pinned"), 60,
                  "the min_workers node")
    rid = _wait(lambda: autoscaling.provider.runtime_node_id(pid), 60,
                "its node id")
    _wait(lambda: _alive(rid), 60, "its registration")
    st = get_cluster_status()
    assert _totals(st) == {"CPU": 4.0, "pinned": 1.0}
    assert st.total_resources.get("GPU", 0.0) == 0.0
    assert len(st.active_nodes()) == 3
    assert st.available_resources.get("GPU", 0.0) == 0.0


def test_gpu_task_scales_a_gpu_node_up_and_down(autoscaling):
    from ray_tpu_torch.autoscaler.v2 import get_cluster_status

    scaler = autoscaling.monitor.autoscaler
    launches, terms = scaler.num_launches, scaler.num_terminations
    assert not _provider_nodes(autoscaling, "gpu")

    @ray_tpu_torch.remote(num_gpus=1)
    def on_gpu(hold_s):
        import os
        import time

        time.sleep(hold_s)
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                ray_tpu_torch.get_runtime_context().get_node_id())

    ref = on_gpu.remote(4.0)
    [pid] = _wait(lambda: _provider_nodes(autoscaling, "gpu"), 60,
                  "the GPU node's launch")
    rid = _wait(lambda: autoscaling.provider.runtime_node_id(pid), 60,
                "its node id")
    st = _wait(lambda: (lambda s: s if s.total_resources.get("GPU") == 1.0
                        else None)(get_cluster_status()), 60,
               "its GPU in the cluster status")
    [node] = [n for n in st.nodes if n.node_id == rid]
    assert node.alive
    assert ResourceSet.from_wire(node.resources_total).to_dict()["GPU"] \
        == 1.0
    visible, where = ray_tpu_torch.get(ref, timeout=120)
    assert (visible, where) == ("0", rid)
    assert scaler.num_launches == launches + 1

    # the provider forgets the node before its stop returns; the
    # autoscaler counts the termination after
    _wait(lambda: scaler.num_terminations == terms + 1, IDLE_S + 30,
          "the idle GPU node's termination")
    assert not _provider_nodes(autoscaling, "gpu")
    _wait(lambda: not _alive(rid), 30, "the head to mark it dead")
    assert get_cluster_status().total_resources.get("GPU", 0.0) == 0.0


def test_request_resources_pins_a_node(autoscaling):
    from ray_tpu_torch.autoscaler import request_resources

    request_resources(bundles=[{"extra": 2}])
    [pid] = _wait(lambda: _provider_nodes(autoscaling, "extra"), 60,
                  "the pinned request's launch")
    rid = _wait(lambda: autoscaling.provider.runtime_node_id(pid), 60,
                "its node id")
    _wait(lambda: _alive(rid), 60, "its registration")
    time.sleep(IDLE_S + 1.5)
    assert _provider_nodes(autoscaling, "extra") == [pid], \
        "a node the pin needs was scaled down"
    terms = autoscaling.monitor.autoscaler.num_terminations
    request_resources(bundles=[])
    _wait(lambda: autoscaling.monitor.autoscaler.num_terminations
          == terms + 1, IDLE_S + 30, "the unpinned node's termination")
    assert not _provider_nodes(autoscaling, "extra")
    _wait(lambda: not _alive(rid), 30, "the head to mark it dead")


def test_min_workers_node_outlives_its_idleness(autoscaling):
    """By now the pinned node has been idle far past the timeout."""
    [pid] = _provider_nodes(autoscaling, "pinned")
    assert _alive(autoscaling.provider.runtime_node_id(pid))
