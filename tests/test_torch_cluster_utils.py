"""The port's multi-node ``Cluster`` (``ray_tpu_torch.cluster_utils``)
against the JAX package's (``ray_tpu.cluster_utils``), on the CPU.

One scenario runs on a three-node cluster of each package: a head with one
CPU and no GPU, node 1 with two CPUs and a custom resource, node 2 with one
CPU and one GPU (a GPU id with no card behind it). A task that needs the
custom resource lands on node 1, an object made on node 1 reaches the
driver and one put by the driver reaches node 2, a GPU task lands on node 2,
and an actor that needs node 1's two CPUs restarts on node 3, added after
node 1 is removed. The placements, by node index, must be the same in both packages.
In the port the GPU task also sees ``CUDA_VISIBLE_DEVICES=0`` and the head
advertises no GPU, though the host may have one.

The port alone: two ``{"GPU": 0.5}`` actors in one ``{"GPU": 1}``
placement-group bundle see the bundle's device, and the share comes back
when they exit (a whole-GPU actor in the bundle sees it next).

Remote functions are defined inside the scenario, so that they travel by
value and no worker imports this module (and with it jax)."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
from ray_tpu.cluster_utils import Cluster as JaxCluster  # noqa: E402
from ray_tpu_torch.cluster_utils import Cluster  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)


def _scenario(rt, cluster, gpu_kw):
    """The placements of the scenario on ``cluster`` (``rt`` is its
    package), by node index: 0 the head, 1 and 2 the added nodes."""
    from importlib import import_module

    strategies = import_module(rt.__name__ + ".util.scheduling_strategies")
    n1 = cluster.add_node(num_cpus=2, resources={"custom": 1})
    n2 = cluster.add_node(num_cpus=1, **gpu_kw)
    rt.init(_node=cluster.head_node)
    cluster.wait_for_nodes()
    index = {cluster.head_node.node_id: 0, n1.node_id: 1, n2.node_id: 2}
    out = {}

    @rt.remote(resources={"custom": 1})
    def custom():
        return rt.get_runtime_context().get_node_id()

    out["custom"] = index[rt.get(custom.remote(), timeout=60)]

    @rt.remote(scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
        n1.node_id, soft=False))
    def make(n):
        import numpy as np

        return rt.get_runtime_context().get_node_id(), np.arange(
            n, dtype=np.int64)

    where, arr = rt.get(make.remote(1 << 18), timeout=60)
    out["made"] = index[where]
    out["made_sum"] = int(arr.sum())

    @rt.remote(num_gpus=1)
    def on_gpu(x):
        import os

        return (rt.get_runtime_context().get_node_id(), int(x.sum()),
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    put = rt.put(np.ones(1 << 18, dtype=np.int64))
    where, total, visible = rt.get(on_gpu.remote(put), timeout=60)
    out["gpu"], out["moved_sum"], out["visible"] = index[where], total, visible
    state = import_module(rt.__name__ + ".util.state")
    out["gpus"] = {index[n["node_id"]]: n["resources_total"].get("GPU", 0)
                   for n in state.list_nodes() if n["alive"]}

    @rt.remote(num_cpus=2, max_restarts=2, max_task_retries=-1)
    class Where:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    # only node 1 has two CPUs; once it is gone, node 3 is the one that has
    actor = Where.remote()
    out["actor"] = index[rt.get(actor.node.remote(), timeout=60)]
    cluster.remove_node(n1)
    n3 = cluster.add_node(num_cpus=2)
    index[n3.node_id] = 3
    out["restarted"] = index[rt.get(actor.node.remote(), timeout=90)]
    return out


def _run(rt, cluster_cls, gpu_kw):
    cluster = cluster_cls(initialize_head=True,
                          head_node_args={"num_cpus": 1})
    try:
        return _scenario(rt, cluster, gpu_kw)
    finally:
        rt.shutdown()
        cluster.shutdown()


@pytest.fixture(scope="module")
def placements():
    want = _run(ray_tpu, JaxCluster, {"resources": {"GPU": 1}})
    got = _run(ray_tpu_torch, Cluster, {"num_gpus": 1})
    return got, want


def test_placements_match_the_jax_package(placements):
    got, want = placements
    keys = ("custom", "made", "made_sum", "gpu", "moved_sum", "actor",
            "restarted")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert (got["custom"], got["made"], got["gpu"], got["actor"]) == (
        1, 1, 2, 1)
    assert got["made_sum"] == (1 << 18) * ((1 << 18) - 1) // 2
    assert got["moved_sum"] == 1 << 18


def test_actor_on_a_removed_node_restarts_elsewhere(placements):
    got, want = placements
    assert got["restarted"] == want["restarted"] == 3


def test_gpu_node_and_a_head_without_gpus(placements):
    got, _ = placements
    assert got["visible"] == "0"
    assert got["gpus"][0] == 0 and got["gpus"][2] == 1


def test_add_node_writes_gpu_over_detection():
    """``"GPU"`` is written for every node, 0 included, over what the node
    detects (every local node would detect the host's cards)."""
    import ray_tpu_torch.cluster_utils as cu

    made = []

    class FakeNode:
        def __init__(self, head=True, resources=None, **kw):
            self.is_head, self.node_id = head, f"n{len(made)}"
            self.head_port, self.session_dir = 1, "/nonexistent"
            merged = {"CPU": 8.0, "GPU": 1.0}  # what a node would detect
            merged.update(resources or {})
            self.resources = merged
            made.append(self)

        def start(self):
            pass

    saved, cu.Node = cu.Node, FakeNode
    try:
        c = Cluster(initialize_head=False)
        c.add_node(num_cpus=1)
        c.add_node(num_cpus=1, num_gpus=1)
        c.add_node(resources={"GPU": 2})
    finally:
        cu.Node = saved
    assert [n.resources["GPU"] for n in made] == [0.0, 1.0, 2.0]


def test_autoscaling_cluster_wires_the_reference_parts(monkeypatch):
    """``AutoscalingCluster.start`` builds what the reference's does: a
    head with its resources (``GPU`` written 0), a ``LocalNodeProvider``
    on the head's port and session, and a ``Monitor`` over the node types;
    ``shutdown`` stops the monitor, then the provider, then the head. The
    session itself is driven in ``test_torch_autoscaler.py``."""
    from ray_tpu_torch import cluster_utils as cu
    from ray_tpu_torch.autoscaler import monitor as monitor_mod
    from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider

    calls = []

    class FakeNode:
        def __init__(self, head=False, resources=None, **kw):
            self.resources = dict(resources)
            self.head_port = 4321
            self.session_dir = "/s"

        def start(self):
            calls.append(("head", self.resources))

        def stop(self, cleanup_session=False):
            calls.append(("head stop", cleanup_session))

    class FakeMonitor:
        def __init__(self, config, provider, host, port,
                     update_interval_s=1.0):
            calls.append(("monitor", config, type(provider).__name__,
                          provider.provider_config, host, port,
                          update_interval_s))

        def start(self):
            calls.append("monitor start")

        def stop(self):
            calls.append("monitor stop")

    monkeypatch.setattr(cu, "Node", FakeNode)
    monkeypatch.setattr(monitor_mod, "Monitor", FakeMonitor)
    monkeypatch.setattr(LocalNodeProvider, "shutdown",
                        lambda self: calls.append("provider shutdown"))
    types = {"gpu": {"resources": {"CPU": 2, "GPU": 1}, "max_workers": 1}}
    c = cu.AutoscalingCluster(head_resources={"CPU": 2},
                              worker_node_types=types,
                              idle_timeout_minutes=0.05,
                              update_interval_s=0.5)
    c.start()
    assert c.address == "127.0.0.1:4321"
    c.shutdown()
    assert calls == [
        ("head", {"CPU": 2, "GPU": 0.0}),
        ("monitor", {"idle_timeout_minutes": 0.05, "max_workers": 8,
                     "available_node_types": types}, "LocalNodeProvider",
         {"head_host": "127.0.0.1", "head_port": 4321, "session_dir": "/s",
          "node_types": types}, "127.0.0.1", 4321, 0.5),
        "monitor start", "monitor stop", "provider shutdown",
        ("head stop", True)]


def test_half_gpu_actors_share_their_bundle_device():
    """Two ``{"GPU": 0.5}`` actors in one ``{"GPU": 1}`` bundle on the
    node that declares one GPU both see its device, and the bundle's share
    comes back when they exit: a whole-GPU actor in the bundle sees it
    next."""
    from ray_tpu_torch.util.placement_group import (
        placement_group, remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import (
        PlacementGroupSchedulingStrategy)

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    session_dir = cluster.session_dir
    try:
        gpu_node = cluster.add_node(num_cpus=2, num_gpus=1)
        ray_tpu_torch.init(_node=cluster.head_node)
        cluster.wait_for_nodes()
        pg = placement_group([{"GPU": 1}])
        assert pg.wait(timeout_seconds=60)

        @ray_tpu_torch.remote(num_cpus=0)
        class Seen:
            def seen(self):
                import os

                return (ray_tpu_torch.get_runtime_context().get_node_id(),
                        os.environ.get("CUDA_VISIBLE_DEVICES"))

        def in_bundle(gpus):
            return Seen.options(
                num_gpus=gpus, scheduling_strategy=(
                    PlacementGroupSchedulingStrategy(
                        placement_group=pg,
                        placement_group_bundle_index=0))).remote()

        halves = [in_bundle(0.5) for _ in range(2)]
        seen = ray_tpu_torch.get([a.seen.remote() for a in halves],
                                 timeout=60)
        assert seen == [(gpu_node.node_id, "0")] * 2
        for a in halves:
            ray_tpu_torch.kill(a)
        whole = in_bundle(1)
        assert ray_tpu_torch.get(whole.seen.remote(), timeout=60) == (
            gpu_node.node_id, "0")
        ray_tpu_torch.kill(whole)
        remove_placement_group(pg)
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()
    port_session_leak_check(session_dir)
