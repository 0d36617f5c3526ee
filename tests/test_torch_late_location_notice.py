"""A pulled copy whose owner frees the object before the copy's notice
lands: a node's agent wakes its readers (``_notify_sealed``) before it
sends the owner ``ObjectLocationAdded``, so a reader that drops the ref at
once frees the object with that copy unlisted. The envelope's
``data_shuffle`` ledger gate caught it under load. Here the owner holds the
notice until after the free, in both packages: the JAX package drops the
late notice and keeps the copy; the port frees it."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch.cluster_utils import Cluster  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    jax_session, no_port_session_left, other_workers_jax_sessions_end)


def _late_notice_leftover(rt, wm, settle_s):
    """Pull a 2 MiB object from the far node into the head's store while
    the owner (this driver, on the head) holds the copy's notice, drop the
    ref, then deliver the notice. Returns the bytes the head's store still
    keeps ``settle_s`` after it lands: 0 once the copy is freed."""
    import time

    w = wm.global_worker

    def head_used():
        return w._acall(w.agent.call("GetStoreStats", {}, timeout=15),
                        timeout=20)["used"]

    @rt.remote(resources={"far": 1})
    def make():
        import numpy as np

        return np.ones(1 << 18)

    handlers = w.direct_server._handlers
    notice = handlers["ObjectLocationAdded"]
    held = []

    async def hold(conn, p):
        held.append((conn, p))

    base = head_used()
    handlers["ObjectLocationAdded"] = hold
    try:
        ref = make.remote()
        assert float(rt.get(ref, timeout=60).sum()) == 1 << 18
        deadline = time.monotonic() + 30
        while not held and time.monotonic() < deadline:
            time.sleep(0.05)
        assert [p["object_id"] for _, p in held] == [ref.hex()]
        assert head_used() >= base + (1 << 21)
        del ref  # freed: only its far copy is listed
    finally:
        handlers["ObjectLocationAdded"] = notice
    for conn, p in held:
        w._acall(notice(conn, p), timeout=20)
    deadline = time.monotonic() + settle_s
    while head_used() > base and time.monotonic() < deadline:
        time.sleep(0.1)
    return head_used() - base


def test_a_copy_announced_after_its_free_is_freed(no_port_session_left):
    from ray_tpu_torch._private import worker as wm

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        ray_tpu_torch.init(_node=cluster.head_node)
        cluster.add_node(num_cpus=1, resources={"far": 1})
        cluster.wait_for_nodes()
        assert _late_notice_leftover(ray_tpu_torch, wm, settle_s=30) == 0
    finally:
        ray_tpu_torch.shutdown()
        cluster.shutdown()


def test_the_reference_keeps_a_copy_announced_after_its_free():
    """The JAX package's owner drops the late notice: the copy stays."""
    import ray_tpu
    from ray_tpu._private import worker as wm

    with jax_session(num_cpus=1, nodes=[{"CPU": 1.0, "far": 1.0}]):
        assert _late_notice_leftover(ray_tpu, wm, settle_s=5) >= 1 << 21
