"""The rest of the port's ``util`` and its ``Channel`` on its runtime, on the
CPU: the JAX package's cases for them, to the same expectations —
``tests/test_experimental.py``'s Channel, tracing, ``multiprocessing.Pool``,
joblib and parallel-iterator cases, ``tests/test_util_extras.py``'s remote
pdb and dask-gate cases, and ``tests/test_util.py``'s accelerator cases —
with a Channel round trip of a bf16 and of a non-contiguous tensor, and
each new module's public names held against the JAX package's.

One port cluster for the module (``num_cpus=4``). Remote functions are
made inside the tests, so that they travel by value and no worker imports
this module."""

import importlib
import os
import socket
import threading
import time
import types

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402


@pytest.fixture(scope="module")
def ray4():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


# ------------------------------------------------------------------ Channel
class TestChannel:
    def test_spsc_roundtrip(self, ray4):
        from ray_tpu_torch.experimental.channel import Channel

        ch = Channel(capacity=2)

        @ray_tpu_torch.remote
        def producer(ch, n):
            import numpy as np

            for i in range(n):
                ch.write(np.full((100,), i, np.float32))
            return "done"

        ref = producer.remote(ch, 6)
        for i in range(6):
            arr = ch.read(timeout=60)
            assert arr[0] == i
        assert ray_tpu_torch.get(ref, timeout=60) == "done"

    def test_backpressure_capacity(self, ray4):
        from ray_tpu_torch.experimental.channel import Channel

        ch = Channel(capacity=1)
        ch.write(1)
        with pytest.raises(TimeoutError):
            ch.write(2, timeout=0.3)  # reader never consumed slot 0
        assert ch.read(timeout=5) == 1
        ch.write(2)  # now fits
        assert ch.read(timeout=5) == 2

    def test_tensor_roundtrip_bf16_and_non_contiguous(self, ray4):
        """A task writes a bf16 tensor and a transposed (non-contiguous)
        fp32 one; the driver reads the same values, dtypes and shapes."""
        from ray_tpu_torch.experimental import Channel

        ch = Channel(capacity=2)

        @ray_tpu_torch.remote
        def producer(ch):
            import torch

            g = torch.Generator().manual_seed(5)
            ch.write(torch.randn(3, 5, 7, generator=g).to(torch.bfloat16))
            ch.write(torch.randn(8, 16, generator=g).t())
            return True

        ref = producer.remote(ch)
        bf16, transposed = ch.read(timeout=60), ch.read(timeout=60)
        assert ray_tpu_torch.get(ref, timeout=60)
        g = torch.Generator().manual_seed(5)
        want_bf16 = torch.randn(3, 5, 7, generator=g).to(torch.bfloat16)
        want_t = torch.randn(8, 16, generator=g).t()
        assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, want_bf16)
        assert transposed.shape == (16, 8)
        assert torch.equal(transposed, want_t)


# ------------------------------------------------------------------ tracing
class TestTimelineTracing:
    def test_timeline_complete_events(self, ray4):
        @ray_tpu_torch.remote
        def quick():
            return 1

        ray_tpu_torch.get([quick.remote() for _ in range(3)], timeout=60)
        tl = ray_tpu_torch.timeline()
        xs = [e for e in tl
              if e["ph"] == "X" and "quick" in (e.get("name") or "")]
        assert xs, "no complete task events"
        assert all(e["dur"] >= 0 for e in xs)

    def test_span_mirrors_to_timeline(self, ray4):
        from ray_tpu_torch.util.tracing import span

        with span("unit-span"):
            pass
        tl = ray_tpu_torch.timeline()
        assert any(e.get("name") == "span::unit-span" for e in tl)


# ---------------------------------------------------------- multiprocessing
class TestPool:
    def test_map_and_apply(self, ray4):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as pool:
            assert pool.map(lambda x: x * x, range(10)) == \
                [x * x for x in range(10)]
            assert pool.apply(lambda a, b: a + b, (3, 4)) == 7
            assert sorted(pool.imap_unordered(lambda x: -x, range(5))) == \
                [-4, -3, -2, -1, 0]
            assert pool.starmap(lambda a, b: a * b, [(2, 3), (4, 5)]) == \
                [6, 20]

    def test_async_results(self, ray4):
        from ray_tpu_torch.util.multiprocessing import Pool

        with Pool(processes=2) as pool:
            res = pool.map_async(lambda x: x + 1, range(6))
            assert res.get(timeout=60) == list(range(1, 7))
            assert res.successful()


class TestJoblib:
    def test_parallel_backend(self, ray4):
        joblib = pytest.importorskip("joblib")
        from ray_tpu_torch.util.joblib import register_ray

        register_ray()
        with joblib.parallel_backend("ray", n_jobs=2):
            out = joblib.Parallel()(
                joblib.delayed(lambda x: x ** 2)(i) for i in range(8))
        assert out == [i ** 2 for i in range(8)]


class TestParallelIterator:
    def test_for_each_filter_gather(self, ray4):
        from ray_tpu_torch.util import iter as rt_iter

        it = (rt_iter.from_range(20, num_shards=3)
              .for_each(lambda x: x * 2)
              .filter(lambda x: x % 4 == 0))
        out = sorted(it.gather_sync())
        assert out == sorted(x * 2 for x in range(20) if (x * 2) % 4 == 0)

    def test_batch(self, ray4):
        from ray_tpu_torch.util import iter as rt_iter

        batches = list(rt_iter.from_range(10, num_shards=2).batch(3))
        flat = [x for b in batches for x in b]
        assert sorted(flat) == list(range(10))
        assert all(len(b) <= 3 for b in batches)


# ---------------------------------------------------------- accelerators
class TestTpuSliceHelpers:
    def test_resource_names(self):
        from ray_tpu_torch.util.accelerators import (
            pod_slice_head_resource, pod_slice_resource)

        assert pod_slice_head_resource("v5e-64") == "TPU-v5e-64-head"
        assert pod_slice_resource("my-slice") == "my-slice"

    def test_slice_hosts(self):
        from ray_tpu.util.accelerators import slice_hosts as jslice_hosts
        from ray_tpu_torch.util.accelerators import slice_hosts

        n = slice_hosts("v5e-64")
        assert n is None or (isinstance(n, int) and n >= 1)
        for pod in ("v5e-64", "v4-32", "v5litepod-16", "v6e-8", "bogus"):
            assert slice_hosts(pod) == jslice_hosts(pod)

    def test_reserve_slice_fails_fast_without_head_node(self, ray4):
        from ray_tpu_torch.util.accelerators import reserve_tpu_slice

        # no node advertises the v5e-8 head resource here: the reservation
        # must fail fast with a clean error, not wedge
        with pytest.raises(Exception):
            reserve_tpu_slice("v5e-8", timeout_s=2.0)


# ------------------------------------------------------------ rpdb, dask
def test_remote_pdb_drives_session():
    """Attach over TCP and drive a breakpoint to completion."""
    from ray_tpu_torch.util import rpdb

    port_holder = {}
    results = {}

    def target():
        x = 41
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        port_holder["port"] = port
        dbg = rpdb.RemotePdb(port=port)
        dbg.set_trace()
        results["x"] = x  # the client's `c` lets us reach here

    t = threading.Thread(target=target, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while "port" not in port_holder and time.monotonic() < deadline:
        time.sleep(0.05)
    deadline = time.monotonic() + 10
    conn = None
    while time.monotonic() < deadline:
        try:
            conn = socket.create_connection(
                ("127.0.0.1", port_holder["port"]), timeout=5)
            break
        except OSError:
            time.sleep(0.1)
    assert conn is not None
    f = conn.makefile("rw", buffering=1)
    f.write("c\n")
    f.flush()
    t.join(timeout=10)
    assert not t.is_alive()
    assert results.get("x") == 41
    conn.close()


def test_gated_dask():
    from ray_tpu_torch.util import dask as rdask

    def has(lib):
        try:
            __import__(lib)
            return True
        except ImportError:
            return False

    if not has("dask"):
        with pytest.raises(ImportError, match="dask"):
            rdask.ray_dask_get({}, [])


# --------------------------------------------------- the JAX package's names
_MODULES = ["util.accelerators", "util.accelerators.tpu", "util.tracing",
            "util.tracing.tracing_helper", "util.multiprocessing",
            "util.multiprocessing.pool", "util.joblib",
            "util.joblib.ray_backend", "util.iter", "util.dask", "util.rpdb",
            "experimental", "experimental.channel", "dag", "util.client",
            "util.client.client", "util.client.server"]


@pytest.mark.parametrize("name", _MODULES)
def test_public_names_match_jax(name):
    """Each new module of the port exports what the JAX package's does:
    the same ``__all__`` where it has one, the same public names apart
    from imported modules."""
    tmod = importlib.import_module(f"ray_tpu_torch.{name}")
    jmod = importlib.import_module(f"ray_tpu.{name}")

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and not isinstance(v, types.ModuleType)}

    assert getattr(tmod, "__all__", None) == getattr(jmod, "__all__", None)
    assert public(tmod) == public(jmod)
    if name == "util.accelerators":
        for const in [n for n in jmod.__all__ if n.isupper()]:
            assert getattr(tmod, const) == getattr(jmod, const)
