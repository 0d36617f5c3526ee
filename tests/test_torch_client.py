"""The port's ``ray://`` client (``ray_tpu_torch.util.client``) on its
runtime, on the CPU: the cases of the JAX package's ``tests/test_client.py``
to the same expectations — tasks, puts, refs as task args, errors, actors,
named actors, wait and the cluster's view over the client connection — and
a torch tensor's round trip.

One port cluster for the module (``num_cpus=4``), a client server next to
its driver and one client connected through ``init(address="ray://...")``.
Remote functions and classes are made inside the tests, so that they travel
by value and no worker imports this module."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402


@pytest.fixture(scope="module")
def client_ctx():
    from ray_tpu_torch.util.client import ClientContext, serve

    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    server = serve(host="127.0.0.1", port=0)
    ctx = ray_tpu_torch.init(address=f"ray://127.0.0.1:{server.port}")
    assert isinstance(ctx, ClientContext)
    yield ctx
    ctx.disconnect()
    server.stop()
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_client_task(client_ctx):
    @client_ctx.remote
    def add(a, b):
        return a + b

    assert client_ctx.get(add.remote(2, 3), timeout=60) == 5


def test_client_put_get_roundtrip(client_ctx):
    arr = np.arange(10000, dtype=np.float32)
    ref = client_ctx.put(arr)
    out = client_ctx.get(ref, timeout=60)
    assert np.array_equal(out, arr)


def test_client_ref_as_task_arg(client_ctx):
    ref = client_ctx.put(21)

    @client_ctx.remote
    def double(x):
        return x * 2

    assert client_ctx.get(double.remote(ref), timeout=60) == 42


def test_client_task_error_propagates(client_ctx):
    @client_ctx.remote
    def boom():
        raise ValueError("client-visible error")

    with pytest.raises(Exception, match="client-visible error"):
        client_ctx.get(boom.remote(), timeout=60)


def test_client_actor(client_ctx):
    @client_ctx.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote()
    assert client_ctx.get(c.inc.remote(), timeout=60) == 1
    assert client_ctx.get(c.inc.remote(5), timeout=60) == 6
    client_ctx.kill(c)


def test_client_named_actor(client_ctx):
    @client_ctx.remote
    class Store:
        def __init__(self):
            self.v = "named-ok"

        def read(self):
            return self.v

    Store.options(name="client_named", lifetime="detached").remote()
    h = client_ctx.get_actor("client_named")
    assert client_ctx.get(h.read.remote(), timeout=60) == "named-ok"


def test_client_wait(client_ctx):
    @client_ctx.remote
    def fast():
        return "f"

    @client_ctx.remote
    def slow():
        import time

        time.sleep(5)
        return "s"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = client_ctx.wait([f, s], num_returns=1, timeout=30)
    assert len(ready) == 1 and ready[0].hex() == f.hex()


def test_client_cluster_info(client_ctx):
    assert client_ctx.cluster_resources().get("CPU", 0) > 0
    assert any(n["alive"] for n in client_ctx.nodes())


def test_client_torch_tensor_roundtrip(client_ctx):
    """A bf16 tensor put through the client comes back equal; a task that
    takes it as a ref returns a tensor computed in the worker, as torch
    computes it here."""
    t = torch.randn(4, 33, generator=torch.Generator().manual_seed(9)
                    ).to(torch.bfloat16)
    ref = client_ctx.put(t)
    back = client_ctx.get(ref, timeout=60)
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)

    @client_ctx.remote
    def scale(x):
        return (x.float() * 3).t()

    out = client_ctx.get(scale.remote(ref), timeout=60)
    assert out.dtype == torch.float32 and out.shape == (33, 4)
    assert torch.equal(out, (t.float() * 3).t())
