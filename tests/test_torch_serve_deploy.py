"""ray_tpu_torch's Serve control plane on the CPU: ``build_llama_app``
through ``serve.run`` streams the same greedy tokens as the in-process port
``LlamaGenerator`` of the same seed (which ``test_torch_serve_llm.py`` holds
against the JAX generator), and the port runs the JAX package's admission,
shed and replica-kill scenarios (``tests/test_serve_load.py``) to the same
expectations.

One port cluster per module, booted with ``num_gpus=1`` (nothing here asks
for the GPU: the generator runs with ``device="cpu"``)."""

import dataclasses
import os
import signal
import threading
import time

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu_torch import serve  # noqa: E402
from ray_tpu_torch.exceptions import BackPressureError, RayTpuError  # noqa: E402
from ray_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from ray_tpu_torch.serve import llm  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

TINY = dataclasses.replace(LlamaConfig.tiny(), dtype=torch.float32)
GEN_KW = dict(lora_rank=2, max_batch_size=2, allowed_batch_sizes=(1, 2),
              max_new_tokens=6, seq_bucket=16)
# (prompt, adapter): the adapter rides the multiplexed model id or the
# payload, as a client chooses
REQUESTS = [([3, 5, 7], ""), ([3, 5, 7], "a1"), ([11, 2, 9, 4, 1], "a2"),
            ([3, 5, 7], "a1"), ([8, 8, 1, 30, 2, 2, 7], "a2")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as tests/conftest.py sets for XLA: the tier runs
    files in parallel worker processes that must not starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def serve_cluster():
    ray_tpu_torch.init(num_cpus=8, num_gpus=1)
    session_dir = ray_tpu_torch._global_node.session_dir
    serve.start(http_options={"port": 0})
    yield session_dir
    serve.shutdown()
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


@pytest.fixture(scope="module")
def llama_app(serve_cluster):
    handle = serve.run(llm.build_llama_app(config=TINY, device="cpu",
                                           **GEN_KW), name="llama")
    yield handle
    serve.delete("llama")


def _stream(handle, prompt, adapter, via_model_id):
    if via_model_id:
        opts = dict(stream=True, multiplexed_model_id=adapter)
        payload = {"prompt": prompt, "max_new": 6}
    else:
        opts = dict(stream=True)
        payload = {"prompt": prompt, "max_new": 6, "adapter": adapter}
    return list(handle.options(**opts).remote(payload))


def test_init_num_gpus_is_the_gpu_resource(serve_cluster):
    assert ray_tpu_torch.cluster_resources().get("GPU") == 1.0


def test_build_llama_app_options():
    app = llm.build_llama_app(config=TINY, device="cpu", max_batch_size=12,
                              max_ongoing_requests=16,
                              ray_actor_options={"num_gpus": 1})
    dep = app.deployment
    # the engine batch width needs admission headroom, as in the reference
    assert dep.max_ongoing_requests == 24
    assert dep.ray_actor_options == {"num_gpus": 1}
    assert app.kwargs["device"] == "cpu" and app.kwargs["config"] is TINY


def test_sequential_streams_match_in_process_generator(llama_app):
    gen = llm.LlamaGenerator(config=TINY, device="cpu", **GEN_KW)
    try:
        for i, (prompt, adapter) in enumerate(REQUESTS):
            want = list(gen({"prompt": prompt, "max_new": 6,
                             "adapter": adapter}))
            got = _stream(llama_app, prompt, adapter, via_model_id=i % 2 == 0)
            assert got == want, f"request {i} ({adapter!r})"
            assert len(got) == 6
    finally:
        gen.engine.shutdown()
    stats = llama_app.engine_stats.remote().result(timeout_s=30)
    assert stats["completed"] >= len(REQUESTS)


def test_concurrent_requests_through_the_handle(llama_app):
    """test_serve_load.py's test_llama_engine_generation through the
    deployment: 4 concurrent requests, adapters by multiplexed model id."""
    out, errors, threads = {}, [], []
    for i, adapter in enumerate(("", "a1", "a2", "a1")):
        def run(idx=i, ad=adapter):
            try:
                out[idx] = _stream(llama_app, [3, 5, 7], ad,
                                   via_model_id=True)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        t = threading.Thread(target=run)
        t.start()
        threads.append(t)
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), "llama generation hung"
    if errors:
        raise errors[0]
    for i in range(4):
        assert len(out[i]) == 6, f"request {i}: {out[i]}"
        assert all(isinstance(t, int) for t in out[i])
    assert out[1] == out[3], "same adapter diverged across batches"
    assert out[0] != out[1], "adapter had no effect"


def test_admission_queue_and_typed_shed(serve_cluster):
    """1 executing + 2 queued fit; everything beyond sheds with a typed
    BackPressureError (no spin-retry, no unbounded queue)."""

    @serve.deployment(num_replicas=1, max_ongoing_requests=1,
                      max_queued_requests=2)
    class Slow:
        def __call__(self, x):
            import time as _time

            _time.sleep(2.0)
            return x * 2

    handle = serve.run(Slow.bind(), name="slow", route_prefix="/slow")
    t0 = time.monotonic()
    responses = [handle.remote(i) for i in range(6)]
    ok, shed = [], []
    for r in responses:
        try:
            ok.append(r.result(timeout_s=60))
        except BackPressureError as e:
            shed.append(e)
            assert time.monotonic() - t0 < 30
    assert len(ok) == 3, f"admitted {len(ok)} (want 1 running + 2 queued)"
    assert len(shed) == 3
    assert all(v in {i * 2 for i in range(6)} for v in ok)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        st = serve.status("slow")["deployments"].get("Slow", {})
        if st.get("shed_total", 0) >= 3:
            break
        time.sleep(0.25)
    assert st.get("shed_total", 0) >= 3, f"sheds not in status: {st}"
    serve.delete("slow")


def test_replica_kill_mid_stream_typed_error(serve_cluster):
    """SIGKILL the replica mid-stream: the consumer gets a clean typed
    error (or the stream completes via another replica), never a hang; the
    deployment recovers for subsequent requests."""

    @serve.deployment(num_replicas=1, max_ongoing_requests=4)
    class Streamer:
        def pid(self):
            import os as _os

            return _os.getpid()

        def __call__(self, n):
            import time as _time

            for i in range(int(n)):
                _time.sleep(0.1)
                yield i

    handle = serve.run(Streamer.bind(), name="streamer",
                       route_prefix="/streamer")
    victim = handle.pid.remote().result(timeout_s=30)
    assert victim != os.getpid()
    outcome = {}
    got: list = []

    def consume():
        try:
            for chunk in handle.options(stream=True).remote(100):
                got.append(chunk)
        except Exception as e:  # noqa: BLE001 — asserted typed below
            outcome["error"] = e

    t = threading.Thread(target=consume)
    t.start()
    deadline = time.monotonic() + 30
    while not got and time.monotonic() < deadline:
        time.sleep(0.05)
    os.kill(victim, signal.SIGKILL)
    t.join(timeout=60)
    assert not t.is_alive(), "stream consumer hung after replica kill"
    err = outcome.get("error")
    if err is not None:
        assert isinstance(err, (RayTpuError, ConnectionError)), \
            f"untyped error after replica kill: {type(err).__name__}: {err}"
    deadline = time.monotonic() + 90
    recovered = False
    while time.monotonic() < deadline and not recovered:
        try:
            got = list(handle.options(stream=True).remote(3))
            recovered = got == [0, 1, 2]
        except Exception:  # noqa: BLE001 — still recovering
            time.sleep(0.5)
    assert recovered, "deployment did not recover after replica kill"
    serve.delete("streamer")
