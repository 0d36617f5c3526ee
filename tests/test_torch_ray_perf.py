"""The port's core microbenchmarks (``ray_tpu_torch._private.ray_perf``) on
the CPU: the benchmark names are the JAX package's; one filtered run of
``main`` in a port session returns a positive rate; ``run_ab`` flips the
port's own fast-path flags (``RAY_TPU_TORCH_SUBMIT_FASTPATH_ENABLED``,
``RAY_TPU_TORCH_COMPLETION_BATCH_ENABLED``, which the port's ``CONFIG``
reads), not the JAX package's. One port session, the file's fixture."""

import ast
import inspect
import os
import time

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import pytest  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu._private import ray_perf as jax_perf  # noqa: E402
from ray_tpu_torch._private import ray_perf  # noqa: E402
from ray_tpu_torch._private.config import CONFIG  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    other_workers_jax_sessions_end)

FLAGS = ("submit_fastpath_enabled", "completion_batch_enabled")


def _bench_names(mod):
    """Every name a module times or records: ``bench(...)`` /
    ``timeit(...)`` first arguments and ``results[...]`` keys."""
    names = set()
    for node in ast.walk(ast.parse(inspect.getsource(mod))):
        if isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                getattr(fn, "attr", None)
            if name in ("bench", "timeit"):
                names.add(node.args[0].value)
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "results" and \
                isinstance(node.slice, ast.Constant):
            names.add(node.slice.value)
    return names


def test_benchmark_names_match_jax():
    names = _bench_names(ray_perf)
    assert names == _bench_names(jax_perf)
    assert {"single client tasks sync", "single client tasks async",
            "single client tasks batched", "multi client tasks async",
            "1:1 actor calls sync", "1:1 actor calls async",
            "n:n actor calls async", "single client put gigabytes",
            "raw memcpy gigabytes"} <= names


@pytest.mark.parametrize("on", ["0", "1"])
def test_ab_knobs_are_the_ports_flags(on, monkeypatch):
    assert ray_perf._AB_KNOBS == tuple(
        "RAY_TPU_TORCH_" + f.upper() for f in FLAGS)
    assert jax_perf._AB_KNOBS == tuple("RAY_TPU_" + f.upper() for f in FLAGS)
    for knob in jax_perf._AB_KNOBS:
        monkeypatch.setenv(knob, "0")
    for knob in ray_perf._AB_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    assert all(getattr(CONFIG, f) is True for f in FLAGS)
    for knob in ray_perf._AB_KNOBS:
        monkeypatch.setenv(knob, on)
    assert all(getattr(CONFIG, f) is (on == "1") for f in FLAGS)


@pytest.fixture(scope="module")
def port4():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def test_run_ab_flips_the_ports_flags(port4, monkeypatch):
    """Each arm sets the knobs and then pauses (``set_arm``'s sleep): read
    the port's ``CONFIG`` there. Arm A runs with both flags on, arm B with
    both off, and the environment is restored after."""
    for knob in ray_perf._AB_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    seen = []

    class Clock:
        perf_counter = staticmethod(time.perf_counter)

        @staticmethod
        def sleep(s):
            seen.append(tuple(getattr(CONFIG, f) for f in FLAGS))

    monkeypatch.setattr(ray_perf, "time", Clock)
    out = ray_perf.run_ab(pairs=1, n=50)
    assert seen == [(True, True), (False, False)]
    assert not any(k in os.environ for k in ray_perf._AB_KNOBS)
    row = out["pairs"][0]
    assert all(v > 0 for arm in ("A", "B") for v in row[arm].values())
    assert set(out["summary"]["median_delta"]) == set(row["A"])


def test_filtered_main_returns_a_positive_rate(port4):
    """Last in the file: after ``main``'s set-up kills its task-submitting
    client actors, the node's CPUs stay leased (the reference's runtime
    does the same; ROADMAP Queue 3), so nothing that needs a CPU may
    follow it in this session."""
    results = ray_perf.main("single client tasks sync")
    assert set(results) <= {"single client tasks sync", "transport"}
    assert results["single client tasks sync"] > 0
