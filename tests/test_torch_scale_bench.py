"""The port's scale and chaos envelope (``ray_tpu_torch.scale_bench``) on the
CPU, held against the JAX package's ``scale_bench.py``: the same sections in
the same order, each reading and writing the same keys (one rename:
``data_shuffle``'s replay-worker probe checks torch where the reference
checks jax); the six sections that share one session run at small sizes in
a port session and in a JAX session, with the same result keys and the same
gate outcomes; the compiled DAG gives the eager DAG's outputs; ``main``'s
failure list and artifacts.

One port cluster per module; the JAX package's session runs the reference's
sections once, in a module fixture, outside its reaped session roots
(``jax_session``)."""

import ast
import inspect
import json
import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu_torch  # noqa: E402
import scale_bench as jax_bench  # noqa: E402
from ray_tpu_torch import scale_bench as bench  # noqa: E402
from tests.test_torch_runtime import (  # noqa: E402,F401
    jax_session, other_workers_jax_sessions_end, port_session_leak_check)

# the one key the port renames: its replay workers must not import torch
RENAMED = {"jax_unimported_in_replay_workers":
           "torch_unimported_in_replay_workers"}

# the shared-session sections at small sizes: (name, function, n, kwargs)
SHARED = [("many_tasks", "bench_many_tasks", 200, {"quick": True}),
          ("many_actors", "bench_many_actors", 20, {}),
          ("pg_churn", "bench_pg_churn", 5, {}),
          ("many_pgs", "bench_many_pgs", 20, {}),
          ("queued_tasks", "bench_queued_tasks", 500, {}),
          ("compiled_dag", "bench_compiled_dag", 3, {})]


def _functions(mod):
    tree = ast.parse(inspect.getsource(mod))
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _section_names(mod):
    """``main``'s ``results[...]`` keys, in the order it first names them."""
    subs = sorted((node.lineno, node.col_offset, node.slice.value)
                  for node in ast.walk(_functions(mod)["main"])
                  if isinstance(node, ast.Subscript) and
                  isinstance(node.value, ast.Name) and
                  node.value.id == "results" and
                  isinstance(node.slice, ast.Constant))
    names = []
    for _, _, name in subs:
        if name not in names:
            names.append(name)
    return names


def _keys(fn_node, port):
    """Every string a function (with its nested functions) uses as a dict
    key or a subscript: the result keys it writes and the stats it reads.
    The port's ``RAY_TPU_TORCH_`` settings are named as the reference's."""
    keys = set()
    for node in ast.walk(fn_node):
        if isinstance(node, ast.Dict):
            consts = [k for k in node.keys if isinstance(k, ast.Constant)]
        elif isinstance(node, ast.Subscript):
            consts = [node.slice] if isinstance(node.slice,
                                                ast.Constant) else []
        else:
            continue
        for c in consts:
            if isinstance(c.value, str):
                keys.add(c.value.replace("RAY_TPU_TORCH_", "RAY_TPU_")
                         if port else RENAMED.get(c.value, c.value))
    return keys


def test_sections_are_the_references_in_its_order():
    names = _section_names(bench)
    assert names == _section_names(jax_bench)
    assert names == ["many_tasks", "many_actors", "pg_churn", "many_pgs",
                     "queued_tasks", "compiled_dag", "actor_scale",
                     "cross_node", "broadcast", "chaos", "head_chaos",
                     "data_shuffle", "train_elastic", "serve_load"]
    benches = {n for n in _functions(jax_bench) if n.startswith("bench_")}
    assert {n for n in _functions(bench) if n.startswith("bench_")} == \
        benches
    assert len(benches) == len(names)


@pytest.mark.parametrize("name", sorted(
    n for n in _functions(jax_bench)
    if n.startswith("bench_") or n.startswith("_ledger_")))
def test_section_keys_are_the_references(name):
    """The same keys, the one rename aside; the ``data_shuffle`` section is
    the only one that has it."""
    port = _keys(_functions(bench)[name], port=True)
    ref = _keys(_functions(jax_bench)[name], port=False)
    assert port == ref, (sorted(port - ref), sorted(ref - port))
    assert (RENAMED["jax_unimported_in_replay_workers"] in port) is \
        (name == "bench_data_shuffle")


def test_artifact_overrides_are_the_ports():
    """``--out``'s default and the variables that override one artifact are
    the port's (``test_torch_serve_llm.py`` scans the imports)."""
    tree = ast.parse(inspect.getsource(bench))
    consts = {n.value for n in ast.walk(tree)
              if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    outs = {c for c in consts if c.endswith("_OUT")}
    assert outs == {"RAY_TPU_TORCH_ACTORSCALE_OUT",
                    "RAY_TPU_TORCH_BCAST_OUT",
                    "RAY_TPU_TORCH_HEADCHAOS_OUT",
                    "RAY_TPU_TORCH_DATASHUFFLE_OUT",
                    "RAY_TPU_TORCH_TRAINELASTIC_OUT",
                    "RAY_TPU_TORCH_SERVELOAD_OUT"}
    assert "scale_bench_out" in consts


# ------------------------------------------------------- main's bookkeeping

def test_failures_lists_errors_and_gates():
    ok = {"many_tasks": {"n": 1}, "head_chaos": {"pass": True},
          "data_shuffle": {"byte_identical": True,
                           "chaos": {"byte_identical": True}}}
    assert bench.failures(ok) == []
    bad = {"many_tasks": {"n": 1},
           "chaos": {"error": "GetTimeoutError: x"},
           "head_chaos": {"pass": False},
           "data_shuffle": {"byte_identical": False,
                            "chaos": {"error": "RuntimeError: y"}}}
    assert bench.failures(bad) == [
        "chaos: GetTimeoutError: x", "data_shuffle.chaos: RuntimeError: y",
        "head_chaos.pass is false", "data_shuffle.byte_identical is false"]


def test_section_turns_an_exception_into_its_error_entry():
    def boom(n):
        raise ValueError(f"bad {n}")

    assert bench._section(boom, 3) == {"error": "ValueError: bad 3"}
    assert bench._section(lambda n, k=0: {"n": n + k}, 1, k=2) == {"n": 3}


@pytest.mark.parametrize("keep", [True, False])
def test_artifacts_go_under_out_or_to_the_override(tmp_path, monkeypatch,
                                                   keep):
    monkeypatch.delenv("RAY_TPU_TORCH_BCAST_OUT", raising=False)
    bench._write_artifact(str(tmp_path), "RAY_TPU_TORCH_BCAST_OUT",
                          "BCAST_latest.json", {"a": 1})
    art = tmp_path / "BCAST_latest.json"
    assert json.loads(art.read_text()) == {"a": 1}
    bench._write_artifact(str(tmp_path), "RAY_TPU_TORCH_BCAST_OUT",
                          "BCAST_latest.json", {"error": "E: x"},
                          keep_previous_on_error=keep)
    assert json.loads(art.read_text()) == ({"a": 1} if keep
                                           else {"error": "E: x"})
    other = tmp_path / "elsewhere.json"
    monkeypatch.setenv("RAY_TPU_TORCH_BCAST_OUT", str(other))
    bench._write_artifact("unused", "RAY_TPU_TORCH_BCAST_OUT",
                          "BCAST_latest.json", {"b": 2})
    assert json.loads(other.read_text()) == {"b": 2}


# ------------------------------------------- the shared-session sections

@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


def _run_shared(mod, rt):
    return {name: getattr(mod, fn)(rt, n, **kw)
            for name, fn, n, kw in SHARED}


@pytest.fixture(scope="module")
def port_results(port_cluster):
    return _run_shared(bench, ray_tpu_torch)


@pytest.fixture(scope="module")
def jax_results(port_results):
    with jax_session():
        return _run_shared(jax_bench, ray_tpu)


def _shape(value):
    """A result's nested keys, its numbers and strings left out."""
    if isinstance(value, dict):
        return {k: _shape(v) for k, v in value.items()}
    return None


def _gates(res):
    """The outcomes each section's figures decide: every count is the one
    asked for, every rate positive, and the disabled flight recorder costs
    under 2% of a task, plain and batched."""
    ev = res["many_tasks"]["events_disabled"]
    return {
        "counts": [res[k]["n"] for k in ("many_tasks", "many_actors",
                                         "pg_churn", "many_pgs",
                                         "queued_tasks")],
        "sample_rate": ev["sample_rate"],
        "events_disabled": ev["overhead_pct_of_task"] < 2.0,
        "batched": res["many_tasks"]["batched"]["overhead_pct_of_task"]
        < 2.0,
        "rates": all(res[k][r] > 0 for k, r in (
            ("many_tasks", "tasks_per_s"), ("many_actors", "actors_per_s"),
            ("pg_churn", "pg_cycles_per_s"), ("many_pgs", "pgs_per_s"),
            ("queued_tasks", "drain_per_s"))),
        "dag_iters": [res["compiled_dag"][s]["iters"]
                      for s in ("1kb", "10mb")],
    }


def test_shared_sections_give_the_references_keys(port_results,
                                                  jax_results):
    assert _shape(port_results) == _shape(jax_results)


def test_shared_sections_gates_hold_in_both(port_results, jax_results):
    want = {"counts": [200, 20, 5, 20, 500], "sample_rate": 0.0,
            "events_disabled": True, "batched": True, "rates": True,
            "dag_iters": [3, 5]}
    assert _gates(port_results) == want
    assert _gates(jax_results) == want


@pytest.mark.parametrize("elems", [256, 10 * 1024 * 1024 // 4],
                         ids=["1kb", "10mb"])
def test_compiled_dag_outputs_equal_the_eager_dags(port_cluster, elems):
    x = np.random.default_rng(5).random(elems, dtype=np.float32)
    dag = bench.three_stage_dag(ray_tpu_torch)
    eager = ray_tpu_torch.get(dag.execute(x), timeout=120)
    compiled = dag.experimental_compile()
    try:
        got = [compiled.execute(x).get(timeout=120) for _ in range(3)]
    finally:
        compiled.teardown()
    np.testing.assert_array_equal(eager, x)
    for g in got:
        assert g.dtype == eager.dtype and g.shape == eager.shape
        np.testing.assert_array_equal(g, eager)
