"""ray_tpu_torch.data against ray_tpu.data on the CPU: the same pipelines,
the same rows, bit for bit.

Each program below runs once through ``ray_tpu`` and ``ray_tpu.data`` (in a
module fixture whose cluster is shut down straight after, so that it is
not exposed to the other test processes' session-end reaping) and once
through ``ray_tpu_torch`` and ``ray_tpu_torch.data``: range and from_numpy;
map, map_batches and filter; ``random_shuffle(seed=)``; sort;
groupby-aggregate; split (round robin and equal) and ``streaming_split``;
``iter_batches``. ``iter_torch_batches(device="cpu")`` gives the values of
``iter_jax_batches`` on the CPU. A worker that ran the shuffle's map and
reduce tasks has imported no torch.

The map functions are defined inside the programs, so that they travel by
value and no worker imports this module (and with it jax)."""

import os

from tests import conftest as _tier

_tier.FAST_FILES.add(os.path.basename(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import ray_tpu  # noqa: E402
import ray_tpu.data  # noqa: E402
import ray_tpu_torch  # noqa: E402
import ray_tpu_torch.data  # noqa: E402
from tests.test_torch_runtime import port_session_leak_check  # noqa: E402

GET_TIMEOUT_S = 60


def _columns(rows):
    """take_all()'s rows as {column: array}."""
    return {k: np.asarray([r[k] for r in rows]) for k in rows[0]} \
        if rows else {}


def range_map_filter(rt, rd):
    ds = rd.range(60, parallelism=4).map(
        lambda r: {"id": r["id"], "sq": r["id"] * r["id"]}).filter(
        lambda r: r["id"] % 3 != 1)
    return _columns(ds.take_all())


def from_numpy_map_batches(rt, rd):
    arr = np.arange(48, dtype=np.float32).reshape(12, 4)
    ds = rd.from_numpy([arr[:5], arr[5:]]).map_batches(
        lambda b: {"data": b["data"] * 2 + 1, "n": b["data"].sum(1)},
        batch_size=4)
    return _columns(ds.take_all())


def random_shuffle(rt, rd):
    ds = rd.range(200, parallelism=4).map_batches(
        lambda b: {"id": b["id"], "x": b["id"] * 0.5}).random_shuffle(seed=7)
    return _columns(ds.take_all())


def sort(rt, rd):
    ds = rd.range(100, parallelism=4).map(
        lambda r: {"k": (r["id"] * 37) % 101, "v": r["id"]}).sort(
        "k", descending=True)
    return _columns(ds.take_all())


def groupby_aggregate(rt, rd):
    agg = rd.aggregate
    ds = rd.range(90, parallelism=3).map(
        lambda r: {"g": r["id"] % 5, "v": float(r["id"]) ** 1.5})
    rows = ds.groupby("g").aggregate(agg.Sum("v"), agg.Mean("v"),
                                     agg.Count()).take_all()
    return _columns(sorted(rows, key=lambda r: r["g"]))


def split(rt, rd):
    ds = rd.range(40, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 3})
    return {"round_robin": [_columns(p.take_all())["id"]
                            for p in ds.split(3)],
            "equal": [_columns(p.take_all())["id"]
                      for p in ds.split(2, equal=True)]}


def streaming_split(rt, rd):
    its = rd.range(40, parallelism=4).streaming_split(2)
    return [np.concatenate([b["id"] for b in it.iter_batches(
        batch_size=None, prefetch_batches=0)]) for it in its]


def iter_batches(rt, rd):
    ds = rd.range(50, parallelism=3)
    return {"seven": [b["id"] for b in ds.iter_batches(batch_size=7)],
            "drop_last": [b["id"] for b in ds.iter_batches(
                batch_size=8, drop_last=True)]}


PROGRAMS = [range_map_filter, from_numpy_map_batches, random_shuffle, sort,
            groupby_aggregate, split, streaming_split, iter_batches]


@pytest.fixture(scope="module")
def port_cluster():
    ray_tpu_torch.init(num_cpus=4)
    session_dir = ray_tpu_torch._global_node.session_dir
    yield session_dir
    ray_tpu_torch.shutdown()
    port_session_leak_check(session_dir)


@pytest.fixture(scope="module")
def jax_reference(port_cluster):
    """Every program's result through ``ray_tpu``, and the values of
    ``iter_jax_batches`` on the CPU."""
    import jax.numpy as jnp

    ray_tpu.init(num_cpus=4)
    try:
        out = {p.__name__: p(ray_tpu, ray_tpu.data) for p in PROGRAMS}
        out["iter_jax_batches"] = [
            {k: np.asarray(v) for k, v in b.items()}
            for b in ray_tpu.data.range(50, parallelism=3).map_batches(
                lambda b: {"id": b["id"], "x": b["id"] * 0.25}
            ).iter_jax_batches(batch_size=8,
                               dtypes={"x": jnp.float32})]
    finally:
        ray_tpu.shutdown()
    return out


def _assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, g, w)
        assert np.array_equal(g, w), (where, g, w)


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_same_rows_as_ray_tpu_data(port_cluster, jax_reference, program):
    got = program(ray_tpu_torch, ray_tpu_torch.data)
    _assert_same(got, jax_reference[program.__name__], program.__name__)


def test_shuffle_is_a_permutation_and_seeded(port_cluster, jax_reference):
    ids = jax_reference["random_shuffle"]["id"]
    assert sorted(ids.tolist()) == list(range(200))
    assert ids.tolist() != list(range(200))


def test_iter_torch_batches_cpu_equals_iter_jax_batches(port_cluster,
                                                        jax_reference):
    """On the CPU the port's iterator gives iter_jax_batches' values, with
    the dtypes asked for; drop_last None keeps the short last batch on the
    CPU (the reference's CPU iter_torch_batches), True drops it (its
    iter_jax_batches)."""
    ds = ray_tpu_torch.data.range(50, parallelism=3).map_batches(
        lambda b: {"id": b["id"], "x": b["id"] * 0.25})
    got = list(ds.iter_torch_batches(batch_size=8, device="cpu",
                                     drop_last=True,
                                     dtypes={"x": torch.float32}))
    want = jax_reference["iter_jax_batches"]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == \
                "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
        assert g["x"].dtype == torch.float32
        assert g["id"].dtype == torch.int64
    kept = list(ds.iter_torch_batches(batch_size=8, device="cpu"))
    assert [len(b["id"]) for b in kept] == [8] * 6 + [2]


def test_iter_torch_batches_defaults_to_the_card(port_cluster):
    """Without ``device`` the batches go to the card, and with no card
    that raises: the CPU is taken only when asked for."""
    ds = ray_tpu_torch.data.range(8)
    if torch.cuda.is_available():
        batch = next(iter(ds.iter_torch_batches(batch_size=4)))
        assert batch["id"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ds.iter_torch_batches(batch_size=4)


def test_map_workers_import_no_torch(port_cluster):
    """The workers that ran a shuffle's map and reduce tasks and a
    map_batches stage have no torch in ``sys.modules``."""
    rows = ray_tpu_torch.data.range(64, parallelism=4).map_batches(
        lambda b: {"id": b["id"], "torch": np.asarray(
            ["torch" in __import__("sys").modules] * len(b["id"]))}
    ).random_shuffle(seed=3).take_all()
    assert len(rows) == 64 and not any(r["torch"] for r in rows)
    ns = {"__name__": "_probe"}
    exec("def probe():\n"
         "    import sys\n"
         "    return 'torch' in sys.modules\n", ns)
    probe = ray_tpu_torch.remote(ns["probe"])
    assert ray_tpu_torch.get([probe.remote() for _ in range(4)],
                             timeout=GET_TIMEOUT_S) == [False] * 4
