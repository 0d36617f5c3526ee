"""BENCHMARK.json against the benchmark's contract: names, units, keys and
limits, and every cell's files found by name."""

import math
import re

import pytest

from benchmarks import harness

MAN = harness.load_json(harness.MANIFEST)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]
# Keys that count layers: the one cut a configuration may make besides the
# chip's share of a layer.
DEPTH_KEYS = ("num_hidden_layers", "num_layers", "n_layer", "n_layers")


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len(harness.MANIFEST.read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    assert all(TEXT.match(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (harness.ROOT / p).is_dir()


def test_run_seconds_fit_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    used = {w["config"] for w in MAN["workloads"]}
    files = set()
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        conf = harness.load_json(harness.ROOT / c["file"])
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        # only depth, or the keys of the chip's share of a layer that the
        # file states (``chip_share``: key -> chips that share each layer)
        allowed = set(DEPTH_KEYS) | set(conf.get("chip_share", {}))
        for key in c["reduced"]:
            assert NAME.match(key)
            assert key in allowed, key
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert key in conf["config"] and key in conf["published"]
            assert conf["config"][key] != conf["published"][key]
        assert set(conf.get("published", {})) == set(c["reduced"])


def test_workloads():
    ws = MAN["workloads"]
    assert 1 <= len(ws) <= 24
    assert len(set(CELLS)) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in ws}
    assert len(pairs) == len(ws)
    four = sum(1 for w in ws if w["chips"] == 4)
    assert four <= max(1, len(ws) // 4)
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert TEXT.match(w["why"])


def _metrics():
    return MAN["end_to_end"] + MAN["per_layer"]


def test_metric_names_units_and_keys():
    names = [m["name"] for m in _metrics()]
    assert len(set(names)) == len(names)
    assert 1 <= len(MAN["end_to_end"]) <= 16
    assert 1 <= len(MAN["per_layer"]) <= 128
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in _metrics():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    assert "setup_s" in [m["name"] for m in MAN["end_to_end"]]


def _reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    e2e = [m["name"] for m in MAN["end_to_end"] if _reports(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in MAN["per_layer"] if _reports(cell, m)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = harness.resolve_cell(cell)
    assert (harness.HERE / "drivers" / f"{c.driver}.py").is_file()
    assert (harness.HERE / "traffic" / f"{c.traffic_name}.json").is_file()
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    assert c.limits, "the cell has no limits file"
    for name, spec in c.limits.items():
        if not name.startswith("_"):
            assert spec["limit"] is not None
            assert spec["lower"] < spec["limit"] < spec["upper"]


def test_metric_readers_find_nothing_in_empty_readings():
    empty = {"window_s": 1.0, "steps": 0, "trace": None, "served": [],
             "stats0": {"steps": 0, "emitted": 0, "padded_slots": 0},
             "stats1": {"steps": 0, "emitted": 0, "padded_slots": 0},
             "untraced": {"steps": 0, "seconds": 0.0},
             "memory_peak_bytes": 0}
    for m in MAN["per_layer"]:
        assert harness.metric_reader(m["name"])(empty) is None, m["name"]


def test_percentile():
    assert harness.percentile([1, 2, 3, 4, 5], 50) == 3
    assert math.isclose(harness.percentile(list(range(101)), 95), 95)
    assert math.isclose(harness.percentile([4.0], 95), 4.0)
