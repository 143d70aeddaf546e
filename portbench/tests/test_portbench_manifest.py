"""BENCHMARK.json against the contract's shape, and every file the harness
finds by name."""
import json
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.BENCH
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    assert len({w["name"] for w in manifest["workloads"]}) == \
        len(manifest["workloads"])


def test_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_entries(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", ["bitgcn-bin.reddit", "bitsage.flickr",
                                  "bitgcn-bin.flickr", "bitsage.reddit"])
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    prog = c.config["program"]
    for part in ("programs", "reference", "counts"):
        assert (BENCH / part / f"{prog}.py").exists()
    assert (BENCH / "loops" / f"{c.traffic['loop']['kind']}.py").exists()
    assert set(c.limits) == {"mean_gap", "row_gap"}
    for m in c.end_to_end + c.per_layer:
        name = harness.metric_spec(m["name"]).get("same_as", m["name"])
        assert (BENCH / "metrics" / f"{name}.py").exists()
    assert c.config["reduced"] == []


def test_metric_spec_joins_parts(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "m.json").write_text(
        '{"stage": "s", "kernels": ["a"]}')
    (tmp_path / "metrics" / "m.later.json").write_text('{"kernels": ["b"]}')
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    assert harness.metric_spec("m") == {"stage": "s", "kernels": ["a", "b"]}
    assert harness.metric_spec("absent") == {}


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-cell")
