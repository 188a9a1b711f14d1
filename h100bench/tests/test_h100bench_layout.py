"""Every cell, configuration and per-layer metric of BENCHMARK.json is
found by name from its own file, and the file keeps to the contract's
shape."""

import json
import re

import pytest

from h100bench.harness import HERE, ROOT, load_cell, load_module

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    spec, config, traffic = load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["config"] == spec["config"] == config["name"]
    assert entry["traffic"] == spec["traffic"]
    assert entry["chips"] == spec["chips"] == 1
    assert hasattr(traffic, "Cell")
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"] == []
    assert len(config["source"]) <= 200 and data["source"]
    assert config["file"] == f"h100bench/configs/{config['name']}.json"


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_found_by_name(metric):
    reader = load_module(HERE / "layer_metrics" / f"{metric['name']}.py", "reader")
    assert callable(reader.read)
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", entry["unit"])
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
