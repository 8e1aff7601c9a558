"""BENCHMARK.json and the files it names: names and units from the
allowed characters, one file for each configuration, traffic mix, limit
set and per-layer metric."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_name_and_unit(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")


def test_every_name_is_allowed_and_unique():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_files_under_paths_are_named_from_allowed_characters():
    for path in BENCH["paths"]:
        for f in (ROOT / path).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            assert re.match(r"^[A-Za-z0-9_.-]+$", f.name), f


@pytest.mark.parametrize("workload", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files(workload):
    from portbench.harness import spec

    cell = spec.cell(workload["name"])
    assert cell["limits"]["limits"]
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_per_layer_metrics_move_a_metric_their_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    reported = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= reported[m["moves"]], m["name"]


def test_every_cell_reports_setup_and_another_end_to_end_metric():
    for w in BENCH["workloads"]:
        names = {m["name"] for m in BENCH["end_to_end"]
                 if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in names and len(names) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
