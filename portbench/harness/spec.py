"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
the configuration's file, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and one reader ``metrics/<metric>.py`` for
each per-layer metric that the cell reports."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark():
    return _load(ROOT / "BENCHMARK.json")


def cell(name, workload=None):
    """dict(workload, config (the file's contents), traffic, limits,
    end_to_end, per_layer) of the workload ``name``.  ``workload``: the
    entry of a cell that ``BENCHMARK.json`` does not list, found by the same
    files (the tests' runs of the sharded form, whose cell is not listed)."""
    bench = benchmark()
    if workload is None:
        matches = [w for w in bench["workloads"] if w["name"] == name]
        if not matches:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        workload = matches[0]
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(workload=workload, config=_load(ROOT / entry["file"]),
                traffic=_load(HERE / "traffic" / f"{workload['traffic']}.json"),
                limits=_load(HERE / "limits" / f"{name}.json"),
                end_to_end=end_to_end, per_layer=per_layer)


def reader(metric):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
