"""A cell of ``BENCHMARK.json`` and the files it names, found by name:
the configuration's file, ``traffic/<traffic>.json``,
``limits/<workload>.json``, one reader ``metrics/<metric>.py`` for each
per-layer metric that the cell reports, and the two modules that the
configuration's ``reference`` names: ``tasks/<name>.py`` (the program's
side: inputs, facade call, loss, counts) and ``reference/<name>.py`` (the
plain reference).

The two modules are looked up here once, by :func:`cell`, and handed on
as modules.  ``home``: a directory laid out as this one (``configs/``,
``limits/``, ``traffic/``, ``tasks/``, ``reference/``) whose files are
found before this one's, for a cell that ``BENCHMARK.json`` does not list
(the tests' own configurations, tasks and references).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def _homes(home):
    return (Path(home), HERE) if home is not None else (HERE,)


def _find(home, folder, filename):
    """The first ``<folder>/<filename>`` of ``home`` and this directory."""
    for directory in _homes(home):
        path = directory / folder / filename
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {folder}/{filename} under {[str(d) for d in _homes(home)]}")


def benchmark():
    return _load(ROOT / "BENCHMARK.json")


def cell(name, workload=None, home=None):
    """dict(workload, config (the file's contents), traffic, limits,
    end_to_end, per_layer, task and reference (the modules the
    configuration names)) of the workload ``name``.  ``workload``:
    the entry of a cell that ``BENCHMARK.json`` does not list, found by
    the same files (the tests' runs of the sharded form and of their own
    tasks), its configuration ``configs/<config>.json`` where
    ``BENCHMARK.json`` does not list that either."""
    bench = benchmark()
    if workload is None:
        matches = [w for w in bench["workloads"] if w["name"] == name]
        if not matches:
            raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
        workload = matches[0]
    entry = next((c for c in bench["configs"] if c["name"] == workload["config"]), None)
    config = (ROOT / entry["file"] if entry is not None
              else _find(home, "configs", f"{workload['config']}.json"))
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    config = _load(config)
    return dict(workload=workload, config=config,
                traffic=_load(_find(home, "traffic", f"{workload['traffic']}.json")),
                limits=_load(_find(home, "limits", f"{name}.json")),
                end_to_end=end_to_end, per_layer=per_layer,
                task=task(config, home), reference=reference(config, home))


def _module(folder, cfg, home):
    """The module ``<folder>/<cfg['reference']>.py`` of ``home`` or this
    directory, imported by its dotted name under the checkout's root."""
    name = cfg["reference"]
    for directory in _homes(home):
        path = directory / folder / f"{name}.py"
        if path.is_file():
            dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
            return importlib.import_module(dotted)
    known = sorted({p.stem for d in _homes(home) for p in (d / folder).glob("*.py")}
                   - {"__init__"})
    raise ValueError(f"no {folder} module for the reference {name!r} ({folder}/ has {known})")


def task(cfg, home=None):
    """The program's side of the configuration's fit: the module
    ``tasks/<cfg['reference']>.py``."""
    return _module("tasks", cfg, home)


def reference(cfg, home=None):
    """The plain reference the configuration names: the module
    ``reference/<cfg['reference']>.py``."""
    return _module("reference", cfg, home)


def reader(metric):
    """The ``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
