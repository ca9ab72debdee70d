"""Where the harness finds a cell's parts, by the names ``BENCHMARK.json``
gives: ``configs/<config>.json`` (the file the entry names), ``traffic/
<mix>.json``, ``metrics/<metric>.py`` (a reader with ``read(context)``,
which ``<metric>.<cells>`` shares) and ``limits/<cell>.json``. A new cell, mix or metric is new files and
entries, never an edit of a file that is here."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload entry ``name`` with its configuration (``config_data``)
    and traffic mix (``traffic_data``) read in."""
    bench = benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    entry = dict(found[0])
    config, = [c for c in bench["configs"] if c["name"] == entry["config"]]
    entry["config_data"] = _json(root / config["file"])
    entry["traffic_data"] = _json(root / "h100bench" / "traffic"
                                  / f"{entry['traffic']}.json")
    return entry


def limits(name: str, root: Path = ROOT) -> dict:
    path = root / "h100bench" / "limits" / f"{name}.json"
    return _json(path)["limits"] if path.exists() else {}


def metrics_for(kind: str, name: str, root: Path = ROOT) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
    reports: those listing it, and those that list no cells."""
    return [m for m in benchmark(root)[kind]
            if name in m.get("workloads", [name])]


def reader(metric: str, root: Path = ROOT):
    """The ``read(context)`` of ``metrics/<metric>.py``, else, for a metric
    ``<quantity>.<cells>`` (one quantity under the name of the cells whose
    end-to-end metric it moves), of ``metrics/<quantity>.py``."""
    folder = root / "h100bench" / "metrics"
    path = folder / f"{metric}.py"
    if not path.exists():
        path = folder / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
