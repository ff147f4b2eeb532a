"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix and lists the metrics. Everything else is
a file of its own that is found by its name, so a new cell, mix or
metric is a new file and no edit:

* ``configs/<config>.json``: the model and its local training recipe;
* ``workloads/<traffic>.json``: the traffic mix (fleet, data split,
  wire, the rounds the comparison follows);
* ``limits/<workload>.json``: the limit of each number ``correct``
  compares, with the readings it was set from;
* ``metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(ctx)`` that returns its value or None when it finds nothing to
  read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str) -> dict:
    """The cell ``workload``: its entry, configuration, traffic, limits
    and metrics (end-to-end and per-layer, those that it reports)."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    return {"name": workload, "chips": entry["chips"],
            "config": _json(HERE / "configs" / f"{entry['config']}.json"),
            "traffic": _json(HERE / "workloads" / f"{entry['traffic']}.json"),
            "limits": _json(HERE / "limits" / f"{workload}.json")["limits"],
            "end_to_end": [m for m in bench["end_to_end"]
                           if _applies(m, workload)],
            "per_layer": [m for m in bench["per_layer"]
                          if _applies(m, workload)]}


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "flbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
