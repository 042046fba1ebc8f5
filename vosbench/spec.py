"""BENCHMARK.json and the files it names, found by name.

  configuration  its entry's `file` (vosbench/configs/<name>.json)
  traffic mix    vosbench/traffic/<traffic>.json
  metric         vosbench/metrics/<metric name>.py, a module with
                 read(run) -> float | None
  limits         vosbench/limits/<workload>.json, the limit of each number
                 that decides `correct`
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def workload(spec: dict, name: str) -> dict:
    return _by_name(spec["workloads"], name, "workload")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration file of a configuration, as it is run."""
    entry = _by_name(spec["configs"], name, "configuration")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(workload_name: str) -> dict:
    with open(BENCH_DIR / "limits" / f"{workload_name}.json") as f:
        return json.load(f)


def metrics_for(spec: dict, workload_name: str, kind: str) -> List[dict]:
    """The cell's metrics of one kind ("end_to_end" or "per_layer"): each
    entry without a workloads list, or whose list names the cell."""
    return [m for m in spec[kind]
            if workload_name in m.get("workloads", [workload_name])]


_READERS: Dict[str, object] = {}


def reader(metric_name: str):
    """read(run) of vosbench/metrics/<metric_name>.py."""
    if metric_name not in _READERS:
        path = BENCH_DIR / "metrics" / f"{metric_name}.py"
        mod_spec = importlib.util.spec_from_file_location(
            "vosbench_metric_" + metric_name.replace(".", "_"), path)
        if mod_spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _READERS[metric_name] = mod.read
    return _READERS[metric_name]
