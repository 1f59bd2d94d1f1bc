"""Finding a cell's pieces by name: the workload and its configuration in
BENCHMARK.json, the traffic mix under mixes/, the comparison's limits under
limits/ and each per-layer metric's reader under metrics/."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_spec(path: Path = SPEC_FILE) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    return _by_name(spec["workloads"], name, "workload")


def config_entry(spec: dict, name: str) -> dict:
    return _by_name(spec["configs"], name, "configuration")


def load_config(spec: dict, name: str) -> dict:
    """The configuration file of configuration `name`, as it is run."""
    with open(ROOT / config_entry(spec, name)["file"]) as f:
        return json.load(f)


def load_mix(name: str) -> dict:
    """The traffic mix `name`: mixes/<name>.json."""
    with open(BENCH_DIR / "mixes" / f"{name}.json") as f:
        return json.load(f)


def load_limits(config: str) -> dict:
    """The comparison's limits for configuration `config`:
    limits/<config>.json, {number name: limit}."""
    with open(BENCH_DIR / "limits" / f"{config}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def metrics_for(spec: dict, workload_name: str, section: str) -> list:
    """The entries of `section` ('end_to_end' or 'per_layer') that cell
    `workload_name` reports: those without a `workloads` key, and those
    whose key lists it."""
    return [m for m in spec[section]
            if workload_name in m.get("workloads", [workload_name])]


def reader_path(metric: str) -> Path:
    """metrics/<metric>.py, else the reader of the name's first part
    (metrics/poll_ms.py reads poll_ms.view and poll_ms.headless)."""
    own = BENCH_DIR / "metrics" / f"{metric}.py"
    if own.exists():
        return own
    return BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"


def load_reader(metric: str):
    """The `read(ctx)` function of a per-layer metric."""
    path = reader_path(metric)
    mod_name = "bench_metric_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
