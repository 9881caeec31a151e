"""Finds a cell's pieces by name: its entry in `BENCHMARK.json`, its
workload file (`benchmark/workloads/<cell>.json`: the traffic's kind and
parameters and the limits of its correctness check), its configuration
(`benchmark/configs/<config>.json`), the module of the configuration's
model family (`benchmark/families/<family>.py`: the program's and the
reference's models, see `models.py`), the traffic's module
(`benchmark/traffic/<kind>.py`) and a reader for each metric
(`benchmark/metrics/<name before the first dot>.py`, a `read(ctx)` that
returns a number, or None where the run has nothing to read). Adding any of
them adds files and edits none."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict  # benchmark/workloads/<name>.json
    config: dict  # benchmark/configs/<config>.json
    end_to_end: List[dict]  # the BENCHMARK.json metrics this cell reports
    per_layer: List[dict]


def reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether a cell reports a metric: by the metric's `workloads` list, or
    without one, an end-to-end metric in every cell, a per-layer metric in
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, spec: dict = None) -> Cell:
    spec = load_spec() if spec is None else spec
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json("workloads", name)
    if (workload["config"], workload["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {workload['config']}/"
                         f"{workload['traffic']}, BENCHMARK.json {entry['config']}/"
                         f"{entry['traffic']}")
    e2e = [m for m in spec["end_to_end"] if reports(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if reports(m, name, names)]
    config = load_json("configs", entry["config"])
    family(config["family"])
    return Cell(name, entry["chips"], workload, config, e2e, per_layer)


def family(name: str):
    """The module of model family `name`; a family with no module fails
    here, naming the file looked for."""
    module = f"benchmark.families.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as err:
        if err.name != module:
            raise
        raise ValueError(f"model family {name!r} has no module: "
                         f"{BENCH / 'families' / (name + '.py')} not found") from None


def traffic(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def reader(metric: str):
    return importlib.import_module(f"benchmark.metrics.{metric.split('.', 1)[0]}").read
