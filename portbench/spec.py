"""A cell of ``BENCHMARK.json`` and everything the harness finds by its
names: the configuration file, the traffic mix, the limits of the
correctness check, and the reader of each metric the cell reports."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    conf: dict                   # the configuration file
    mix: dict                    # the traffic mix
    limits: dict                 # the correctness check's limits
    end_to_end: list             # metric entries the cell reports
    per_layer: list


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name``; raises ``KeyError`` for a name the file lacks."""
    bench = bench or load_benchmark()
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf_entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    with open(REPO / conf_entry["file"]) as f:
        conf = json.load(f)
    from . import traffic
    mix = traffic.load(work["traffic"])
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name, work["chips"], conf, mix, limits, e2e, per_layer)


def reader(metric: str):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
