"""A cell of ``BENCHMARK.json`` and everything the harness finds by its
names: the configuration file, the traffic mix, the limits of the
correctness check, the reader of each metric the cell reports, and the
module of the configuration's model family."""
from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FAMILIES = HERE / "families"


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


def family(name: str):
    """The module ``portbench/families/<name>.py`` of a model family, which
    holds everything the benchmark decides by family:

    - ``port_config(conf, cfg) -> cfg``: the port's configuration ``cfg``
      held to the configuration file ``conf`` (or built from its keys);
      a difference it does not allow raises;
    - ``layout(conf)``: ``{path: (shape, std)}`` of every leaf of the
      port's parameter tree (``a/b/c``), in the order the weights are
      drawn (``portbench/weights.py``);
    - ``logits(w, conf, tokens, rows, *, precision, bf16_cache_from)``:
      the family's plain reference under ``portbench/reference/``;
    - ``train_steps(flat0, conf, batches, mix, precision)``: the
      reference's training steps; a family without it has no training
      cell;
    - ``matmul_params(conf)``, ``attn_flops_per_pair(conf)`` and
      ``logit_params(conf)``: the weights one token multiplies by in the
      layer stack, the forward attention FLOPs of one (query, key) pair
      over every layer, and the weights of one logit row, from which
      ``portbench/flops.py`` counts a model's FLOPs.

    Raises where the module is missing, naming the file."""
    path = FAMILIES / f"{name}.py"
    if not path.is_file():
        raise RuntimeError(f"the benchmark has no module for the family "
                           f"{name!r}: it needs portbench/families/{name}.py")
    return _module(path)


@functools.cache
def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"portbench.families.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
