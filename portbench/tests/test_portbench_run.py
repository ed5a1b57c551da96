"""A whole run of each cell at the port's smoke sizes on the CPU (the
harness's look for a card skipped), its result's keys, and the command's
refusals."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import CELLS, REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_at_smoke_size(smoke_cell, name, trace):
    import time
    from portbench import harness
    cell, cfg = smoke_cell(name)
    r = harness.run_cell(cell, 2 ** 31 + 3, 2.0, trace, "cpu",
                         time.perf_counter(), cfg=cfg)
    r.pop("info")
    assert list(r) == KEYS            # checks last; no breakdown off the card
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in want}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(r["checks"]) == set(cell.limits)
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_no_result():
    p = _run(["--workload", CELLS[1], "--seed", "1", "--seconds", "1",
              "--trace", "0"], REPO)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_alone_in_a_directory_no_result(tmp_path):
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", CELLS[1], "--seed", "1", "--seconds", "1",
              "--trace", "0"], tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_file_names_what_exists():
    from portbench import spec
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["source"] == c["source"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_profiles_a_window_after_the_measured_one(smoke_cell,
                                                               name):
    """The host's metrics come from the measured window, with the profiler
    off: as long as an untraced run's; the profiled window follows it."""
    import time
    from portbench import harness
    cell, cfg = smoke_cell(name)
    seen = {}
    orig = harness.Run.phase

    def phase(run, what):
        orig(run, what)
        seen[what] = (run.window, run.trace_window)

    harness.Run.phase = phase
    try:
        r = harness.run_cell(cell, 2 ** 31 + 5, 1.5, True, "cpu",
                             time.perf_counter(), cfg=cfg)
    finally:
        harness.Run.phase = orig
    (m0, m1), (p0, p1) = seen["check"]
    assert m1 - m0 >= 1.5 and p1 - p0 >= 1.5
    assert p0 >= m1
    assert r["device"]["window_s"] == p1 - p0
    assert list(r["info"]["phases_s"])[-3:] == ["window", "traced window",
                                                "check"]
