"""On the card: one short run of a cell through the command, traced, and
its result's line as the contract has it.  Skips without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "qwen3-0.6b.long_prompt", "--seed", str(2 ** 31 + 77), "--seconds",
         "5", "--trace", trace], cwd=REPO, capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace == "1" else ["checks"]
    assert list(r) == keys
    assert r["correct"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace == "1":
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
        for name, m in r["metrics"].items():
            if "roofline" in name or "mfu" in name:
                assert 0 < m["value"] <= 100
    assert p.stderr.strip().splitlines()[-1].startswith("check served_gap")
