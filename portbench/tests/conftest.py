"""Shared pieces of the benchmark's own tests: the repo's ``src`` and root
on the path, and each cell cut to the port's smoke sizes so that the whole
harness runs on the CPU."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

CELLS = ("qwen2.5-14b.reasoning", "qwen3-0.6b.long_prompt",
         "qwen3-0.6b.train")

# an open-loop mix: Poisson arrivals at ``rate`` a second, lognormal
# lengths (no cell of the benchmark has one yet; the generator and the
# clients serve it)
OPEN_MIX = {"kind": "serve", "loop": "open", "rate": 7.2,
            "prompt": {"dist": "lognormal", "median": 256, "sigma": 1.0,
                       "lo": 32, "hi": 2048},
            "output": {"dist": "lognormal", "median": 128, "sigma": 0.8,
                       "lo": 16, "hi": 512},
            "requests": 4096, "block": 64,
            "engine": {"max_slots": 64, "page_size": 16,
                       "max_pages_per_slot": 160, "num_pages": 10241},
            "warmup_s": 8, "check": {"requests": 8, "tokens": 800}}


def smoke(name: str):
    """``(cell, port config)``: the cell at the port's smoke sizes, its
    traffic shortened to match."""
    from portbench import spec
    from repro_torch.configs import get_smoke_config
    cell = copy.deepcopy(spec.cell(name))
    cfg = get_smoke_config(cell.conf["registry"])
    cell.conf.update(num_hidden_layers=cfg.n_layers, hidden_size=cfg.d_model,
                     vocab_size=cfg.vocab_size,
                     num_attention_heads=cfg.n_heads,
                     num_key_value_heads=cfg.n_kv_heads,
                     head_dim=cfg.head_dim, intermediate_size=cfg.d_ff)
    m = cell.mix
    if m["kind"] == "serve":
        for key, lo, hi in (("prompt", 8, 40), ("output", 2, 8)):
            m[key] = dict(m[key], lo=lo, hi=hi)
            if "median" in m[key]:
                m[key]["median"] = (lo + hi) // 2
        m["engine"] = dict(m["engine"], max_pages_per_slot=8,
                           num_pages=1 + m["engine"]["max_slots"] * 8)
        m["warmup_s"] = 0.3
        m["requests"] = 8192        # short answers: many requests a second
        if m["loop"] == "open":
            m["rate"] = 4.0
        m["check"] = {"requests": 3, "tokens": 40}
    else:
        m["batch"], m["seq"] = 2, 32
    return cell, cfg


@pytest.fixture
def smoke_cell():
    return smoke
