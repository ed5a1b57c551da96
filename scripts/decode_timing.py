#!/usr/bin/env python3
"""The serving engine's decode step and engine rate on one card, for one
checkout of the port.

    python3 scripts/decode_timing.py [--tree DIR]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one), so that two commits can be compared in one run of
the machine, each in a process of its own: parent, change, change,
parent.  Every run does the same work in the same order, so the
allocator's cache is in the same state on both sides:

  0. a 2 x 512 prefill, eager, timed 5 times after one warm-up: median;
  1. the engine rate of ``chip_smoke.py`` phase 4 (qwen3-0.6b at full
     width, random weights from seed 0, 8 greedy requests of 512, 512,
     200, 200, 64, 64, 17 and 17 tokens, 16 tokens each, 4 slots), with
     the host seconds spent in admission and prefill: first in a fresh
     engine of a process that has served nothing (``cold``), then again in
     a second engine (``warm``);
  2. an engine with four slots (512, 512, 200 and 64 tokens): after two
     steps (prefills, the decode program's capture where there is one, one
     warm step), 32 decode steps, each timed alone on the host clock
     (each step ends in a sync): median and spread;
  3. 4 more decode steps under ``torch.profiler``: device busy time and
     idle share (the profiler's own host cost lengthens the window);
  4. the prefill of 0. again.

Output: JSON lines on stdout, the first one the card's name and power
limit as ``nvidia-smi`` gives them.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import device_us, emit, timed_method  # noqa: E402

STEPS = 32


def device_ms(prof):
    """Summed device time of the kernels a profile saw, and their count."""
    busy, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += device_us(e) / 1e3
            n += e.count
    return busy, n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_timing: needs a CUDA card", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    import repro_torch  # noqa: F401  (sets TF32 off)
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, SamplingParams
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    emit({"tree": str(tree), "build_s": _build.build()})
    cfg = get_config("qwen3-0.6b")
    model = get_model(cfg)
    params = model.init(seed=0, device=dev)

    def engine():
        return Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 40,
                      page_size=16, max_pages_per_slot=40, device=dev)

    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512))).to(dev)

    def prefill(when):
        times = []
        with torch.no_grad():
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.prefill(params, toks)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        emit({"window": f"prefill 2 x 512, eager, {when}", "median_ms":
              float(np.median(times[1:])), "min_ms": min(times[1:]),
              "max_ms": max(times[1:])})

    prefill("first")                                        # 0.

    # 1. the engine rate, cold and warm
    for run in ("cold", "warm"):
        rng = np.random.default_rng(0)
        eng = engine()
        lens = [512, 512, 200, 200, 64, 64, 17, 17]
        prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
        prefill_s = timed_method(eng, "_admit_and_prefill")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run(prompts, SamplingParams(max_tokens=16))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tokens = sum(len(v) for v in out.values())
        stats = eng.stats()
        emit({"engine_run": f"8 greedy requests, 16 tokens, 4 slots, {run}",
              "tokens": tokens, "seconds": dt, "tokens_per_s": tokens / dt,
              "prefill_s": sum(prefill_s),
              "prefill_share": sum(prefill_s) / dt,
              "decode_steps": stats["decode_steps"],
              "capture_s": stats.get("capture_s")})
        del eng

    # 2. decode steps, profiler off
    rng = np.random.default_rng(1)
    eng = engine()
    for n in (512, 512, 200, 64):
        eng.add_request(rng.integers(0, cfg.vocab_size, n),
                        SamplingParams(max_tokens=STEPS + 16))
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eng.step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(walls))
    emit({"window": f"decode step, 4 slots, profiler off ({STEPS} steps)",
          "median_ms": med, "tokens_per_s": 4e3 / med,
          "min_ms": min(walls), "p10_ms": float(np.percentile(walls, 10)),
          "p90_ms": float(np.percentile(walls, 90)), "max_ms": max(walls),
          "first_step_s": first_s, "capture_s": eng.stats().get("capture_s"),
          "steps_ms": walls})

    # 3. four decode steps, profiled
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, n = device_ms(prof)
    emit({"window": "4 decode steps, profiled", "wall_ms": wall,
          "device_busy_ms": busy, "kernels_seen": n,
          "idle_share": 1 - busy / wall if n else None,
          "idle_share_of_median_step": 1 - busy / 4 / med if n else None})

    prefill("last")                                         # 4.
    return 0


if __name__ == "__main__":
    sys.exit(main())
