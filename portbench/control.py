"""Readings that set a cell's correctness limits, on the chip.

    python3 portbench/control.py --workload <cell> --seeds <n> \
        --control-seeds <m> --seconds <s> [--fault half_batch]

In one process: the program's sound runs on ``n`` seeds (the lower
readings), and on the first ``m`` of them the control, the reference
computed in bf16 in the program's place (the upper readings).  With
``--fault half_batch`` a training cell also runs the program with half of
each batch left out (the loss and gradient taken over the rest).  One JSON
line a run on standard output.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def half_batch(step):
    """A training step that leaves out the second half of each batch."""
    def broken(state, batch):
        n = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    return broken


FAULTS = {"half_batch": half_batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_011)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    args = ap.parse_args(argv)
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import spec
    from portbench.harness import run_cell
    cell = spec.cell(args.workload)
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        runs = [("program", None, i < args.control_seeds)]
        if args.fault and i < args.control_seeds:
            runs.append((args.fault, FAULTS[args.fault], False))
        for label, fault, control in runs:
            r = run_cell(cell, seed, args.seconds, False, "cuda:0",
                         time.perf_counter(), fault=fault, control=control)
            print(json.dumps({"seed": seed, "run": label,
                              "correct": r["correct"],
                              "checks": r["checks"],
                              "control": r["info"].get("control"),
                              "metrics": r["metrics"],
                              "info": r["info"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
