"""Find an open-loop cell's knee on the chip: the highest offered rate at
which the queue of requests waiting for their first token does not grow
across the window.

    python3 portbench/knee.py --workload <cell> --rates 2,3,4 --seconds 30

One process; each rate runs the cell's traffic at that rate (the mix's
file is not changed) and prints one JSON line: the backlog at the window's
open, middle and close, tok/s, the p95 of time to first token and of the
gaps between tokens.  The cell's traffic file then states a rate of about
four fifths of the knee.  The last line names the knee: the highest rate
of an unbroken run from the lowest at which the backlog at the close
exceeds the backlog at the open by less than one second of arrivals.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1_000_000_007)
    args = ap.parse_args(argv)
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import spec
    from portbench.harness import run_cell
    base = spec.cell(args.workload)
    knee, broken = None, False
    for rate in (float(r) for r in args.rates.split(",")):
        cell = copy.deepcopy(base)
        cell.mix["rate"] = rate
        r = run_cell(cell, args.seed, args.seconds, False, "cuda:0",
                     time.perf_counter())
        print(json.dumps({"rate": rate, "correct": r["correct"],
                          "backlog": r["info"]["backlog"],
                          "metrics": {k: v["value"] for k, v in
                                      r["metrics"].items()},
                          "attempted": r["attempted"]}), flush=True)
        b = r["info"]["backlog"]
        if not broken and b[2] <= b[0] + rate:   # grew by < 1 s of load
            knee = rate
        else:
            broken = True
    print(json.dumps({"knee": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
