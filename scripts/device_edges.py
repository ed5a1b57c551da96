#!/usr/bin/env python3
"""How well the program's device-edged spans agree with the profiler, in
one traced run of a benchmark cell on one card.

    python3 scripts/device_edges.py --workload qwen2.5-14b.reasoning \
        --seed 2147483711 [--seconds 51]

It runs the cell as ``portbench/run.py --trace 1`` does (the measured
window with the ``obs`` spans on, then the profiled window) and keeps the
run the metric readers read.  For each span name that carries
``device_us`` edges in the profiled window, it compares the edges with the
device records the profiler took inside them: the distance from the start
edge to the first record's start and from the last record's end to the end
edge (median, p90, and the medians of the window's first and last 2 s),
and from the span's host start to its start edge.  In both windows it
gives the median and the largest of what the device-edge readers average
(``stalls``), so that a stall seen only under the profiler shows as its.  It also reads the
tracer's anchor drift: an anchor taken after the run (synchronize, read
the clock, record) against the tracer's last, host seconds less device
seconds between them.  ``host_to_start_ms`` of the measured window (the
profiler off) is given beside those of the profiled one.

Output: one JSON line on stdout (the card's name and power limit, the
run's metrics and its end-to-end readings with tracing on, the edges, the
drift), also written to ``chiprun_out/device_edges_<cell>.json``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _edges(run, name):
    """Start and end distances (ms) of the profiled window's ``name`` spans
    from the first and last device record inside their device edges."""
    recs = sorted((s, e) for _, s, e in run.device.events)
    starts = [s for s, _ in recs]
    t0, t1 = run.trace_window
    rows = []
    for n, s, e, a in run.spans:
        if n != name or "device_us" not in a or not t0 < e <= t1:
            continue
        ds, de = s + a["device_us"][0] * 1e-6, s + a["device_us"][1] * 1e-6
        inside = recs[bisect.bisect_left(starts, ds):
                      bisect.bisect_right(starts, de)]
        if inside:
            rows.append((ds, (inside[0][0] - ds) * 1e3,
                         (de - max(r[1] for r in inside)) * 1e3,
                         (ds - s) * 1e3))
    if not rows:
        return None

    def med(vals):
        return statistics.median(vals) if vals else None

    def p90(vals):
        return statistics.quantiles(vals, n=10)[-1] if len(vals) > 1 else None

    first = [r for r in rows if r[0] < t0 + 2.0]
    last = [r for r in rows if r[0] > t1 - 2.0]
    return {"spans": len(rows),
            "start_ms": {"median": med([r[1] for r in rows]),
                         "p90": p90([r[1] for r in rows]),
                         "first_2s": med([r[1] for r in first]),
                         "last_2s": med([r[1] for r in last])},
            "end_ms": {"median": med([r[2] for r in rows]),
                       "p90": p90([r[2] for r in rows]),
                       "first_2s": med([r[2] for r in first]),
                       "last_2s": med([r[2] for r in last])},
            "host_to_start_ms": {"median": med([r[3] for r in rows]),
                                 "p90": p90([r[3] for r in rows])}}


def _dev(run, name, window):
    """``(host start, device start, device end, args)`` of the window's
    ``name`` spans that carry device edges, in host order."""
    t0, t1 = window
    return sorted((s, s + a["device_us"][0] * 1e-6,
                   s + a["device_us"][1] * 1e-6, a)
                  for n, s, e, a in run.spans
                  if n == name and "device_us" in a and t0 < e <= t1)


def _spread(vals):
    return ({"n": len(vals), "median": statistics.median(vals),
             "max": max(vals)} if vals else None)


def _stalls(run, window):
    """Per window, the median and the largest of what the readers average:
    a decode step's device interval and the idle before the next one (no
    prefill between), a prefill's device ms per 1k padded tokens, and a
    train step's time outside its three phases."""
    dec = _dev(run, "decode", window)
    pre = [s for n in ("prefill", "prefill.chunk")
           for s, _, _, _ in _dev(run, n, window)]
    opt_ends = [de for _, _, de, _ in _dev(run, "train.optimizer", window)]
    phases = [(ds, de) for n in ("train.forward", "train.backward",
                                 "train.optimizer")
              for _, ds, de, _ in _dev(run, n, window)]
    return {
        "decode_dev_ms": _spread([(de - ds) * 1e3 for _, ds, de, _ in dec]),
        "decode_gap_ms": _spread([
            (b[1] - a[2]) * 1e3 for a, b in zip(dec, dec[1:])
            if not any(a[0] < p < b[0] for p in pre)]),
        "prefill_dev_ms_per_ktok": _spread([
            (de - ds) * 1e6 / (a["batch"] * a["padded"])
            for _, ds, de, a in _dev(run, "prefill", window)]),
        "train_gap_ms": _spread([
            (hi - lo - sum(e - s for s, e in phases if lo <= s < hi)) * 1e3
            for lo, hi in zip(opt_ends, opt_ends[1:])]),
        **{f"{n}_ms": _spread([(de - ds) * 1e3
                               for _, ds, de, _ in _dev(run, n, window)])
           for n in ("train.forward", "train.backward", "train.optimizer")}}


def _drift(tracer):
    """Host less device seconds from the tracer's anchor to a new one, and
    the host seconds between them."""
    import torch
    ev, t_anchor = tracer._anchor
    torch.cuda.synchronize()
    end = torch.cuda.Event(enable_timing=True)
    t_end = time.perf_counter()
    end.record()
    torch.cuda.synchronize()
    return {"over_s": t_end - t_anchor,
            "drift_us": ((t_end - t_anchor) - ev.elapsed_time(end) * 1e-3)
            * 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    if not torch.cuda.is_available():
        print("device_edges: needs a CUDA card", file=sys.stderr)
        return 2
    from portbench import harness, spec
    from portbench.hw import nvidia_smi
    from repro_torch import obs
    kept = {}
    reader = spec.reader

    def keeping(name):
        read = reader(name)

        def read_and_keep(run):
            kept.setdefault("run", run)   # the run, not its profiled copy
            return read(run)
        return read_and_keep

    spec.reader = keeping
    result = harness.run_cell(spec.cell(args.workload), args.seed,
                              args.seconds, True, "cuda:0", T_START)
    spec.reader = reader
    run = kept["run"]
    names = sorted({n for n, _, _, a in run.spans if "device_us" in a})
    measured = {n: _spread([(ds - s) * 1e3 for s, ds, _, _ in
                            _dev(run, n, run.window)]) for n in names}
    out = {"card": nvidia_smi(0), "workload": args.workload,
           "seed": args.seed, "metrics": {k: v["value"] for k, v in
                                          result["metrics"].items()},
           "end_to_end_traced": result["info"]["end_to_end"],
           "correct": result["correct"],
           "edges": {n: _edges(run, n) for n in names},
           "measured_host_to_start_ms": measured,
           "stalls": {"measured": _stalls(run, run.window),
                      "profiled": _stalls(run, run.trace_window)},
           "anchor": _drift(obs.last_tracer())}
    line = json.dumps(out)
    dest = REPO / "chiprun_out" / f"device_edges_{args.workload}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
