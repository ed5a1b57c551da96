"""Arithmetic the metric readers share: what lies in the window, tails over
all samples, and the work of the launches and the model.

``run.window`` is the measured window, from which the host's clock and the
program's spans are read; ``run.trace_window`` the profiled one of a traced
run, from which the device's records and the launches are read."""
from __future__ import annotations

import numpy as np

from . import flops, hw
from .trace import KERNEL_NAMES, Busy


def p95(values) -> float | None:
    values = list(values)
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), 95))


def in_window(run, t: float, window=None) -> bool:
    t0, t1 = window or run.window
    return t0 < t <= t1


# ------------------------------------------------------------ serving

def window_tokens(run) -> int:
    return sum(1 for s in run.loop.sent.values() for t in s.times
               if in_window(run, t))


def arrivals(run) -> list:
    """Requests that arrived (were due, or were sent) in the window."""
    t0, t1 = run.window
    return [s for s in run.loop.sent.values() if t0 <= s.due < t1]


def ttfts(run) -> list:
    t1 = run.window[1]
    out = []
    for s in arrivals(run):
        first = s.times[0] if s.times else None
        out.append((first if first is not None and first <= t1 else t1)
                   - s.due)
    return out


def itls(run) -> list:
    t0, t1 = run.window
    out = []
    for s in run.loop.sent.values():
        ts = s.times
        for a, b in zip(ts, ts[1:]):
            if a > t0 and b <= t1:
                out.append(b - a)
    return out


def window_steps(run, window=None) -> list:
    return [st for st in run.loop.steps if in_window(run, st.end, window)]


def serve_model_flops(run) -> tuple[float, float]:
    """(prefill, decode) model FLOPs of the window's steps."""
    conf = run.conf
    pre = dec = 0.0
    for st in window_steps(run):
        pre += sum(flops.prefill_flops(conf, p) for p in st.prefilled)
        dec += sum(flops.decode_flops(conf, n) for n in st.decode_rows)
    return pre, dec


# ------------------------------------------------------------ spans

def spans(run, name: str, window=None) -> list:
    """``(start, end, args)`` of the obs spans ``name`` that ended in the
    window (default: the measured one)."""
    return [(s, e, a) for n, s, e, a in run.spans
            if n == name and in_window(run, e, window)]


# ------------------------------------------------------------- device

def device_seconds(run, kernel: str) -> float | None:
    """Summed device time in the profiled window of the kernel's CUDA
    kernels."""
    if run.device is None or not run.device.ok:
        return None
    pats = KERNEL_NAMES[kernel]
    t0, t1 = run.trace_window
    total = sum(min(e, t1) - max(s, t0) for n, s, e in run.device.events
                if any(p in n for p in pats) and e > t0 and s < t1)
    return total or None


def busy_seconds(run) -> float | None:
    if run.device is None or not run.device.ok:
        return None
    return Busy((s, e) for _, s, e in run.device.events).seconds(
        *run.trace_window)


def launch_bound(run, kernel: str, work, **match) -> float:
    """Summed roofline seconds of the profiled window's launches of
    ``kernel`` whose shapes match ``match``: each eager launch once, each
    launch of the captured decode graph once a replay.  ``work(shape)``
    gives ``(flops, bytes)``."""
    if run.recorder is None:
        return 0.0

    def total(records):
        return sum(hw.roofline_s(*work(L.shape)) for L in records
                   if L.kernel == kernel
                   and all(L.shape.get(k) == v for k, v in match.items()))

    return total(run.recorder.eager) + run.graph_replays * total(
        run.recorder.graph)


def k1_work(s) -> tuple[float, float]:
    return flops.matmul_work(s["batch"], s["M"], s["N"], s["K"], s["bias"])


def share(bound_s, device_s) -> float | None:
    """A roofline share in %, or None where nothing ran."""
    if not bound_s or not device_s:
        return None
    return 100.0 * bound_s / device_s
