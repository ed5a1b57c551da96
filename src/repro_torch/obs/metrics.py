"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The JAX package's registry, in the port, with its series names and its
snapshot layout.  ``repro_torch.obs.snapshot()`` answers "what is this
process doing": the dispatch explain counters, the numerics monitor and the
engine's latency histograms write series here directly, and the older
counter surfaces (the circuit breaker's totals, the faults fire-log, live
engines' stats) are folded in at read time as *sources*
(:func:`register_source`).

  * **stdlib only**: the engine and the dispatcher import it at module
    scope, and it reads nothing from a device;
  * **thread-safe**: every mutation holds one module lock;
  * **labels**: a metric name plus a frozen ``k=v`` label set identifies
    one time series; snapshot keys render as ``name{k=v,...}``;
  * **values, not objects, reset**: :func:`reset` zeroes every series but
    keeps the metric objects and the registered sources.
"""
from __future__ import annotations

import json
import threading

_LOCK = threading.RLock()
_METRICS: dict[str, "_Metric"] = {}
_SOURCES: dict[str, object] = {}

#: factor-2 ladder from 1 microsecond to ~17 minutes — the default for
#: wall-clock latency histograms (queue-wait / TTFT / TPOT).
TIME_BUCKETS_S = tuple(1e-6 * 2 ** i for i in range(31))

#: linear [0, 1] edges for fraction-valued observations (underflow fracs).
FRACTION_BUCKETS = tuple(i / 20 for i in range(21))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: tuple) -> str:
    if not key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


class _Metric:
    kind = "?"

    def __init__(self, name: str):
        self.name = name


class Counter(_Metric):
    """Monotonically increasing per-label-set totals."""
    kind = "counter"

    def __init__(self, name: str):
        super().__init__(name)
        self._values: dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels):
        with _LOCK:
            key = _label_key(labels)
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        with _LOCK:
            return self._values.get(_label_key(labels), 0)

    def series(self, **labels):
        """An increment function for one label set, whose key is resolved
        once: ``inc = c.series(kernel="matmul"); inc()`` is ``c.inc(
        kernel="matmul")`` for hot paths that count on every call."""
        key, values = _label_key(labels), self._values

        def inc(n: float = 1):
            with _LOCK:
                values[key] = values.get(key, 0) + n
        return inc

    def total(self) -> float:
        """Sum over every label set."""
        with _LOCK:
            return sum(self._values.values())

    def items(self) -> dict[str, float]:
        with _LOCK:
            return {_series_name(self.name, k): v
                    for k, v in self._values.items()}

    def reset(self):
        with _LOCK:
            self._values.clear()


class Gauge(_Metric):
    """Last-written value per label set, with running-extremum helpers."""
    kind = "gauge"

    def __init__(self, name: str):
        super().__init__(name)
        self._values: dict[tuple, float] = {}

    def set(self, v: float, **labels):
        with _LOCK:
            self._values[_label_key(labels)] = v

    def set_min(self, v: float, **labels):
        with _LOCK:
            key = _label_key(labels)
            cur = self._values.get(key)
            self._values[key] = v if cur is None else min(cur, v)

    def set_max(self, v: float, **labels):
        with _LOCK:
            key = _label_key(labels)
            cur = self._values.get(key)
            self._values[key] = v if cur is None else max(cur, v)

    def value(self, **labels):
        with _LOCK:
            return self._values.get(_label_key(labels))

    def items(self) -> dict[str, float]:
        with _LOCK:
            return {_series_name(self.name, k): v
                    for k, v in self._values.items()}

    def reset(self):
        with _LOCK:
            self._values.clear()


class Histogram(_Metric):
    """Fixed-bucket histogram: counts per ``(lo, hi]`` bucket plus an
    overflow slot, with sum/count and interpolated percentiles."""
    kind = "histogram"

    def __init__(self, name: str, buckets=TIME_BUCKETS_S):
        super().__init__(name)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}

    def observe(self, v: float, **labels):
        v = float(v)
        with _LOCK:
            key = _label_key(labels)
            counts = self._counts.setdefault(
                key, [0] * (len(self.buckets) + 1))
            i = 0
            while i < len(self.buckets) and v > self.buckets[i]:
                i += 1
            counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + v

    def _agg(self, labels: dict) -> tuple[list[int], float]:
        """Counts/sum for one label set, or merged over all sets when no
        labels are given."""
        with _LOCK:
            if labels:
                key = _label_key(labels)
                return (list(self._counts.get(
                    key, [0] * (len(self.buckets) + 1))),
                    self._sums.get(key, 0.0))
            merged = [0] * (len(self.buckets) + 1)
            for counts in self._counts.values():
                for i, c in enumerate(counts):
                    merged[i] += c
            return merged, sum(self._sums.values())

    def count(self, **labels) -> int:
        counts, _ = self._agg(labels)
        return sum(counts)

    def sum(self, **labels) -> float:
        _, s = self._agg(labels)
        return s

    def percentile(self, p: float, **labels) -> float:
        """Linear-interpolated percentile estimate from the bucket counts
        (0 when the histogram is empty)."""
        counts, _ = self._agg(labels)
        n = sum(counts)
        if n == 0:
            return 0.0
        target = (p / 100.0) * n
        cum = 0
        for i, c in enumerate(counts):
            if cum + c >= target and c > 0:
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1]

    def items(self) -> dict[str, dict]:
        with _LOCK:
            return {_series_name(self.name, k): {
                "buckets": list(self.buckets),
                "counts": list(c),
                "count": sum(c),
                "sum": self._sums.get(k, 0.0),
            } for k, c in self._counts.items()}

    def reset(self):
        with _LOCK:
            self._counts.clear()
            self._sums.clear()


# ------------------------------------------------------------- registry

def _get(name: str, cls, *args) -> _Metric:
    with _LOCK:
        m = _METRICS.get(name)
        if m is None:
            m = _METRICS[name] = cls(name, *args)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m


def counter(name: str, **labels) -> Counter:
    """Get-or-create; with labels, increments are ``counter(n, **labels)``
    on the returned object — this helper just resolves the metric."""
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str, buckets=None) -> Histogram:
    if buckets is None:
        return _get(name, Histogram)
    return _get(name, Histogram, buckets)


def inc(name: str, n: float = 1, **labels):
    counter(name).inc(n, **labels)


def observe(name: str, v: float, buckets=None, **labels):
    histogram(name, buckets).observe(v, **labels)


def set_gauge(name: str, v: float, **labels):
    gauge(name).set(v, **labels)


# -------------------------------------------------------------- sources
#
# A source is a zero-arg callable returning a flat {str: number} dict —
# the adapter mechanism folding pre-existing counter surfaces
# (guard.counters(), the faults fire-log, engine stats) into snapshot()
# without rewriting their owners.

def register_source(name: str, fn):
    with _LOCK:
        _SOURCES[name] = fn


def unregister_source(name: str):
    with _LOCK:
        _SOURCES.pop(name, None)


def read_sources() -> dict[str, dict]:
    with _LOCK:
        sources = dict(_SOURCES)
    return {name: dict(fn()) for name, fn in sources.items()}


# ------------------------------------------------- snapshot / diff / io

def snapshot(include_sources: bool = True) -> dict:
    """One nested dict of everything: ``{"counters": {series: total},
    "gauges": {...}, "histograms": {series: {buckets, counts, count,
    sum}}, "sources": {name: {...}}}``."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    with _LOCK:
        metrics = list(_METRICS.values())
    for m in metrics:
        if isinstance(m, Counter):
            out["counters"].update(m.items())
        elif isinstance(m, Gauge):
            out["gauges"].update(m.items())
        else:
            out["histograms"].update(m.items())
    if include_sources:
        out["sources"] = read_sources()
    return out


def diff(new: dict, old: dict) -> dict:
    """Delta between two snapshots: counter/source deltas (omitting
    zeros), changed gauges, and per-histogram count/sum deltas."""
    out = {"counters": {}, "gauges": {}, "histograms": {}, "sources": {}}
    for k, v in new.get("counters", {}).items():
        d = v - old.get("counters", {}).get(k, 0)
        if d:
            out["counters"][k] = d
    for k, v in new.get("gauges", {}).items():
        if old.get("gauges", {}).get(k) != v:
            out["gauges"][k] = v
    for k, v in new.get("histograms", {}).items():
        o = old.get("histograms", {}).get(k, {})
        dc = v["count"] - o.get("count", 0)
        if dc:
            out["histograms"][k] = {"count": dc,
                                    "sum": v["sum"] - o.get("sum", 0.0)}
    for src, vals in new.get("sources", {}).items():
        ovals = old.get("sources", {}).get(src, {})
        delta = {}
        for k, v in vals.items():
            if isinstance(v, (int, float)):
                d = v - ovals.get(k, 0)
                if d:
                    delta[k] = d
        if delta:
            out["sources"][src] = delta
    return out


def dump(path: str) -> str:
    """Write :func:`snapshot` as JSON; returns ``path``."""
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=2, sort_keys=True, default=str)
    return path


def reset():
    """Zero every metric series (objects and sources stay registered)."""
    with _LOCK:
        metrics = list(_METRICS.values())
    for m in metrics:
        m.reset()
