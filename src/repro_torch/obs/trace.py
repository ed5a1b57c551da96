"""Context-scoped span tracing in the Chrome trace event format.

The JAX package's tracer, in the port.  ``trace()`` installs a
:class:`Tracer` for its dynamic extent (innermost wins, as with
``numerics.use`` and ``faults.use``); instrumented code asks
:func:`current` for the active tracer and does nothing when there isn't
one, so tracing off costs one thread-local read per instrumentation point
and no device work.

Events follow the Chrome trace event format (Perfetto and
``chrome://tracing`` load it):

  * ``span(name)`` — a ``ph:"X"`` complete event with microsecond
    ``ts``/``dur``; the context manager yields a mutable args dict, so
    annotations computed inside the block land on the exported event;
  * ``instant(name)`` — a ``ph:"i"`` thread-scoped instant;
  * ``async_begin/instant/end(name, id)`` — ``ph:"b"/"n"/"e"`` async events
    keyed by id: one per request, spanning its lifetime across engine
    steps.

**Span times are the host's clock.**  CUDA work is queued: a span around
kernel launches measures the host's enqueue time unless the span ends at a
sync.  The engine's ``decode.consume`` span ends after the token download,
which is the decode step's one sync, so it holds the wait for the device;
``decode`` (the dispatch) holds only the upload and the replay's enqueue.
A prefill span ends in the first-token read, which syncs too.

Export: :meth:`Tracer.export` writes ``{"traceEvents": [...]}`` JSON, or
one event per line when the path ends in ``.jsonl``.  The engine's latency
distributions (queue wait, TTFT, TPOT) are recorded straight into
``obs.metrics`` histograms while a tracer is active.

The clock is injectable (``Tracer(clock=...)``) so tests drive spans
deterministically; the default is ``time.perf_counter``.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

_TLS = threading.local()
_LAST_LOCK = threading.Lock()
_LAST = None


class Tracer:
    """An event buffer plus the clock it timestamps against."""

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._t0 = self._clock()
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}
        self.events: list[dict] = []

    def now(self) -> float:
        """Seconds on this tracer's clock — what instrumentation uses for
        latency arithmetic (monotonic; not wall time)."""
        return self._clock()

    def _ts(self) -> float:
        return (self._clock() - self._t0) * 1e6     # microseconds

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            return self._tids.setdefault(ident, len(self._tids))

    def _emit(self, ev: dict):
        with self._lock:
            self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "span", **args):
        """Complete-event span; yields the event's mutable args dict."""
        t0 = self._ts()
        a = dict(args)
        try:
            yield a
        finally:
            self._emit({"name": name, "cat": cat, "ph": "X", "ts": t0,
                        "dur": self._ts() - t0, "pid": 0,
                        "tid": self._tid(), "args": a})

    def instant(self, name: str, cat: str = "event", **args):
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self._ts(), "pid": 0, "tid": self._tid(),
                    "args": dict(args)})

    def async_begin(self, name: str, aid, cat: str = "request", **args):
        self._emit({"name": name, "cat": cat, "ph": "b", "id": aid,
                    "ts": self._ts(), "pid": 0, "tid": self._tid(),
                    "args": dict(args)})

    def async_instant(self, name: str, aid, cat: str = "request", **args):
        self._emit({"name": name, "cat": cat, "ph": "n", "id": aid,
                    "ts": self._ts(), "pid": 0, "tid": self._tid(),
                    "args": dict(args)})

    def async_end(self, name: str, aid, cat: str = "request", **args):
        self._emit({"name": name, "cat": cat, "ph": "e", "id": aid,
                    "ts": self._ts(), "pid": 0, "tid": self._tid(),
                    "args": dict(args)})

    def chrome(self) -> dict:
        """The buffer as a Chrome-trace/Perfetto JSON object."""
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the events to ``path``: Chrome-trace JSON, or JSONL (one
        event per line) when the path ends in ``.jsonl``."""
        path = str(path)
        if path.endswith(".jsonl"):
            with self._lock:
                events = list(self.events)
            with open(path, "w") as f:
                for ev in events:
                    f.write(json.dumps(ev, sort_keys=True, default=str))
                    f.write("\n")
        else:
            with open(path, "w") as f:
                json.dump(self.chrome(), f, sort_keys=True, default=str)
        return path


# ----------------------------------------------------------- the context

def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


@contextlib.contextmanager
def trace(tracer: Tracer | None = None, clock=None):
    """Install a tracer for the dynamic extent; yields it.  On exit the
    tracer becomes the process's *last* tracer so ``obs.export(path)``
    can write it out after the traced region ends."""
    global _LAST
    tr = tracer if tracer is not None else Tracer(clock=clock)
    st = _stack()
    st.append(tr)
    try:
        yield tr
    finally:
        st.pop()
        with _LAST_LOCK:
            _LAST = tr


def current() -> Tracer | None:
    """The innermost active tracer on this thread, or None — the gate
    every instrumentation point checks first."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


def last() -> Tracer | None:
    """The active tracer if any, else the most recently exited one."""
    cur = current()
    if cur is not None:
        return cur
    with _LAST_LOCK:
        return _LAST
