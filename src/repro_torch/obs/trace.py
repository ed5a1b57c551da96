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

**Span times are the host's clock; device edges are opt-in.**  CUDA work
is queued: a span around kernel launches measures the host's enqueue time
unless the span ends at a sync.  The engine's ``decode.consume`` span ends
after the token download, which is the decode step's one sync, so it holds
the wait for the device; ``decode`` (the dispatch) holds only the upload and
the replay's enqueue.  A prefill span ends in the first-token read, which
syncs too.  ``span(name, device=True)`` also records a timing
``torch.cuda.Event`` on the current stream at entry and at exit (when CUDA
is initialised and the stream is not capturing a graph): the device's edges
of the span's work, from when the stream reached the work queued before it
to when it finished the span's last.  The events go onto this tracer's
clock through an anchor: a clock reading, then an event recorded on the
idle stream.  On an NVIDIA H100 an event recorded at a known reading maps
to 1.7 us after it (median; a reading taken after waiting for the anchor
maps it ~20 us late).  The first device-edged span takes the anchor after
a ``synchronize``; later ones take a new one at most once a second, where
the stream is already idle, since the device's clock drifts from the
host's (on an NVIDIA H100, 4.7 parts per million behind
``time.perf_counter``: 240 us in 51 s).  Nothing waits for the events until
:meth:`Tracer.chrome` or :meth:`Tracer.export`, which synchronise once and
write the span's ``device_us: [start, end]`` arg, in microseconds from the
span's own ``ts``.  Spans without the flag, and every span where CUDA is
not in use, are exported byte for byte as before.

Export: :meth:`Tracer.export` writes ``{"traceEvents": [...]}`` JSON, or
one event per line when the path ends in ``.jsonl``.  The engine's latency
distributions (queue wait, TTFT, TPOT) are recorded straight into
``obs.metrics`` histograms while a tracer is active.

The clock is injectable (``Tracer(clock=...)``) so tests drive spans
deterministically; the default is ``time.perf_counter``.  So is the device
side of the edges (``Tracer(cuda=...)``, an object with :class:`_Cuda`'s
methods).
"""
from __future__ import annotations

import contextlib
import json
import threading
import time

# seconds after which a device-edged span takes a new anchor, where it can
REANCHOR_S = 1.0

_TLS = threading.local()
_LAST_LOCK = threading.Lock()
_LAST = None


class _Cuda:
    """The device side of device-edged spans: timing events on the current
    CUDA stream."""

    @staticmethod
    def ready() -> bool:
        """Whether an event can be recorded now: CUDA is initialised and
        the current stream is not capturing a graph."""
        import torch
        return (torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing())

    @staticmethod
    def record():
        import torch
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def idle() -> bool:
        """Whether the current stream has finished all its work."""
        import torch
        return torch.cuda.current_stream().query()

    @staticmethod
    def synchronize():
        import torch
        torch.cuda.synchronize()

    @staticmethod
    def seconds(a, b) -> float:
        """Device seconds from event ``a`` to event ``b`` (both done)."""
        return a.elapsed_time(b) * 1e-3


class Tracer:
    """An event buffer plus the clock it timestamps against."""

    def __init__(self, clock=None, cuda=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._t0 = self._clock()
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}
        self.events: list[dict] = []
        self._cuda = cuda if cuda is not None else _Cuda()
        self._anchor = None     # (event, clock reading at which it was done)
        self._pending: list = []   # (event dict, anchor, start, end)

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
    def span(self, name: str, cat: str = "span", device: bool = False,
             **args):
        """Complete-event span; yields the event's mutable args dict.
        ``device=True``: the span's work is queued on the current CUDA
        stream, and its device edges are recorded (module docstring)."""
        t0 = self._ts()
        a = dict(args)
        edge = self._edge() if device else None
        try:
            yield a
        finally:
            ev = {"name": name, "cat": cat, "ph": "X", "ts": t0,
                  "dur": self._ts() - t0, "pid": 0, "tid": self._tid(),
                  "args": a}
            if edge is not None and self._cuda.ready():
                with self._lock:
                    self._pending.append((ev, *edge, self._cuda.record()))
            self._emit(ev)

    def _edge(self):
        """``(anchor, start event)`` at a device-edged span's entry; None
        where no event can be recorded.  A new anchor where the last is
        ``REANCHOR_S`` old and the program has already waited for the
        stream's work."""
        cuda = self._cuda
        if not cuda.ready():
            return None
        if self._anchor is None:
            cuda.synchronize()
            self._anchor = self._take_anchor()
        elif (self._clock() - self._anchor[1] >= REANCHOR_S
              and cuda.idle()):
            self._anchor = self._take_anchor()
        return self._anchor, cuda.record()

    def _take_anchor(self):
        """The clock's reading, then an event recorded on the idle stream,
        which runs a launch's latency after it."""
        t = self._clock()
        return self._cuda.record(), t

    def _resolve(self):
        """Write ``device_us`` into the args of every device-edged span
        that has none yet (one synchronize)."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        self._cuda.synchronize()
        for ev, (anchor, t_anchor), start, end in pending:
            base = (t_anchor - self._t0) * 1e6 - ev["ts"]
            ev["args"]["device_us"] = [
                base + self._cuda.seconds(anchor, start) * 1e6,
                base + self._cuda.seconds(anchor, end) * 1e6]

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
        """The buffer as a Chrome-trace/Perfetto JSON object (device edges
        resolved)."""
        self._resolve()
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the events to ``path``: Chrome-trace JSON, or JSONL (one
        event per line) when the path ends in ``.jsonl``."""
        path = str(path)
        if path.endswith(".jsonl"):
            self._resolve()
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
