"""repro_torch.obs — the port's telemetry: one registry, four layers.

  * **metrics** (:mod:`repro_torch.obs.metrics`) — process-wide counters,
    gauges and fixed-bucket histograms with labels, snapshot / reset /
    diff, and read-time *sources* folding the older counter surfaces in
    (the circuit breaker, the faults fire-log, live engines' stats);
  * **tracing** (:mod:`repro_torch.obs.trace`) — context-scoped
    ``obs.trace()`` spans through the serving request lifecycle,
    exportable as Chrome-trace / Perfetto JSON or JSONL via :func:`export`;
    while a tracer is active the engine records queue wait, TTFT and TPOT
    into ``serving/latency/*`` histograms;
  * **dispatch explainability** (:mod:`repro_torch.obs.explain`) — every
    kernel-routing decision records the rule that accepted or declined it;
    :func:`explain` reports them;
  * **numerics health** (:mod:`repro_torch.obs.numerics_health`) — sampled
    underflow-risk probes per contraction, off by default
    (``NumericsConfig.monitor`` / ``REPRO_MONITOR``).

The JAX package's ``repro.obs``, with its series names and snapshot
layout.  Importing this package reads no device.
"""
from __future__ import annotations

import contextlib

from . import metrics
from .explain import report as _explain_report
from .explain import reset as _explain_reset
from .trace import Tracer, current as current_tracer, last as last_tracer
from .trace import trace  # the context manager (shadows the submodule name;
#                           ``from repro_torch.obs.trace import ...`` still
#                           works)

__all__ = ["metrics", "trace", "Tracer", "current_tracer", "last_tracer",
           "export", "snapshot", "diff", "reset", "explain",
           "add_cli_flags", "cli_session"]


def snapshot(include_sources: bool = True) -> dict:
    """Everything the registry knows, plus the folded sources."""
    return metrics.snapshot(include_sources=include_sources)


def diff(new: dict, old: dict) -> dict:
    return metrics.diff(new, old)


def reset():
    """Zero every metric series and forget recorded dispatch decisions."""
    metrics.reset()
    _explain_reset()


def explain(reset: bool = False):
    """The dispatch-explainability report: every recorded routing
    decision with the rule that made it (:mod:`repro_torch.obs.explain`)."""
    return _explain_report(reset=reset)


def export(path: str, tracer: Tracer | None = None) -> str:
    """Write the active (or most recently exited) tracer's events to
    ``path`` — Chrome-trace JSON, or JSONL for ``.jsonl`` paths."""
    tr = tracer if tracer is not None else last_tracer()
    if tr is None:
        raise RuntimeError(
            "no tracer to export: run inside repro_torch.obs.trace() first")
    return tr.export(path)


# ------------------------------------------------------ default sources
#
# The older counter surfaces, folded into snapshot() at read time.  The
# imports stay inside the closures: registering costs nothing.  The engine
# registers its own source, ``serving/engine``, when it is imported.

def _guard_source() -> dict:
    from repro_torch.kernels import guard
    return dict(guard.counters())


def _faults_source() -> dict:
    from repro_torch import faults
    plan = faults.active()
    out: dict[str, int] = {}
    if plan is not None:
        for site, _idx in plan.log:
            out[site] = out.get(site, 0) + 1
    return out


metrics.register_source("kernels/guard", _guard_source)
metrics.register_source("faults/fired", _faults_source)


# ----------------------------------------------------------- CLI surface

def add_cli_flags(parser):
    """``--trace`` / ``--metrics-out`` for the launch CLIs."""
    parser.add_argument(
        "--trace", default="", metavar="PATH",
        help="run under repro_torch.obs.trace() and export the request and "
             "step spans to PATH as Chrome-trace/Perfetto JSON (.jsonl for "
             "one event per line)")
    parser.add_argument(
        "--metrics-out", default="", metavar="PATH",
        help="write a repro_torch.obs metrics snapshot (counters, latency "
             "histograms, folded sources) to PATH as JSON after the run")


@contextlib.contextmanager
def cli_session(args):
    """Shared ``--trace``/``--metrics-out`` scope: run the body under a
    tracer when requested; afterwards export the trace, dump the metrics
    snapshot, and print the dispatch-explain summary."""
    tracing = bool(getattr(args, "trace", ""))
    metrics_out = getattr(args, "metrics_out", "")
    scope = trace() if tracing else contextlib.nullcontext()
    with scope:
        yield
    if not tracing and not metrics_out:
        return
    if tracing:
        tr = last_tracer()
        tr.export(args.trace)
        print(f"telemetry: trace -> {args.trace} "
              f"({len(tr.events)} events)", flush=True)
    if metrics_out:
        metrics.dump(metrics_out)
        print(f"telemetry: metrics -> {metrics_out}", flush=True)
    rep = explain()
    print(f"dispatch explain: {rep.n_fused} fused / "
          f"{rep.n_fallback} fallback decisions", flush=True)
    for line in rep.lines()[:12]:
        print(f"  {line}", flush=True)
