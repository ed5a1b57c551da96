"""One run of one cell: set-up, the measured window, the correctness check,
and the result's line.

A traced run (``--trace 1``) measures the same window as an untraced one,
with the program's ``obs`` spans on and the profiler off, and reads the
metrics of the host's clock and spans there; a profiled window of
``TRACE_S`` seconds follows it, from which the metrics of the device are
read: the profiler slows the host (PERF.md gives by how much).

The program under test is ``repro_torch``: its ``Engine`` (``add_request``
and ``step``) for a serving cell, ``launch/step.py::make_train_step`` for a
training cell, each at the port's defaults.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from dataclasses import dataclass

import torch

from . import check, measure, spec, traffic, weights
from .trace import Profiler, Recorder, idle_gaps, request_events, spans_of


@dataclass
class Run:
    """What the metric readers read."""
    kind: str
    conf: dict
    mix: dict
    window: tuple = (0.0, 0.0)     # the measured window
    trace_window: tuple = None     # the profiled window of a traced run
    setup_s: float = 0.0
    loop: object = None            # serve.ServeLoop
    train_steps: list = None       # (end, tokens) of each window step
    trace_steps: list = None       # the same in the profiled window
    spans: list = ()
    req_events: list = ()
    device: object = None          # trace.DeviceTrace
    recorder: Recorder = None
    graph_replays: int = 0
    t_start: float = 0.0           # the process's start, host clock
    phases: dict = None            # seconds of each phase of the run

    def phase(self, name: str) -> None:
        """Close the phase ``name`` at the current time."""
        if self.phases is None:
            self.phases = {}
        now = time.perf_counter()
        self.phases[name] = now - self._last if self.phases else (
            now - self.t_start)
        self._last = now


# seconds of the profiled window of a traced run
TRACE_S = 20.0


def port_config(conf: dict, cfg=None):
    """The port's configuration the file names (default: the registry's
    entry ``registry``), held to the file by the module of its family
    (``portbench/families/<family>.py``); the port's family and the
    file's have to be one."""
    if cfg is None:
        from repro_torch.configs import get_config
        cfg = get_config(conf["registry"])
    fam = spec.family(cfg.family)
    if conf["family"] != cfg.family:
        raise RuntimeError(f"{cfg.name}: the port's family {cfg.family!r} "
                           f"differs from the benchmark's file: "
                           f"{conf['family']!r}")
    return fam.port_config(conf, cfg)


def _params(conf, cfg, seed, device):
    from repro_torch.models import get_model
    weights.check_layout(conf, get_model(cfg).init(0, "meta"))
    return weights.make(conf, seed, device)


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ------------------------------------------------------------ serving

def _serve(cell, seed, seconds, trace, device, cfg, run, fault=None,
           control=False):
    from repro_torch import obs
    from repro_torch.serving import Engine
    from .serve import ServeLoop
    conf, mix = cell.conf, cell.mix
    run.phase("imports")
    params = _params(conf, cfg, seed, device)
    run.phase("weights")
    engine = Engine(cfg, params, device=device, **mix["engine"])
    run.phase("engine")
    if fault is not None:
        fault(engine)
    sched = traffic.schedule(mix, seed, conf["vocab_size"])
    loop = ServeLoop(engine, sched)
    run.loop = loop
    loop.prewarm(traffic.warm_prompts(mix, seed, conf["vocab_size"]))
    run.phase("prewarm")
    prof = Profiler() if trace and device.type == "cuda" else None
    replays0 = [0]
    out = {}

    def on_edge(i):
        if i == 0:
            run.phase("warm-up")
            run.setup_s = time.perf_counter() - run.t_start
        elif i == 1:
            run.phase("window")
            if trace:
                run.recorder.on = True
                replays0[0] = engine.stats()["graph_replays"]
                if prof is not None:
                    prof.start()
        else:
            run.recorder.on = False
            if prof is not None:
                out["device"] = prof.stop()
            run.graph_replays = (engine.stats()["graph_replays"]
                                 - replays0[0])
            run.phase("traced window")

    windows = [seconds] + ([min(seconds, TRACE_S)] if trace else [])
    with (obs.trace() if trace else _null()) as tr:
        got = loop.run(mix["warmup_s"], windows, on_edge)
    run.window = got[0]
    run.device = out.get("device")
    if trace:
        run.trace_window = got[1]
        run.spans, run.req_events = spans_of(tr), request_events(tr)
    stats = engine.stats()
    peak = _peak(device)
    t0, t1 = run.window
    arrived = [s for s in loop.sent.values() if t0 <= s.due < t1]
    failed = sum(1 for s in loop.sent.values()
                 if s.finish not in (None, "length", "stop"))
    failed += loop.add_failures
    samples = [(sched.requests[s.index].prompt, s.tokens)
               for s in check.sample_finished(
                   list(loop.sent.values()), seed, mix["check"]["tokens"],
                   mix["check"]["requests"])]
    loop.engine = None
    del engine, params
    _free()
    w = weights.make(conf, seed, device)
    values = {"served_gap": check.served_gap(w, conf, samples, device)
              if samples else math.inf}

    def backlog(t):
        return sum(1 for s in loop.sent.values()
                   if s.due <= t and not (s.times and s.times[0] <= t))

    info = {"preemptions": stats.get("preemptions"),
            "backlog": [backlog(t0), backlog((t0 + t1) / 2), backlog(t1)],
            "samples": len(samples),
            "compared_tokens": sum(len(t) for _, t in samples)}
    if control:
        info["control"] = {"served_gap": check.control_gap(w, conf, samples,
                                                           device)}
    del w
    _free()
    run.phase("check")
    return values, len(arrived) + loop.add_failures, failed, peak, info


# ------------------------------------------------------------ training

def _train(cell, seed, seconds, trace, device, cfg, run, fault=None,
           control=False):
    from repro_torch import obs
    from repro_torch.launch.step import make_train_step
    from repro_torch.optim import adamw
    conf, mix = cell.conf, cell.mix
    opt = adamw.OptConfig()
    bad = {k: (v, getattr(opt, k)) for k, v in mix["opt"].items()
           if getattr(opt, k) != v}
    if bad:
        raise RuntimeError(f"the port's default OptConfig differs from the "
                           f"mix's: {bad}")
    ref_steps = getattr(spec.family(conf["family"]), "train_steps", None)
    if ref_steps is None:
        raise RuntimeError(f"portbench/families/{conf['family']}.py has no "
                           f"train_steps: the family has no training "
                           f"reference")
    V = conf["vocab_size"]
    run.phase("imports")
    params = _params(conf, cfg, seed, device)
    run.phase("weights")
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    del params
    step = make_train_step(cfg, opt)
    if fault is not None:
        step = fault(step)
    prog = {"losses": []}
    for i in (1, 2, 3):
        state, met = step(state, traffic.train_batch(mix, seed, i, V,
                                                     device))
        prog["losses"].append(float(met["loss"]))
        if i == 1:
            prog["grad1"] = {k: float(m.norm()) / (1 - opt.b1) for k, m in
                             weights.leaves(state["opt"]["m"]).items()}
    w0 = weights.make(conf, seed, device)
    p0 = weights.leaves(w0)
    prog["change"] = {k: float((p - p0[k]).norm()) for k, p in
                      weights.leaves(state["params"]).items()}
    del w0, p0
    _free()
    run.phase("first steps")
    prof = Profiler() if trace and device.type == "cuda" else None
    i, failed = 3, 0
    tok_per_step = mix["batch"] * mix["seq"]
    windows = [seconds] + ([min(seconds, TRACE_S)] if trace else [])
    with (obs.trace() if trace else _null()) as tr:
        run.setup_s = time.perf_counter() - run.t_start
        for w, length in enumerate(windows):
            if w == 1:
                run.recorder.on = True
                if prof is not None:
                    prof.start()
            steps = []
            t0 = time.perf_counter()
            while True:
                i += 1
                with (tr.span("portbench.batch") if tr else _null()):
                    batch = traffic.train_batch(mix, seed, i, V, device)
                with (tr.span("portbench.train_step") if tr else _null()):
                    state, met = step(state, batch)
                    loss = float(met["loss"])
                now = time.perf_counter()
                failed += not math.isfinite(loss)
                steps.append((now, tok_per_step))
                if now >= t0 + length:
                    break
            if w == 0:
                run.window, run.train_steps = (t0, steps[-1][0]), steps
                run.phase("window")
            else:
                run.recorder.on = False
                if prof is not None:
                    run.device = prof.stop()
                run.trace_window, run.trace_steps = (t0, steps[-1][0]), steps
                run.phase("traced window")
    steps = run.train_steps
    if trace:
        run.spans = spans_of(tr)
    peak = _peak(device)
    del state, met, batch
    _free()
    w0 = weights.make(conf, seed, device)
    batches = [traffic.train_batch(mix, seed, j, V, device) for j in (1, 2, 3)]
    ref = ref_steps(weights.leaves(w0), conf, batches, mix)
    info = {}
    if control:
        low = ref_steps(weights.leaves(w0), conf, batches, mix,
                        precision="bf16")
        info["control"] = check.train_gaps(low, ref)
    del w0, batches
    _free()
    run.phase("check")
    info["program"] = {k: prog[k] for k in ("losses",)}
    info["reference"] = {"losses": ref["losses"]}
    return check.train_gaps(prog, ref), len(steps), failed, peak, info


# -------------------------------------------------------------- common

class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _breakdown(run) -> dict | None:
    """The device's ten costliest operations and its ten longest idle
    gaps, each named by the innermost span the host was in."""
    if run.device is None or not run.device.ok:
        return None
    t0, t1 = run.trace_window
    by_name: dict = {}
    ivs = []
    for n, s, e in run.device.events:
        if e <= t0 or s >= t1:
            continue
        by_name[n] = by_name.get(n, 0.0) + (min(e, t1) - max(s, t0))
        ivs.append((s, e))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(ivs, t0, t1), key=lambda g: g[0] - g[1])[:10]

    def host(t):
        best = None
        for n, s, e, _ in run.spans:
            if s <= t <= e and (best is None or e - s < best[1]):
                best = (n, e - s)
        return best[0] if best else "host"

    return {"device_ops": [[n[:120], v] for n, v in ops],
            "idle_gaps": [[host((a + b) / 2), b - a] for a, b in gaps]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, cfg=None, fault=None, control=False) -> dict:
    """Run ``cell`` once and return the result's line as a dict.
    ``cfg``: the port's configuration (default: the registry's, held to
    the file); ``fault``: a test's hook that breaks the timed path."""
    device = torch.device(device)
    cfg = port_config(cell.conf, cfg)
    kind = cell.mix["kind"]
    run = Run(kind=kind, conf=cell.conf, mix=cell.mix, t_start=t_start)
    if trace:
        run.recorder = Recorder()
        run.recorder.install()
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    try:
        body = _serve if kind == "serve" else _train
        values, attempted, failed, peak, info = body(
            cell, seed, seconds, trace, device, cfg, run, fault, control)
    finally:
        if run.recorder is not None:
            run.recorder.uninstall()
    ok, checks = check.judge(values, cell.limits)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    if device.type == "cuda":
        from .hw import nvidia_smi
        dev.update(nvidia_smi(device.index or 0))
    if trace:
        dev["busy_s"] = measure.busy_seconds(run)
        dev["window_s"] = run.trace_window[1] - run.trace_window[0]
    result = {"correct": bool(ok and failed == 0), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        bd = _breakdown(run)
        if bd is not None:
            result["breakdown"] = bd
    if trace:
        # the end-to-end metrics in the measured window (spans on) and in
        # the profiled one, beside an untraced run's: what tracing costs
        profiled = dataclasses.replace(run, window=run.trace_window,
                                       train_steps=run.trace_steps)
        info["end_to_end"] = {
            m["name"]: [spec.reader(m["name"])(r) for r in (run, profiled)]
            for m in cell.end_to_end if m["name"] != "setup_s"}
    info["phases_s"] = run.phases
    result["info"] = info
    result["checks"] = checks
    return result
