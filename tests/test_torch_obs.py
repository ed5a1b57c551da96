"""The port's telemetry (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU.

JAX's ``tests/test_obs.py`` is ported where it applies (registry
semantics, span nesting and export, the explain slugs, the monitor's probe
math, engine tracing, the CLI glue), and the port is held to the JAX
package bit for bit: metrics snapshots and diffs for the same operations;
trace exports on a synthetic clock; ``safe_exponent_range``; the probe
fractions on the same seeded operands, chosen so that their residuals stay
normal in f32 (XLA on the CPU flushes f32 subnormals, torch does not: that
case is pinned apart); and the engine's trace events (names, phases,
request ids and arguments, times aside) for the same workload.

Not ported: JAX's ``test_explain_rule_slugs_documented`` reads
``docs/architecture.md``, which describes the JAX package (the port's slugs
are held to ``kernels/dispatch.py``'s docstring instead);
``test_monitor_off_leaves_graph_callback_free`` and
``test_tracing_off_is_inert_and_adds_no_traces`` count jaxpr callbacks and
jit traces, which the eager port has none of (their port counterparts
count probes and latency samples).
"""
import argparse
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics as jnumerics  # noqa: E402
from repro.core.policy import get_policy as jget_policy  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import numerics_health as jnh  # noqa: E402
from repro.obs.explain import RULES as JRULES  # noqa: E402
from repro.obs.trace import Tracer as JTracer  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch import numerics, obs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import theory  # noqa: E402
from repro_torch.core.policy import get_policy, policy_mm  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs import numerics_health as nh  # noqa: E402
from repro_torch.obs.explain import RULES, record  # noqa: E402
from repro_torch.obs.trace import Tracer, current, last, trace  # noqa: E402
from repro_torch.serving import Engine, SamplingParams  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
ARCH = "qwen3-0.6b"


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(ARCH), params


# ============================================================== registry

def test_counter_labels_and_total():
    c = metrics.counter("test/obs/counter")
    c.reset()
    c.inc(kernel="matmul")
    c.inc(2, kernel="paged")
    c.inc()
    assert c.value(kernel="matmul") == 1 and c.value(kernel="paged") == 2
    assert c.value() == 1 and c.total() == 4
    items = c.items()
    assert items["test/obs/counter{kernel=paged}"] == 2
    assert items["test/obs/counter"] == 1
    inc = c.series(kernel="paged")     # the key resolved once
    inc()
    inc(3)
    assert c.value(kernel="paged") == 6
    c.reset()
    inc()                              # still bound after a reset
    assert c.items() == {"test/obs/counter{kernel=paged}": 1}


def test_gauge_running_extrema():
    g = metrics.gauge("test/obs/gauge")
    g.reset()
    g.set_min(-3.0)
    g.set_min(-1.0)
    g.set_max(5.0)
    g.set_max(2.0)
    assert g.value() == 5.0
    g.set(7.0, policy="x")
    assert g.value(policy="x") == 7.0


def test_histogram_buckets_count_sum_percentile():
    h = metrics.histogram("test/obs/hist", buckets=(1.0, 2.0, 4.0))
    h.reset()
    for v in (0.5, 0.5, 1.5, 3.0, 9.0):
        h.observe(v)
    assert h.count() == 5 and h.sum() == pytest.approx(14.5)
    assert h.items()["test/obs/hist"]["counts"] == [2, 1, 1, 1]
    assert 1.0 <= h.percentile(50) <= 2.0
    assert h.percentile(100) == 4.0
    assert metrics.histogram("test/obs/empty",
                             buckets=(1.0,)).percentile(99) == 0.0
    h2 = metrics.histogram("test/obs/hist2", buckets=(1.0, 2.0))
    h2.reset()
    h2.observe(0.5, policy="a")
    h2.observe(1.5, policy="b")
    assert h2.count(policy="a") == 1 and h2.count() == 2


def test_registry_kind_conflict_raises():
    metrics.counter("test/obs/kindconflict")
    with pytest.raises(TypeError):
        metrics.gauge("test/obs/kindconflict")


def test_bucket_edges_equal_jax():
    assert metrics.TIME_BUCKETS_S == jmetrics.TIME_BUCKETS_S
    assert metrics.FRACTION_BUCKETS == jmetrics.FRACTION_BUCKETS


def _apply(m, ops):
    for kind, name, v, labels in ops:
        if kind == "c":
            m.inc(name, v, **labels)
        elif kind == "g":
            m.set_gauge(name, v, **labels)
        elif kind == "gmin":
            m.gauge(name).set_min(v, **labels)
        elif kind == "h":
            m.observe(name, v, **labels)
        else:
            m.observe(name, v, buckets=m.FRACTION_BUCKETS, **labels)


def _seeded_ops(seed, n=300):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = ("c", "g", "gmin", "h", "f")[rng.integers(0, 5)]
        name = f"test/parity/{kind}{rng.integers(0, 3)}"
        labels = ({} if rng.random() < 0.3 else
                  {"site": ("pdot", "mm")[rng.integers(0, 2)],
                   "policy": ("x3", "x6")[rng.integers(0, 2)]})
        v = float(rng.random() * 10.0 ** rng.integers(-6, 2))
        out.append((kind, name, v if kind != "c" else int(v * 7) + 1,
                    labels))
    return out


def _ours(snap):
    return {sec: {k: v for k, v in snap[sec].items()
                  if k.startswith("test/parity/")}
            for sec in ("counters", "gauges", "histograms")}


def test_snapshot_and_diff_equal_jax():
    """The same seeded operations on both registries give the same
    snapshot (series names, label rendering, bucket counts, sums) and the
    same diff, bit for bit."""
    for m in (metrics, jmetrics):
        _apply(m, [("c", f"test/parity/c{i}", 0, {}) for i in range(3)])
        m.reset()
    a, b = _seeded_ops(0), _seeded_ops(1)
    _apply(metrics, a)
    _apply(jmetrics, a)
    old_t = metrics.snapshot(include_sources=False)
    old_j = jmetrics.snapshot(include_sources=False)
    _apply(metrics, b)
    _apply(jmetrics, b)
    new_t = metrics.snapshot(include_sources=False)
    new_j = jmetrics.snapshot(include_sources=False)
    assert json.dumps(_ours(new_t), sort_keys=True) == \
        json.dumps(_ours(new_j), sort_keys=True)
    assert _ours(new_t)["histograms"]
    dt, dj = metrics.diff(new_t, old_t), jmetrics.diff(new_j, old_j)
    assert json.dumps(_ours(dt), sort_keys=True) == \
        json.dumps(_ours(dj), sort_keys=True)


def test_default_sources_present():
    import repro_torch.serving.engine  # noqa: F401  registers its source
    snap = obs.snapshot()
    assert "allowed" in snap["sources"]["kernels/guard"]
    assert "faults/fired" in snap["sources"]
    assert "serving/engine" in snap["sources"]


def test_thread_safety():
    c = metrics.counter("test/obs/threads")
    c.reset()
    h = metrics.histogram("test/obs/threadhist", buckets=(0.5, 1.0))
    h.reset()

    def work():
        for _ in range(1000):
            c.inc(site="t")
            h.observe(0.25)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert c.value(site="t") == 8000 and h.count() == 8000


def test_reset_keeps_objects_and_sources():
    c = metrics.counter("test/obs/reset")
    c.inc(9)
    obs.reset()
    assert c.value() == 0
    c.inc()
    assert metrics.counter("test/obs/reset") is c
    assert "kernels/guard" in obs.snapshot()["sources"]


# =============================================================== tracing

def test_span_nesting_with_synthetic_clock():
    ticks = iter(range(100))
    tr = Tracer(clock=lambda: next(ticks))
    with tr.span("outer") as args:
        with tr.span("inner"):
            pass
        args["occupancy"] = 3
    inner, outer = tr.events
    assert inner["name"] == "inner" and outer["name"] == "outer"
    assert outer["ph"] == "X" and outer["dur"] > inner["dur"]
    assert outer["args"]["occupancy"] == 3
    assert inner["ts"] >= outer["ts"]


def test_trace_context_precedence_and_last():
    assert current() is None
    with trace() as t1:
        assert current() is t1
        with trace() as t2:
            assert current() is t2
        assert current() is t1
    assert current() is None
    assert last() is t1


def _script(tr):
    tr.async_begin("request", 7, prompt_len=4)
    with tr.span("engine.step", cat="engine", clock=1) as sp:
        tr.instant("decode-fault", slots=[0])
        with tr.span("decode", cat="engine", batch=2):
            pass
        sp["occupancy"] = 2
    tr.async_instant("admitted", 7, clock=1)
    tr.async_end("request", 7, finish="length", tokens=8)


def test_export_equals_jax_on_a_synthetic_clock(tmp_path, monkeypatch):
    """The same events on the same clock export to the same bytes, as
    Chrome-trace JSON and as JSONL."""
    mine = Tracer(clock=iter(range(100)).__next__)
    theirs = JTracer(clock=iter(range(100)).__next__)
    _script(mine)
    _script(theirs)
    for name in ("t.json", "t.jsonl"):
        a, b = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
        mine.export(str(a))
        theirs.export(str(b))
        assert a.read_bytes() == b.read_bytes()
    doc = json.loads((tmp_path / "port_t.json").read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    for ev in evs:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(ev)
    by_ph = {ev["ph"]: ev for ev in evs}
    assert by_ph["b"]["id"] == by_ph["e"]["id"] == 7
    assert by_ph["e"]["args"]["finish"] == "length"
    lines = [json.loads(ln) for ln in
             (tmp_path / "port_t.jsonl").read_text().splitlines()]
    assert lines == evs
    import sys
    monkeypatch.setattr(sys.modules["repro_torch.obs.trace"], "_LAST", None)
    with pytest.raises(RuntimeError, match="no tracer"):
        obs.export(str(tmp_path / "none.json"))


class _StandInCuda:
    """The device side of device-edged spans on a synthetic device clock:
    each ``record`` returns the next of ``times`` (device seconds), each
    ``idle`` the next of ``idle``."""

    def __init__(self, times, ready=True, idle=()):
        self.times, self.ok, self.idles = iter(times), ready, iter(idle)
        self.syncs = 0

    def ready(self):
        return self.ok

    def idle(self):
        return next(self.idles)

    def record(self):
        return next(self.times)

    def synchronize(self):
        self.syncs += 1

    @staticmethod
    def seconds(a, b):
        return b - a


def test_device_edges_resolve_onto_the_tracers_clock():
    """The anchor's reading (just before its event) maps the device clock
    onto the host's; a span a second or more after the anchor takes a new
    one where the stream is idle; ``device_us`` is microseconds from the
    span's own ``ts``; one synchronize resolves every pending span, and a
    second export waits for nothing."""
    host = iter([0.0,            # the tracer's t0
                 1.0,            # "decode" enters
                 2.0,            # the first anchor's reading
                 2.2,            # "decode" exits
                 2.5, 2.5,       # the next enters, under a second after
                 2.8,            # the anchor, and exits
                 6.0,            # "prefill" enters
                 6.0,            # 4 s since the anchor: the stream is idle
                 6.5,            # the second anchor's reading
                 7.0,            # "prefill" exits
                 8.0, 9.0,       # a span without the flag
                 10.0, 10.0,     # "decode" enters: the stream is busy
                 11.0])          # and exits
    cuda = _StandInCuda([100.0,            # the first anchor
                         100.5, 103.0,     # the first decode's edges
                         103.0, 103.5,     # the next one's, queued
                         104.4,            # the second anchor
                         104.5, 104.75,    # prefill's edges
                         108.0, 108.5],    # the last decode's edges
                        idle=[True, False])
    tr = Tracer(clock=host.__next__, cuda=cuda)
    for _ in range(2):
        with tr.span("decode", cat="engine", device=True, batch=2):
            pass
    with tr.span("prefill", device=True) as a:
        a["padded"] = 16
    with tr.span("host"):
        pass
    with tr.span("decode", cat="engine", device=True, batch=1):
        pass
    assert cuda.syncs == 1
    assert all("device_us" not in e["args"] for e in tr.events)
    dec, dec2, pre, host_only, dec3 = tr.chrome()["traceEvents"]
    assert cuda.syncs == 2
    assert dec["ts"] == 1e6 and dec["dur"] == pytest.approx(1.2e6)
    # device 100.5 s is host 2.0 + 0.5 = 2.5 s: 1.5 s after ts
    assert dec["args"] == {"batch": 2, "device_us": [1.5e6, 4e6]}
    assert dec2["args"]["device_us"] == pytest.approx([2.5e6, 3e6])
    # on the second anchor: device 104.5 s is host 6.5 + 0.1 = 6.6 s
    assert pre["args"] == {"padded": 16,
                           "device_us": pytest.approx([0.6e6, 0.85e6])}
    assert host_only["args"] == {}
    # still on the second anchor: 108.0 s is host 10.1 s
    assert dec3["args"]["device_us"] == pytest.approx([0.1e6, 0.6e6])
    tr.chrome()
    assert cuda.syncs == 2


def test_device_flag_without_cuda_exports_the_same_bytes(tmp_path):
    """A span that asks for device edges where none can be recorded (no
    CUDA here; a stand-in that is not ready) exports the bytes of a span
    without the flag, as JSON and as JSONL."""
    def script(tr, **flag):
        with tr.span("decode", cat="engine", batch=2, **flag):
            tr.instant("tick")

    plain = Tracer(clock=iter(range(100)).__next__)
    script(plain)
    for cuda in (None, _StandInCuda([], ready=False)):
        flagged = Tracer(clock=iter(range(100)).__next__, cuda=cuda)
        script(flagged, device=True)
        for name in ("t.json", "t.jsonl"):
            a, b = tmp_path / f"plain_{name}", tmp_path / f"flag_{name}"
            plain.export(str(a))
            flagged.export(str(b))
            assert a.read_bytes() == b.read_bytes()


# ====================================================== dispatch explain

def test_rules_are_the_ports_slugs_and_documented():
    """Exactly the slugs the port can emit, a subset of JAX's; each is
    named in ``kernels/dispatch.py``'s docstring or the explain module's,
    and JAX's other slugs are listed as never emitted."""
    assert set(RULES) == {"fused", "plain-policy", "policy-ineligible",
                          "hatch-disabled", "shape-unsupported",
                          "below-min-dim", "mesh-declined", "breaker-open",
                          "kernel-failure"}
    assert set(RULES) <= set(JRULES)
    import sys
    doc = (dispatch.__doc__ or "") + sys.modules[
        "repro_torch.obs.explain"].__doc__
    for slug in RULES:
        assert f"``{slug}``" in doc, slug
    for slug in set(JRULES) - set(RULES):
        assert f"``{slug}``" in sys.modules["repro_torch.obs.explain"].__doc__
    assert "fell back" not in RULES["kernel-failure"]


def test_explain_names_declining_rule_per_route():
    obs.reset()
    a, b = torch.from_numpy(_rand((64, 64), 1)), \
        torch.from_numpy(_rand((64, 64), 2))
    small = torch.ones(8, 8)
    with numerics.use(policy="tcec_bf16x3"):
        policy_mm(a, b)                               # fused
    with numerics.use(policy="tcec_bf16x3", min_dim=16):
        policy_mm(small, small)                       # below-min-dim
    with numerics.use(policy="tcec_bf16x3", enabled=False):
        policy_mm(a, b)                               # hatch-disabled
    with numerics.use(policy="fp32"):
        policy_mm(a, b)             # plain: never reaches dispatch
    policy_mm(a, b, "fp16_markidis")                  # policy-ineligible
    rep = obs.explain()
    rules = {e["rule"] for e in rep.entries}
    assert rules == {"fused", "below-min-dim", "hatch-disabled",
                     "policy-ineligible"}, rep.entries
    assert rep.n_fused == 1 and rep.n_fallback == 3
    for e in rep.entries:
        assert e["backend"] == "cpu" and e["kernel"] == "matmul"
    routes = metrics.counter("kernels/dispatch/route")
    assert routes.value(kernel="matmul", route="fused") == 1
    assert routes.value(kernel="matmul", route="fallback") == 3
    declines = metrics.counter("kernels/dispatch/decline")
    assert declines.value(kernel="matmul", rule="below-min-dim") == 1
    assert str(rep).startswith("dispatch explain:")


def test_explain_attention_paged_and_epilogue_routes():
    obs.reset()
    q, k = torch.from_numpy(_rand((1, 8, 4, 16), 3)), \
        torch.from_numpy(_rand((1, 8, 2, 16), 4))
    assert dispatch.attention(q, k, k, policy="tcec_bf16x6") is not None
    assert dispatch.attention(q, k[..., :8], k, policy="tcec_bf16x6") is None
    with numerics.use(paged_attention=False):
        assert not dispatch.attention_decode_eligible(
            q[:, 0], k, k, policy="tcec_bf16x6")
    pol16 = get_policy("fp16_markidis")
    with numerics.use(fuse_epilogue=True):
        assert not dispatch.epilogue_eligible(pol16, device="cpu")
        assert dispatch.epilogue_eligible(get_policy("tcec_bf16x6"),
                                          device="cpu")
    got = {(e["kernel"], e["rule"]) for e in obs.explain().entries}
    assert got == {("attention", "fused"),
                   ("attention", "shape-unsupported"),
                   ("paged_attention", "hatch-disabled"),
                   ("epilogue", "policy-ineligible"), ("epilogue", "fused")}


def test_explain_records_per_call_and_plain_routes_as_fused(smoke):
    """The port records every eager call: a prefill of the smoke model (L
    layers) records 7L + 1 kernel-1 and L kernel-2 decisions, all fused,
    whether the kernels' route runs on the CPU, under ``interpret`` or
    under ``use_plain()``; an ``enabled=False`` prefill records
    ``hatch-disabled`` for each call instead, and 2L more for the two
    products of each layer's declined attention (the pdot composition)."""
    _, _, cfg, params = smoke
    cfg = cfg.replace(policy="tcec_bf16x6")
    model = get_model(cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    L = cfg.n_layers
    for scope in ("plain-cpu", "interpret", "use_plain", "disabled"):
        obs.reset()
        with (numerics.use(interpret=True) if scope == "interpret" else
              dispatch.use_plain() if scope == "use_plain" else
              numerics.use(enabled=False) if scope == "disabled" else
              numerics.use()):
            model.prefill(params, toks)
        by = {}
        for e in obs.explain().entries:
            by[(e["kernel"], e["rule"])] = \
                by.get((e["kernel"], e["rule"]), 0) + e["count"]
        rule = "hatch-disabled" if scope == "disabled" else "fused"
        extra = 2 * L if scope == "disabled" else 0
        assert by == {("matmul", rule): 7 * L + 1 + extra,
                      ("attention", rule): L}, (scope, by)


def test_explain_report_reset_and_overflow(monkeypatch):
    obs.reset()
    record("cpu", "matmul", "tcec_bf16x3", (1, 2), "below-min-dim")
    assert obs.explain(reset=True).n_fallback == 1
    assert obs.explain().entries == []
    with pytest.raises(ValueError, match="unknown dispatch rule"):
        record("cpu", "matmul", "tcec_bf16x3", (), "not-a-rule")
    import sys
    monkeypatch.setattr(sys.modules["repro_torch.obs.explain"],
                        "MAX_KEYS", 2)
    for i in range(4):
        record("cpu", "matmul", "x6", (i,), "fused")
    assert len(obs.explain().entries) == 2
    assert metrics.counter("kernels/dispatch/explain_overflow").value() == 2


# ======================================================== numerics health

def test_safe_exponent_range_pins_theory_and_equals_jax():
    cases = {("bfloat16", 8): (-110, 127), ("float16", 11): (-1, 15),
             ("float16", 0): (10, 26)}
    fmts = {"bfloat16": theory.BF16, "float16": theory.FP16}
    for (dtype, sb), expected in cases.items():
        lo, hi = nh.safe_exponent_range(dtype, sb)
        assert (lo, hi) == expected == jnh.safe_exponent_range(dtype, sb)
        assert theory.p_underflow_gradual(lo, fmts[dtype], sb) == 0.0
        assert theory.p_underflow_gradual(lo - 1, fmts[dtype], sb) > 0.0
    for dtype in ("float8_e4m3fn", "float8_e5m2"):
        for sb in (0, 3, 4):
            assert nh.safe_exponent_range(dtype, sb) == \
                jnh.safe_exponent_range(dtype, sb)


_PROBE_CASES = [  # policy, operand scale (residuals normal in f32)
    ("tcec_bf16x3", 1.0), ("tcec_bf16x6", 2.0 ** -100),
    ("fp16_halfhalf", 1.0), ("fp16_halfhalf", 2.0 ** -13),
    ("fp16_markidis", 2.0 ** 10), ("fp16_halfhalf", 2.0 ** -20)]


@pytest.mark.parametrize("policy,scale", _PROBE_CASES)
def test_probe_values_equal_jax(policy, scale):
    """The six probe values of one contraction, bit for bit, on seeded
    operands whose residuals stay normal in f32."""
    a = _rand((48, 64), 5, scale)
    b = _rand((64, 40), 6)
    mine = nh.probe(torch.from_numpy(a), torch.from_numpy(b),
                    get_policy(policy))
    jpol = jget_policy(policy)
    sa, ra, ha = jnh._operand_probe(jnp.asarray(a), jpol)
    sb, rb, hb = jnh._operand_probe(jnp.asarray(b), jpol)
    tiny = jnp.float32(2.0 ** -(jnh._FMT[jpol.dtype].bias - 1))
    pf = jnp.maximum(jnh._product_underflow(ra, hb, tiny),
                     jnh._product_underflow(rb, ha, tiny))
    theirs = [jnp.maximum(sa["u"], sb["u"]), jnp.maximum(sa["gu"], sb["gu"]),
              jnp.maximum(sa["oob"], sb["oob"]), pf,
              jnp.minimum(sa["emin"], sb["emin"]),
              jnp.maximum(sa["emax"], sb["emax"])]
    assert mine == [float(np.float32(x)) for x in theirs]


def test_probe_on_f32_subnormal_residuals_differs_from_jax():
    """Operands near 2^-120 under bf16: their residuals (~2^-128) are
    subnormal in f32.  XLA on the CPU flushes them to zero, so JAX sees no
    nonzero residual (u = gu = 0); torch keeps them, and the ones whose
    scaled cast lands below bf16's smallest normal count (gu > 0).  The
    exponent indicator, read from the operand itself, agrees."""
    a = _rand((32, 32), 7, 2.0 ** -120)
    pol = get_policy("tcec_bf16x6")
    mine, _, _ = nh._operand_probe(torch.from_numpy(a), pol)
    theirs, _, _ = jnh._operand_probe(jnp.asarray(a),
                                      jget_policy("tcec_bf16x6"))
    assert float(theirs["u"]) == 0.0 and float(theirs["gu"]) == 0.0
    assert 0.0 < float(mine["gu"]) < 1.0
    assert float(mine["oob"]) == float(theirs["oob"]) == 1.0


def test_probe_underflow_fraction_matches_closed_form():
    """Observed gradual-underflow fraction against Eq. 15; the probe casts
    round-to-nearest where the closed form assumes RZ, so the probe at
    operand exponent ``e`` tracks the closed form at ``e - 1``."""
    pol = get_policy("fp16_halfhalf")
    rng = np.random.default_rng(0)
    for e in (-13, -12, -11):
        x = torch.from_numpy((2.0 ** e * (1 + rng.random(8192)))
                             .astype(np.float32))
        stats, _, _ = nh._operand_probe(x, pol)
        predicted = theory.p_underflow_gradual(e - 1, theory.FP16,
                                               pol.scale_bits)
        assert float(stats["gu"]) == pytest.approx(predicted, abs=0.02), e
        assert float(stats["oob"]) == 1.0
        assert float(stats["emin"]) == e == float(stats["emax"])


def test_probe_healthy_input_is_quiet():
    stats, _, _ = nh._operand_probe(torch.from_numpy(_rand((128, 128), 3)),
                                    get_policy("tcec_bf16x3"))
    assert float(stats["gu"]) == 0.0 and float(stats["oob"]) == 0.0


@pytest.mark.parametrize("policy", ["fp16_halfhalf", "tcec_bf16x6"])
def test_monitor_risk_counters_and_output_parity(policy):
    """Operands scaled out of the safe range raise the risk counters; the
    contraction's output is bitwise that of ``monitor=False``."""
    obs.reset()
    x = torch.from_numpy(_rand((128, 128), 4, 2.0 ** -20 if
                               policy.startswith("fp16") else 2.0 ** -115))
    y = torch.from_numpy(_rand((128, 128), 5))
    with numerics.use(policy=policy, monitor=True):
        on = policy_mm(x, y)
    with numerics.use(policy=policy):
        off = policy_mm(x, y)
    assert torch.equal(on, off)
    risk = metrics.counter("numerics/monitor/underflow_risk")
    assert risk.value(site="mm", policy=policy) == 1
    snap = obs.snapshot(include_sources=False)
    oob = snap["histograms"][
        f"numerics/monitor/exponent_oob_frac{{policy={policy}}}"]
    assert oob["count"] == 1 and oob["sum"] > 0.4
    assert snap["gauges"][
        f"numerics/monitor/exponent_min{{policy={policy}}}"] < -15


def test_monitor_off_and_plain_policies_probe_nothing():
    obs.reset()
    a, b = torch.from_numpy(_rand((16, 16), 6)), \
        torch.from_numpy(_rand((16, 16), 7))
    policy_mm(a, b, "fp16_halfhalf")
    with numerics.use(monitor=True):
        policy_mm(a, b, "fp32")
    probes = metrics.counter("numerics/monitor/probes")
    assert probes.total() == 0
    with numerics.use(monitor=True):
        policy_mm(a, b, "fp16_halfhalf")
    assert probes.total() == 1


def test_monitor_sampling_gate():
    nh.configure(sample_every=1000)
    try:
        before = nh._calls
        nh.observe(torch.ones(8, 8), torch.ones(8, 8),
                   get_policy("tcec_bf16x3"))
        assert nh._calls == before + 1
    finally:
        nh.configure(sample_every=1)


def test_monitor_env_knob_registered():
    assert "REPRO_MONITOR" in numerics.ENV_VARS
    cfg = numerics.NumericsConfig.from_env({"REPRO_MONITOR": "1"})
    assert cfg.monitor is True
    assert numerics.NumericsConfig.from_env({}).monitor is False


def test_monitor_on_leaves_engine_tokens_and_prefill_bitwise(smoke):
    """Under ``monitor=True`` a prefill's logits are bitwise those with it
    off, the probes ran (one a split contraction), and no risk counter
    moved on these weights."""
    _, _, cfg, params = smoke
    cfg = cfg.replace(policy="tcec_bf16x6")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)))
    obs.reset()
    off, _ = get_model(cfg).prefill(params, toks)
    on, _ = get_model(cfg, numerics.active().replace(monitor=True)).prefill(
        params, toks)
    assert torch.equal(on, off)
    probes = metrics.counter("numerics/monitor/probes")
    assert probes.total() >= 7 * cfg.n_layers + 1
    assert metrics.counter("numerics/monitor/underflow_risk").total() == 0


# ======================================================= engine tracing

def _engine_events(tr):
    """The engine's events with times and thread ids dropped, in order."""
    return [(e["name"], e["ph"], e.get("id"),
             json.dumps(e["args"], sort_keys=True)) for e in tr.events]


def test_engine_trace_events_equal_jax(smoke):
    """The same workload through both engines under a tracer: the same
    events in the same order (spans, request begin / admitted / end, with
    their arguments; times aside), and the same number of latency
    samples."""
    jcfg, jparams, cfg, params = smoke
    prompts = [np.random.default_rng(8).integers(0, cfg.vocab_size, n)
               for n in (6, 9, 6)]
    kw = dict(max_slots=2, num_pages=64, page_size=8)
    sides = []
    for side in ("jax", "port"):
        obs.reset()
        jmetrics.reset()
        if side == "jax":
            from repro.obs.trace import trace as jtrace
            with jnumerics.use(**FORCED), jtrace() as tr:
                eng = JaxEngine(jcfg, jparams, **kw)
                for i, p in enumerate(prompts):
                    eng.add_request(p, JaxSamplingParams(max_tokens=4,
                                                         seed=i))
                eng.run()
            m = jmetrics
        else:
            with trace() as tr:
                eng = Engine(cfg, params, device="cpu", **kw)
                for i, p in enumerate(prompts):
                    eng.add_request(p, SamplingParams(max_tokens=4, seed=i))
                eng.run()
            m = metrics
        counts = [m.histogram(f"serving/latency/{n}").count()
                  for n in ("queue_wait_s", "ttft_s", "tpot_s")]
        sides.append((_engine_events(tr), counts))
    assert sides[1] == sides[0]
    events, counts = sides[1]
    assert counts[:2] == [3, 3] and counts[2] == 9
    names = {(n, ph) for n, ph, _, _ in events}
    assert {("engine.step", "X"), ("prefill", "X"), ("decode", "X"),
            ("decode.consume", "X"), ("request", "b"), ("admitted", "n"),
            ("request", "e")} <= names


def test_engine_trace_exports_request_lifecycle(smoke, tmp_path):
    _, _, cfg, params = smoke
    obs.reset()
    with trace() as tr:
        eng = Engine(cfg, params, max_slots=4, num_pages=64, page_size=8,
                     device="cpu")
        rng = np.random.default_rng(8)
        for i in range(3):
            eng.add_request(rng.integers(0, cfg.vocab_size, 6),
                            SamplingParams(max_tokens=4, seed=i))
        eng.run()
    p = tmp_path / "serve.json"
    obs.export(str(p))
    evs = json.loads(p.read_text())["traceEvents"]
    begins = {e["id"] for e in evs if e["ph"] == "b"}
    ends = {e["id"]: e for e in evs if e["ph"] == "e"}
    assert len(begins) == 3 and begins == set(ends)
    assert all(e["args"]["finish"] == "length" and e["args"]["tokens"] == 4
               for e in ends.values())
    assert len([e for e in evs if e["name"] == "admitted"]) == 3
    steps = [e for e in evs if e["name"] == "engine.step"]
    assert steps and all("occupancy" in e["args"] and "clock" in e["args"]
                         for e in steps)
    assert metrics.histogram("serving/latency/ttft_s").count() == 3
    assert tr is last()


def test_tracing_off_is_inert(smoke):
    """No tracer: no latency sample, no event, and the same tokens."""
    _, _, cfg, params = smoke
    prompts = [np.arange(1, 7) + i for i in range(3)]
    obs.reset()
    off = Engine(cfg, params, device="cpu").run(
        prompts, SamplingParams(max_tokens=4))
    assert metrics.histogram("serving/latency/ttft_s").count() == 0
    with trace():
        on = Engine(cfg, params, device="cpu").run(
            prompts, SamplingParams(max_tokens=4))
    assert on == off
    assert metrics.histogram("serving/latency/ttft_s").count() == 3


def test_engine_stats_folded_into_snapshot(smoke):
    _, _, cfg, params = smoke
    eng = Engine(cfg, params, device="cpu")
    eng.run([np.arange(1, 6)], SamplingParams(max_tokens=3))
    src = obs.snapshot()["sources"]["serving/engine"]
    assert src["decode_steps"] >= eng.n_decode_steps
    assert src["prefills"] >= eng.n_prefills and src["clock"] >= eng.clock
    assert "breaker" in eng.stats()


# =============================================================== cli glue

def test_cli_session_exports(tmp_path, capsys):
    obs.reset()
    ap = argparse.ArgumentParser()
    obs.add_cli_flags(ap)
    tr_path, m_path = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    args = ap.parse_args(["--trace", tr_path, "--metrics-out", m_path])
    with obs.cli_session(args):
        tr = current()
        assert tr is not None
        tr.instant("tick")
    out = capsys.readouterr().out
    assert "telemetry: trace ->" in out and "telemetry: metrics ->" in out
    assert "dispatch explain:" in out
    assert json.loads(open(tr_path).read())["traceEvents"]
    assert "counters" in json.loads(open(m_path).read())


def test_serve_cli_traces_and_dumps_metrics(tmp_path, capsys):
    from repro_torch.launch import serve
    tr_path, m_path = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    serve.main(["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len",
                "6", "--gen", "4", "--max-slots", "2", "--device", "cpu",
                "--max-waiting", "2", "--deadline", "50", "--trace", tr_path,
                "--metrics-out", m_path])
    out = capsys.readouterr().out
    assert "request 2: rejected (overloaded" in out
    assert "finish reasons: {'length': 2}" in out
    evs = json.loads(open(tr_path).read())["traceEvents"]
    assert len([e for e in evs if e["ph"] == "e"]) == 2
    snap = json.loads(open(m_path).read())
    assert snap["histograms"]["serving/latency/ttft_s"]["count"] == 2


# ============================================================ train step

def _train_setup(cfg, B=4):
    from repro_torch.data.pipeline import DataConfig, host_batch
    from repro_torch.optim import adamw
    params = get_model(cfg).init(0, "cpu")
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=1)
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    batch = {k: torch.from_numpy(v) for k, v in host_batch(
        cfg, DataConfig(seed=0, global_batch=B, seq_len=8), 1).items()}
    return state, batch, opt


def _reference_step(cfg, opt, state, batch):
    """The train step's arithmetic written out: one microbatch."""
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.optim import adamw
    p = tree_map(lambda t: t.detach().requires_grad_(), state["params"])
    loss, _ = get_model(cfg).loss_fn(p, batch)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    it = iter(grads)
    new_params, new_opt, _ = adamw.apply_updates(
        state["params"], tree_map(lambda _: next(it), state["params"]),
        state["opt"], opt)
    return {"params": new_params, "opt": new_opt}


def _bitwise_equal(a, b):
    from repro_torch.models.modules import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_train_step_without_a_tracer_records_nothing(monkeypatch):
    from repro_torch.launch.step import make_train_step
    cfg = get_smoke_config(ARCH)
    state, batch, opt = _train_setup(cfg)
    opened = []
    monkeypatch.setattr(Tracer, "span", lambda self, *a, **k: opened.append(
        a) or pytest.fail("span opened with no tracer"))
    assert current() is None
    new, _ = make_train_step(cfg, opt)(state, batch)
    assert opened == []
    _bitwise_equal(new, _reference_step(cfg, opt, state, batch))


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_spans_under_a_tracer(micro):
    """Forward and backward once per microbatch, then the optimizer, in
    that order, on the host alone (no device edges on the CPU); the state
    is the untraced step's bit for bit."""
    from repro_torch.launch.step import make_train_step
    cfg = get_smoke_config(ARCH)
    state, batch, opt = _train_setup(cfg)
    step = make_train_step(cfg, opt, num_microbatches=micro)
    off, met_off = step(state, batch)
    with trace() as tr:
        on, met_on = step(state, batch)
    names = [e["name"] for e in tr.events]
    assert names == ["train.forward", "train.backward"] * micro + [
        "train.optimizer"]
    assert all(e["ph"] == "X" and e["cat"] == "train"
               and e["args"] == {} for e in tr.events)
    fwd, bwd = tr.events[:2]
    assert fwd["ts"] + fwd["dur"] <= bwd["ts"]
    _bitwise_equal(on, off)
    assert all(torch.equal(met_on[k], met_off[k]) for k in met_off)
    if micro == 1:
        _bitwise_equal(off, _reference_step(cfg, opt, state, batch))


def test_train_cli_trace_exports_the_step_spans(tmp_path, capsys):
    from repro_torch.launch import train as train_cli
    tr_path = str(tmp_path / "train.json")
    train_cli.main(["--arch", ARCH, "--smoke", "--steps", "2", "--batch",
                    "2", "--seq", "8", "--ckpt-every", "100", "--ckpt-dir",
                    str(tmp_path / "ckpt"), "--device", "cpu", "--trace",
                    tr_path])
    assert "telemetry: trace ->" in capsys.readouterr().out
    evs = json.loads(open(tr_path).read())["traceEvents"]
    assert [e["name"] for e in evs if e["ph"] == "X"] == [
        "train.forward", "train.backward", "train.optimizer"] * 2
