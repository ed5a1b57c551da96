"""The port's fault injection (``repro_torch.faults``), its circuit breaker
(``repro_torch.kernels.guard``) and the engine's resilience contract,
against the JAX package, on the CPU.

JAX's chaos battery (``tests/test_faults.py``) is ported where it applies,
and the port is held to the JAX package:

  * bitwise: the fire log of the same plans over the same poke sequence;
    the breaker's state sequence and counters for the same allow /
    success / failure calls;
  * greedy tokens, finish reasons and counters of the port's engine
    against the JAX engine's, at the smoke config, under ``pool.alloc`` and
    ``prefill`` faults, ``decode.slow`` with deadlines and ``max_waiting``,
    and preemption storms with parking.  The JAX engine runs its Pallas
    kernels in interpret mode (as in ``test_torch_serving.py``), the port
    its kernels' plain versions.

Where the port differs on purpose its behaviour is pinned: a non-finite
slot ends ``error`` with no re-run (JAX re-runs the step on its fallback);
under ``guard=True`` a ``kernel.*`` fault raises, is counted, and is then
quarantined without a launch, and no call reaches a kernel's plain path in
its place; a decode step that raises under ``guard=True`` ends its requests
with ``error`` and the engine serves on.  Not ported: JAX's
``test_chaos_nonfinite_recovers_via_fallback_rerun`` and
``test_guarded_dispatch_falls_back_and_quarantines`` (the port has no
fallback: pinned by the tests above instead).  The ``defragment`` step of
``test_preemption_storm_parks_and_recovers`` is mirrored in
``test_torch_prefix.py``.  Kernel 3's rule walk raises, outside the
breaker, on operands beyond the CUDA kernel's limits (pinned here).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro import numerics as jnumerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import guard as jguard  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import EngineOverloaded as JaxOverloaded  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import FinishReason as JaxFinishReason  # noqa: E402
from repro_torch import faults, numerics  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.policy import policy_mm  # noqa: E402
from repro_torch.kernels import dispatch, guard, tuning  # noqa: E402
from repro_torch.obs.explain import report as explain_report  # noqa
from repro_torch.obs.explain import reset as explain_reset  # noqa: E402
from repro_torch.serving import (Engine, EngineOverloaded,  # noqa: E402
                                 FinishReason, RequestRejected,
                                 RequestResult, SamplingParams)

FORCED = dict(force=True, interpret=True, min_dim=0)
ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(ARCH), params


@pytest.fixture(autouse=True)
def _clean_breaker():
    for g in (guard, jguard):
        g.reset()
        g.configure(threshold=2, cooldown=8)
    yield
    for g in (guard, jguard):
        g.reset()
        g.configure(threshold=2, cooldown=8)


def _prompts(cfg, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n) for n in lens]


def _drain_checked(engine, max_steps=500):
    """Run to drain, asserting page conservation after every step and
    bounding the step count (liveness)."""
    steps = 0
    while engine.sched.has_work:
        engine.step()
        steps += 1
        held = sum(len(r.pages) for r in engine.sched.running.values())
        assert engine.pool.num_free + held == engine.pool.num_pages - 1, \
            f"page leak at step {steps}"
        assert steps <= max_steps, "engine failed to drain"
    return engine.results()


# ========================================================== fault plans

def test_sites_equal_jax():
    assert list(faults.SITES) == list(jfaults.SITES)
    assert all(faults.SITES[s] for s in faults.SITES)


def test_fault_spec_triggers_and_budget():
    s = faults.FaultSpec("pool.alloc", at=(0, 3))
    assert s.triggers(0) and not s.triggers(1) and s.triggers(3)
    s = faults.FaultSpec("pool.alloc", every=3)
    assert [s.triggers(i) for i in range(6)] == [
        False, False, True, False, False, True]
    plan = faults.FaultPlan([faults.FaultSpec("prefill", every=1, times=2)])
    fired = [plan.poke("prefill") is not None for _ in range(5)]
    assert fired == [True, True, False, False, False]


def test_fault_plan_parsing_and_unknown_sites():
    plan = faults.plan_from_spec(
        "pool.alloc@0:2; decode.slow@every=4:arg=3 ;"
        "kernel.matmul@p=0.5:seed=7:times=1")
    a, b, c = plan.specs
    assert a.at == (0, 2) and b.every == 4 and b.arg == 3
    assert c.p == 0.5 and c.seed == 7 and c.times == 1
    with pytest.raises(ValueError):
        faults.FaultSpec("no.such.site")
    with pytest.raises(ValueError):
        faults.plan_from_spec("pool.alloc@bogus=1")
    with pytest.raises(ValueError):
        faults.plan_from_spec("just-a-site-no-at")
    with pytest.raises(KeyError):
        faults.FaultPlan().poke("no.such.site")


def test_fault_plan_probabilistic_is_seed_deterministic():
    mk = lambda: faults.plan_from_spec("kernel.matmul@p=0.3:seed=11")  # noqa
    fire = lambda p: [p.poke("kernel.matmul") is not None  # noqa: E731
                      for _ in range(64)]
    a, b = fire(mk()), fire(mk())
    assert a == b and any(a) and not all(a)
    assert fire(faults.plan_from_spec("kernel.matmul@p=0.3:seed=12")) != a


def test_fault_context_nesting_and_masking():
    outer = faults.FaultPlan([faults.FaultSpec("prefill", every=1)])
    with faults.use(outer):
        assert faults.poke("prefill") is not None
        with faults.use(None):
            assert faults.poke("prefill") is None
        assert faults.poke("prefill") is not None
    assert faults.active() is None


def test_fault_env_plan_roundtrip(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "pool.alloc@0")
    plan = faults.reload_env_plan()
    assert plan is not None and plan.specs[0].site == "pool.alloc"
    assert faults.active() is plan
    monkeypatch.delenv("REPRO_FAULTS")
    assert faults.reload_env_plan() is None


def test_use_reset_replays_the_same_schedule():
    plan = faults.FaultPlan([faults.FaultSpec("pool.alloc", at=(1,))])
    runs = []
    for _ in range(2):
        with faults.use(plan):
            runs.append([faults.poke("pool.alloc") is not None
                         for _ in range(3)])
    assert runs[0] == runs[1] == [False, True, False]
    assert plan.log == [("pool.alloc", 1)]


@pytest.mark.parametrize("spec", [
    "pool.alloc@0:1:2",
    "kernel.matmul@p=0.3:seed=11;kernel.paged@every=3:times=4",
    "decode.slow@every=4:arg=3;prefill@1:5;tuning.cache@p=0.5:seed=2",
    "pool.alloc@p=0.25:seed=9;decode.nonfinite@2:times=1:arg=1",
])
def test_fire_log_equals_jax(spec):
    """The same plan over the same seeded poke sequence fires at the same
    (site, index) pairs in both packages, bit for bit (the crc32 hash)."""
    sites = list(faults.SITES)
    seq = [sites[i] for i in
           np.random.default_rng(7).integers(0, len(sites), 400)]
    mine, theirs = faults.plan_from_spec(spec), jfaults.plan_from_spec(spec)
    with faults.use(mine), jfaults.use(theirs):
        got = [(faults.poke(s) is not None, jfaults.poke(s) is not None)
               for s in seq]
    assert all(a == b for a, b in got)
    assert mine.log == theirs.log and mine.log
    assert mine.counts() == theirs.counts()


# ======================================================= circuit breaker

def test_breaker_unit_transitions():
    guard.configure(threshold=2, cooldown=3)
    key = ("cpu", "matmul", "unit-test")
    assert guard.state(key) == "closed" and guard.allow(key)
    guard.failure(key)
    assert guard.state(key) == "closed"
    guard.failure(key)
    assert guard.state(key) == "open"
    for _ in range(3):
        assert not guard.allow(key)
    assert guard.allow(key)
    assert guard.state(key) == "half_open"
    guard.failure(key)
    assert guard.state(key) == "open"
    for _ in range(3):
        assert not guard.allow(key)
    assert guard.allow(key)
    guard.success(key)
    assert guard.state(key) == "closed"
    st = guard.stats()
    row = st["keys"]["cpu/matmul/unit-test"]
    assert row["opens"] == 2 and row["closes"] == 1
    assert st["totals"]["declined"] == 6


def test_breaker_success_resets_consecutive_failures():
    guard.configure(threshold=3, cooldown=2)
    key = ("cpu", "matmul", "reset-test")
    guard.failure(key)
    guard.failure(key)
    guard.success(key)
    guard.failure(key)
    guard.failure(key)
    assert guard.state(key) == "closed"


@pytest.mark.parametrize("threshold,cooldown,seed", [
    (2, 8, 0), (2, 3, 1), (1, 1, 2), (3, 5, 3)])
def test_breaker_state_sequence_equals_jax(threshold, cooldown, seed):
    """A seeded sequence of allow / success / failure calls over three keys
    drives both breakers through the same states, bit for bit; the JAX
    breaker's key takes the device in its ``ident`` position."""
    for g in (guard, jguard):
        g.configure(threshold=threshold, cooldown=cooldown)
    keys = [("cpu", "matmul", "tcec_bf16x6", 1, 8, 128, 128),
            ("cpu", "attention", "tcec_bf16x6", 2, 8, 2, 128, 128),
            ("cpu", "paged_attention", "tcec_bf16x3", 4, 8, 2, 40, 16)]
    rng = np.random.default_rng(seed)
    mine, theirs = [], []
    for _ in range(300):
        key = keys[rng.integers(0, 3)]
        op = rng.integers(0, 3)
        for g, trail in ((guard, mine), (jguard, theirs)):
            if op == 0:
                trail.append(g.allow(key))
            elif op == 1:
                g.success(key)
            else:
                g.failure(key, RuntimeError("boom"))
            trail.append(g.state(key))
    assert mine == theirs
    assert guard.counters() == jguard.counters()
    assert json.dumps(guard.stats(), sort_keys=True) == \
        json.dumps(jguard.stats(), sort_keys=True)
    assert guard.make_key("matmul", ("x", 1), torch.device("cpu")) == \
        ("cpu", "matmul", "x", 1)


def _kernel_calls(monkeypatch):
    """Count every call that reaches a kernel route in dispatch: the
    public wrappers (which run the plain version for a CPU operand) and
    the plain versions themselves."""
    calls = []
    for name in ("tcec_matmul_plain", "tcec_attention",
                 "tcec_attention_plain", "tcec_paged_attention",
                 "tcec_paged_attention_plain"):
        fn = getattr(dispatch, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(dispatch, name, counted)
    fn = dispatch.ops.tcec_matmul

    def counted_ops(*a, **kw):
        calls.append("ops.tcec_matmul")
        return fn(*a, **kw)
    monkeypatch.setattr(dispatch.ops, "tcec_matmul", counted_ops)
    return calls


def _site_call(site):
    """One dispatched call of the kernel behind ``site``, on small CPU
    operands under a split policy."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    if site == "kernel.matmul":
        a, b = t(16, 32), t(32, 24)
        return lambda: policy_mm(a, b, "tcec_bf16x6")
    if site == "kernel.attention":
        q, k, v = t(1, 8, 4, 16), t(1, 8, 2, 16), t(1, 8, 2, 16)
        return lambda: dispatch.attention(q, k, v, policy="tcec_bf16x6")
    q = t(2, 4, 16)
    kp, vp = t(5, 4, 2, 16).bfloat16(), t(5, 4, 2, 16).bfloat16()
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    ln = torch.tensor([5, 7], dtype=torch.int32)
    return lambda: dispatch.attention_decode(q, kp, vp, bt, ln,
                                             policy="tcec_bf16x6")


@pytest.mark.parametrize("site", ["kernel.matmul", "kernel.attention",
                                  "kernel.paged"])
def test_guard_counts_raises_and_quarantines_without_a_plain_call(
        site, monkeypatch):
    """Under ``guard=True`` and a plan that fails the first two calls: each
    fault is counted and re-raised, the breaker opens, the cooldown's calls
    raise ``KernelQuarantined`` without reaching any kernel route, and the
    half-open probe runs the kernel route again (here, on CPU operands, its
    plain version) and closes the breaker.  No failed or quarantined call
    is answered by a plain version."""
    guard.configure(threshold=2, cooldown=3)
    explain_reset()
    call = _site_call(site)
    with numerics.use(guard=True):
        ref = call()
        calls = _kernel_calls(monkeypatch)
        plan = faults.plan_from_spec(f"{site}@1:2")
        with faults.use(plan):
            call()                                    # index 0: healthy
            assert len(calls) == 1
            for _ in range(2):
                with pytest.raises(faults.FaultInjected):
                    call()
            for _ in range(3):
                with pytest.raises(guard.KernelQuarantined,
                                   match="FaultInjected"):
                    call()
            assert len(calls) == 1                    # nothing ran
            assert torch.equal(call(), ref)           # the probe closes
        assert plan.log == [(site, 1), (site, 2)]
    assert len(calls) == 2
    totals = guard.counters()
    assert (totals["failures"], totals["declined"], totals["opens"],
            totals["closes"], totals["half_opens"]) == (2, 3, 1, 1, 1)
    kernel = {"kernel.matmul": "matmul", "kernel.attention": "attention",
              "kernel.paged": "paged_attention"}[site]
    rules = {}
    for e in explain_report().entries:
        if e["kernel"] == kernel:
            rules[e["rule"]] = rules.get(e["rule"], 0) + e["count"]
    assert rules == {"fused": 3, "kernel-failure": 2, "breaker-open": 3}


@pytest.mark.parametrize("limit", ["rep", "page", "head_dim", "dtype"])
def test_paged_walk_raises_beyond_the_kernel_limits_outside_the_breaker(
        limit):
    """Kernel 3's rule walk checks the CUDA kernel's limits for operands
    off the CPU (meta ones here): rep <= 8, pages of <= 64 tokens, head
    dims <= 256, bf16 or f32 pools.  Beyond one it raises naming the limit
    under the slug ``shape-unsupported``, before any launch and without a
    breaker count, also under ``guard=True``."""
    shapes = {"rep": ((2, 9, 16), (5, 4, 1, 16), torch.bfloat16),
              "page": ((2, 4, 16), (5, 128, 2, 16), torch.bfloat16),
              "head_dim": ((2, 4, 320), (5, 4, 2, 320), torch.bfloat16),
              "dtype": ((2, 4, 16), (5, 4, 2, 16), torch.float16)}
    qs, ps, dt = shapes[limit]
    q = torch.empty(qs, device="meta")
    kp = torch.empty(ps, dtype=dt, device="meta")
    bt = torch.ones((2, 2), dtype=torch.int32, device="meta")
    ln = torch.ones((2,), dtype=torch.int32, device="meta")
    match = {"rep": "rep 9", "page": "page size 128",
             "head_dim": "head dims 320", "dtype": "bf16 or f32"}[limit]
    explain_reset()
    with numerics.use(guard=True):
        with pytest.raises(ValueError, match=match):
            dispatch.attention_decode(q, kp, kp, bt, ln,
                                      policy="tcec_bf16x6")
    assert all(v == 0 for v in guard.counters().values())
    rules = [e["rule"] for e in explain_report().entries
             if e["kernel"] == "paged_attention"]
    assert rules == ["shape-unsupported"]
    # the CPU's plain version takes the same shapes (and no limit applies)
    cpu = [torch.zeros(x.shape, dtype=x.dtype) for x in (q, kp)]
    out = dispatch.attention_decode(cpu[0], cpu[1], cpu[1],
                                    torch.ones((2, 2), dtype=torch.int32),
                                    torch.ones((2,), dtype=torch.int32),
                                    policy="tcec_bf16x6")
    assert out.shape == (2, qs[1], ps[-1])


def test_guard_off_propagates_kernel_errors(monkeypatch):
    calls = _kernel_calls(monkeypatch)
    call = _site_call("kernel.matmul")
    with numerics.use(guard=False), \
            faults.use(faults.plan_from_spec("kernel.matmul@0")):
        with pytest.raises(faults.FaultInjected):
            call()
    assert calls == []
    assert guard.counters()["failures"] == 0   # breaker never consulted


def test_guard_knob_registered_and_parsed(monkeypatch):
    assert "REPRO_GUARD" in numerics.ENV_VARS
    assert "REPRO_FAULTS" in numerics.ENV_VARS
    monkeypatch.setenv("REPRO_GUARD", "1")
    assert numerics.NumericsConfig.from_env().guard is True
    monkeypatch.delenv("REPRO_GUARD")
    # the port's default is False (JAX's True), as numerics.py says
    assert numerics.NumericsConfig.from_env().guard is False
    assert jnumerics.NumericsConfig.from_env().guard is True


# ================================================== tuning-cache guards

def test_tuning_cache_rejects_corrupt_entries(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({
        "version": tuning.CACHE_VERSION,
        "entries": {
            "good": {"block": [128, 64, 64], "ms": 0.4},
            "bad-type": {"block": "128x128"},
            "bad-len": {"block": [128, 128, 128, 128]},
            "bad-val": {"block": [128, 0, 128]},
            "bad-ms": {"block": [128, 128, 128], "ms": "fast"},
        }}))
    cache = tuning.BlockCache(path=str(path))
    assert cache.get("good") == {"block": [128, 64, 64], "ms": 0.4}
    for key in ("bad-type", "bad-len", "bad-val", "bad-ms"):
        assert cache.get(key) is None, key
        assert cache.get(key) is None


def test_tuning_cache_survives_injected_corruption(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text(json.dumps({
        "version": tuning.CACHE_VERSION,
        "entries": {"k": {"block": [128, 64, 64], "ms": 1.0}}}))
    cache = tuning.BlockCache(path=str(path))
    with faults.use(faults.plan_from_spec("tuning.cache@0")):
        assert cache.get("k") is None          # injected corruption: a miss
        assert cache.get("k") is None          # dropped until re-measured
    cache.put("k", {"block": [8, 16, 128], "ms": 0.5}, persist=True)
    assert cache.get("k")["block"] == [8, 16, 128]


def test_autotune_heals_through_corrupt_cache(tmp_path):
    path = tmp_path / "tune.json"
    path.write_text('{"version": "garbage"')   # truncated JSON wholesale
    with numerics.use(tune="auto", tune_cache=str(path)):
        block = tuning.get_block(256, 256, 256, "tcec_bf16x6")
    assert block == tuning.heuristic_block(256, 256, 256, "tcec_bf16x6")


# ================================================ engine chaos vs JAX

_ENGINE_KW = dict(max_slots=2, num_pages=64, page_size=4)


def _both(smoke, lens, seed, max_tokens, spec=None, deadlines=None,
          **kw):
    """The same workload (and fault plan) through the JAX engine and the
    port's, each drained with its page accounting checked after every
    step.  Returns ``(jax side, port side)``, each ``(results, stats,
    plan log, finish clocks, overloaded request indices)``."""
    jcfg, jparams, cfg, params = smoke
    prompts = _prompts(cfg, lens, seed=seed)
    deadlines = deadlines or [None] * len(prompts)
    kw = {**_ENGINE_KW, **kw}
    out = []
    for side in ("jax", "port"):
        if side == "jax":
            ctx = jnumerics.use(**FORCED)
            eng_fn = lambda: JaxEngine(jcfg, jparams, **kw)  # noqa: E731
            fl, sp, over = jfaults, JaxSamplingParams, JaxOverloaded
        else:
            ctx = numerics.use()
            eng_fn = lambda: Engine(cfg, params, device="cpu",  # noqa
                                    **kw)
            fl, sp, over = faults, SamplingParams, EngineOverloaded
        with ctx:
            eng = eng_fn()
            overloaded = []
            for i, (p, d) in enumerate(zip(prompts, deadlines)):
                try:
                    eng.add_request(p, sp(max_tokens=max_tokens),
                                    deadline=d)
                except over:
                    overloaded.append(i)
            plan = fl.plan_from_spec(spec) if spec else None
            with fl.use(plan):
                clocks = {}
                steps = 0
                while eng.sched.has_work:
                    eng.step()
                    steps += 1
                    held = sum(len(r.pages)
                               for r in eng.sched.running.values())
                    assert eng.pool.num_free + held == \
                        eng.pool.num_pages - 1
                    for rid, req in eng._requests.items():
                        if req.finish_reason is not None:
                            clocks.setdefault(rid, eng.clock)
                    assert steps <= 500
        res = {r: (list(v), v.finish_reason)
               for r, v in eng.results().items()}
        out.append((res, eng.stats(), list(plan.log) if plan else [],
                    clocks, overloaded))
    return out


_COMPARED = ("numerics_errors", "rejections", "overloads", "timeouts",
             "length_caps", "prefill_faults", "clock", "prefills",
             "decode_steps", "preemptions", "parks")


def _assert_same(j, t):
    assert t[0] == j[0]                       # tokens and finish reasons
    assert {k: t[1][k] for k in _COMPARED} == \
        {k: j[1][k] for k in _COMPARED}
    assert t[2] == j[2]                       # the fire log
    assert t[3] == j[3]                       # the clock at each finish
    assert t[4] == j[4]                       # overloaded requests


def test_chaos_alloc_and_prefill_faults_equal_jax(smoke):
    """Transient pool exhaustion delays admission and a failed prefill
    group is re-queued; every request still produces its tokens, equal to
    the JAX engine's, and the faults fire at the same indices."""
    j, t = _both(smoke, (5, 9, 7), 3, 6, "pool.alloc@0:1:2;prefill@0:2")
    _assert_same(j, t)
    assert t[1]["prefill_faults"] == 2 and len(t[2]) == 5
    assert all(r == "length" for _, r in t[0].values())


def test_chaos_slow_steps_deadlines_and_backpressure_equal_jax(smoke):
    """``decode.slow`` burns clock ticks: a running request and a queued
    one time out at the same clocks as in the JAX engine; the waiting
    queue's bound rejects the fourth request in both."""
    j, t = _both(smoke, (5, 9, 6, 4), 3, 6, "decode.slow@every=2:arg=3",
                 deadlines=[None, 6, 3, None], max_waiting=3)
    _assert_same(j, t)
    assert t[4] == [3] and t[1]["overloads"] == 1
    reasons = [t[0][r][1] for r in sorted(t[0])]
    assert reasons == ["length", "timeout", "timeout"]
    assert 0 < len(t[0][1][0]) < 6            # timed out while running
    assert t[0][2][0] == []                   # timed out while queued


def test_preemption_storm_parks_equal_jax(smoke):
    """A pool sized to thrash with ``max_preemptions=1``: victims park,
    every request finishes with the JAX engine's tokens."""
    j, t = _both(smoke, (4, 4, 6), 8, 16, num_pages=8, max_pages_per_slot=8,
                 max_preemptions=1)
    _assert_same(j, t)
    assert t[1]["preemptions"] >= 2 and t[1]["parks"] >= 1
    assert all(r == "length" for _, r in t[0].values())


def test_storm_with_alloc_faults_equal_jax(smoke):
    """Composite chaos: seeded alloc faults on a thrash-prone pool."""
    j, t = _both(smoke, (4, 6, 5), 3, 8, "pool.alloc@p=0.3:seed=5",
                 num_pages=11, max_pages_per_slot=8, max_preemptions=3)
    _assert_same(j, t)
    assert t[2]


def test_chaos_prefill_persistent_fails_request_not_engine(smoke):
    _, _, cfg, params = smoke
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW)
    rids = [eng.add_request(p, SamplingParams(max_tokens=6))
            for p in _prompts(cfg, (5, 9), seed=3)]
    with faults.use(faults.plan_from_spec("prefill@every=1")):
        out = _drain_checked(eng)
    assert all(out[r].finish_reason == "error" and len(out[r]) == 0
               for r in rids)
    # two prefill groups (padded 8 and 12), each failing until its cap
    assert eng.stats()["prefill_faults"] == 2 * Engine.MAX_PREFILL_FAULTS
    assert eng.pool.num_live == 0


def test_rejection_taxonomy_counts(smoke):
    _, _, cfg, params = smoke
    eng = Engine(cfg, params, max_slots=1, num_pages=32, page_size=4,
                 max_pages_per_slot=2, device="cpu")
    with pytest.raises(RequestRejected):
        eng.add_request([1, 2, 3], SamplingParams(max_tokens=0))
    with pytest.raises(RequestRejected):
        eng.add_request(list(range(16)), SamplingParams())
    with pytest.raises(ValueError):
        eng.add_request([1, 2, 3], SamplingParams(), deadline=0)
    assert eng.stats()["rejections"] == 3


# ======================================== where the port differs on purpose

def _fault_free(smoke, lens=(5, 9), seed=3, max_tokens=6):
    _, _, cfg, params = smoke
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW)
    rids = [eng.add_request(p, SamplingParams(max_tokens=max_tokens))
            for p in _prompts(cfg, lens, seed=seed)]
    return rids, _drain_checked(eng)


@pytest.mark.parametrize("guarded", [True, False])
def test_chaos_nonfinite_slot_fails_without_rerun(smoke, guarded):
    """A poisoned decode slot ends ``error`` after its prefill token; the
    step is not re-run (``fallback_reruns`` stays 0), the neighbour keeps
    its fault-free tokens; ``guard_trips`` counts the step under
    ``guard=True`` only."""
    _, _, cfg, params = smoke
    rids, ref = _fault_free(smoke)
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW,
                 numerics_config=numerics.active().replace(guard=guarded))
    for p in _prompts(cfg, (5, 9), seed=3):
        eng.add_request(p, SamplingParams(max_tokens=6))
    with faults.use(faults.plan_from_spec(
            "decode.nonfinite@0:times=1:arg=0")):
        out = _drain_checked(eng)
    st = eng.stats()
    assert st["numerics_errors"] == 1 and st["fallback_reruns"] == 0
    assert st["guard_trips"] == (1 if guarded else 0)
    assert out[rids[0]].finish_reason == "error"
    assert list(out[rids[0]]) == list(ref[rids[0]])[:1]
    assert list(out[rids[1]]) == list(ref[rids[1]])
    assert eng.pool.num_live == 0


def test_decode_kernel_fault_under_guard_errors_the_step_and_serves_on(
        smoke):
    """A ``kernel.paged`` fault raises in a decode step: under
    ``guard=True`` every request of that step ends ``error`` and the
    requests behind them are served with their fault-free tokens; under
    ``guard=False`` the fault propagates out of ``step``."""
    _, _, cfg, params = smoke
    lens = (5, 9, 6, 7)
    rids, ref = _fault_free(smoke, lens=lens)
    guarded = numerics.active().replace(guard=True)
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW,
                 numerics_config=guarded)
    for p in _prompts(cfg, lens, seed=3):
        eng.add_request(p, SamplingParams(max_tokens=6))
    with faults.use(faults.plan_from_spec("kernel.paged@0")):
        out = _drain_checked(eng)
    assert eng.stats()["decode_faults"] == 1
    assert [out[r].finish_reason for r in rids] == [
        "error", "error", "length", "length"]
    assert [len(out[r]) for r in rids[:2]] == [1, 1]
    for r in rids[2:]:
        assert list(out[r]) == list(ref[r])
    assert guard.counters()["failures"] == 1
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW)
    eng.add_request(_prompts(cfg, (5,))[0], SamplingParams(max_tokens=4))
    with faults.use(faults.plan_from_spec("kernel.paged@0")):
        with pytest.raises(faults.FaultInjected):
            eng.run()


@pytest.mark.parametrize("guarded", [True, False])
def test_prefill_errors_retry_under_guard_and_propagate_without(
        smoke, guarded, monkeypatch):
    """A prefill's own error (not injected) is retried on the same path
    under ``guard=True`` (a retry, not a fallback: the tokens are the
    fault-free ones) and propagates under ``guard=False``; an injected
    ``kernel.matmul`` fault in a prefill is retried either way."""
    _, _, cfg, params = smoke
    rids, ref = _fault_free(smoke)
    nc = numerics.active().replace(guard=guarded)
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW, numerics_config=nc)
    for p in _prompts(cfg, (5, 9), seed=3):
        eng.add_request(p, SamplingParams(max_tokens=6))
    real, failed = eng.model.prefill, []

    def flaky(*a, **kw):
        if not failed:
            failed.append(1)
            raise RuntimeError("kernel launch failed")
        return real(*a, **kw)
    monkeypatch.setattr(eng.model, "prefill", flaky)
    if not guarded:
        with pytest.raises(RuntimeError, match="launch failed"):
            eng.run()
        return
    out = _drain_checked(eng)
    assert eng.stats()["prefill_faults"] == 1
    assert {r: list(v) for r, v in out.items()} == \
        {r: list(v) for r, v in ref.items()}
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW, numerics_config=nc)
    for p in _prompts(cfg, (5, 9), seed=3):
        eng.add_request(p, SamplingParams(max_tokens=6))
    with faults.use(faults.plan_from_spec("kernel.matmul@0")):
        out = _drain_checked(eng)
    assert {r: list(v) for r, v in out.items()} == \
        {r: list(v) for r, v in ref.items()}


# ========================================================== determinism

def test_chaos_is_seed_deterministic(smoke):
    _, _, cfg, params = smoke

    def one_run():
        plan = faults.plan_from_spec(
            "pool.alloc@p=0.25:seed=9;decode.nonfinite@2:times=1:arg=1")
        eng = Engine(cfg, params, device="cpu", **_ENGINE_KW)
        for p in _prompts(cfg, (4, 6, 5), seed=3):
            eng.add_request(p, SamplingParams(max_tokens=5))
        with faults.use(plan):
            out = _drain_checked(eng)
        stats = eng.stats()
        stats.pop("breaker")
        return (list(plan.log), stats,
                {r: (list(v), v.finish_reason) for r, v in out.items()})
    a, b = one_run(), one_run()
    assert a[0] == b[0] and a[0]
    assert a[1] == b[1] and a[2] == b[2]


def test_fault_free_run_has_all_zero_counters(smoke):
    _, _, cfg, params = smoke
    eng = Engine(cfg, params, device="cpu", **_ENGINE_KW)
    out = eng.run(_prompts(cfg, (5, 9), seed=3),
                  SamplingParams(max_tokens=6))
    st = eng.stats()
    for k in ("guard_trips", "fallback_reruns", "numerics_errors",
              "rejections", "overloads", "timeouts", "length_caps",
              "prefill_faults", "decode_faults", "preemptions", "parks"):
        assert st[k] == 0, (k, st[k])
    assert all(v.finish_reason in ("stop", "length") for v in out.values())
    assert st["breaker"]["failures"] == 0 and st["breaker"]["declined"] == 0


# ===================================================== result back-compat

def test_request_result_is_list_compatible():
    r = RequestResult([1, 2, 3], FinishReason.STOP)
    assert r == [1, 2, 3] and r[:2] == [1, 2]
    assert list(np.asarray(r)) == [1, 2, 3]
    assert r.finish_reason == "stop" and r.tokens == [1, 2, 3]
    assert "stop" in repr(r)
    assert RequestResult().finish_reason is None


def test_finish_reason_enum_values_equal_jax():
    assert str(FinishReason.LENGTH_CAP) == "length_cap"
    assert FinishReason.TIMEOUT == "timeout"
    assert [(f.name, f.value) for f in FinishReason] == \
        [(f.name, f.value) for f in JaxFinishReason]
