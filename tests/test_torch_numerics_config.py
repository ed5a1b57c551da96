"""The port's numerics config (``repro_torch.numerics``), dispatch
decisions, verbs, ``fused_linear`` and the model and engine pins against
the JAX package, on the CPU.

The registry, ``from_env`` and ``parse_override_args`` agree with JAX's
field for field except the divergences the port's module docstring states,
each pinned here by name (``min_dim`` 0, ``guard`` False, the tune cache's
path, the not-ported fields that raise, and the serving knobs that now
reach the engine).  JAX's ``test_numerics.py``
battery is mirrored: precedence, nesting, thread-locality, the parsers,
the tune-mode mapping, no environment read outside ``numerics.py``.  The
rule walks return JAX's slugs under ``numerics.use(force=True)`` on shapes
both accept.  Tolerances: products ``8 K 2^-24 (|A| @ |B|)`` (x1.2 through
an activation, whose slope is at most 1.13), attention ``1e-5 max|v|``,
gradients and smoke logits ``2^-13`` of their largest entry (f32 sums in
another order), as in the other parity files.
"""
import dataclasses
import os
import re
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro import numerics as jnumerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models.layers import fused_linear as jax_fused_linear  # noqa
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import numerics  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.policy import get_policy, policy_mm  # noqa: E402
from repro_torch.kernels import (dispatch, tcec_attention,  # noqa: E402
                                 tcec_matmul, tcec_paged_attention)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model, layers  # noqa: E402
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.numerics import ENV_VARS, NumericsConfig  # noqa: E402
from repro_torch.serving import Engine, SamplingParams  # noqa: E402

jpolicy = __import__("importlib").import_module("repro.core.policy")
ROOT = Path(__file__).resolve().parents[1]
FORCED = dict(force=True, interpret=True, min_dim=0)
U24 = 2.0 ** -24
REL = 2.0 ** -13
# fields whose port default differs from JAX's, by design (module docstring)
DIVERGENT_DEFAULTS = {"min_dim": (128, 0), "guard": (True, False),
                      "tune": ("auto", "off")}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.max(np.abs(out - ref))
    assert err <= rel * np.max(np.abs(ref)), err


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# ------------------------------------------------------- registry parity

def test_registry_names_kinds_and_order_equal_jax():
    j = [(v.name, v.kind, v.field, v.invert)
         for v in jnumerics.ENV_VARS.values()]
    t = [(v.name, v.kind, v.field, v.invert) for v in ENV_VARS.values()]
    assert t == j
    for name, v in ENV_VARS.items():
        assert v.doc
        jdefault = jnumerics.ENV_VARS[name].default
        if name == "REPRO_PALLAS_MIN_DIM":
            assert (jdefault, v.default) == (128, 0)
        elif name == "REPRO_GUARD":
            assert (jdefault, v.default) == (True, False)
        elif name == "REPRO_TUNE_CACHE":
            assert v.default.endswith(os.path.join(
                ".cache", "repro_torch", "tcec_autotune.json"))
            assert jdefault.endswith(os.path.join(".cache", "repro",
                                                  "tcec_autotune.json"))
        else:
            assert v.default == jdefault, name


def test_config_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(NumericsConfig)] == \
        [f.name for f in dataclasses.fields(jnumerics.NumericsConfig)]


ENVIRONS = [
    {},
    {"REPRO_POLICY": "tcec_bf16x6", "REPRO_DISABLE_PALLAS": "1"},
    {"REPRO_FORCE_PALLAS": "yes", "REPRO_PALLAS_MIN_DIM": " 64 "},
    {"REPRO_FUSE_EPILOGUE": "on", "REPRO_DISABLE_FLASH_ATTN": "true",
     "REPRO_DISABLE_PAGED_ATTN": "1", "REPRO_GUARD": "0"},
    {"REPRO_TUNE": "1", "REPRO_TUNE_CACHE": "/x/t.json",
     "REPRO_PALLAS_MIN_DIM": "128"},
    {"REPRO_TUNE": "1", "REPRO_TUNE_DISABLE": "1", "REPRO_GUARD": "false",
     "REPRO_SHARD_MAP": "1"},
    {"REPRO_PALLAS_MIN_DIM": "", "REPRO_DISABLE_PALLAS": "  "},
]


@pytest.mark.parametrize("env", ENVIRONS)
def test_from_env_equals_jax(env):
    j, t = _fields(jnumerics.NumericsConfig.from_env(env)), \
        _fields(NumericsConfig.from_env(env))
    for name, (jd, td) in DIVERGENT_DEFAULTS.items():
        if all(env.get(v.name, "").strip() == "" for v in ENV_VARS.values()
               if v.field == name):
            assert (j[name], t[name]) == (jd, td), name
            j[name] = t[name]
    if not env.get("REPRO_TUNE_CACHE"):
        assert "repro_torch" in t["tune_cache"]
        j["tune_cache"] = t["tune_cache"]
    assert t == j


@pytest.mark.parametrize("var,field,item", [
    ("REPRO_SHARD_MAP", "shard_map", "item 16"),
    ("REPRO_PREFIX_CACHE", "prefix_cache", "item 14"),
    ("REPRO_CHUNKED_PREFILL", "chunked_prefill", "item 14"),
    ("REPRO_ASYNC_SCHED", "async_sched", "item 3"),
    ("REPRO_KEEP_BF16_DOTS", "keep_bf16_dots", "XLA only"),
])
def test_fields_not_ported_raise_away_from_their_default(var, field, item):
    """``keep_bf16_dots`` raises away from JAX's default ("XLA only").  The
    serving knobs (items 14 and 3) are ported: away from their default
    they parse from the environment as JAX's do, build a config, enter
    ``use()``, and reach an engine's knobs (the chunk rounded up to a page
    multiple).  ``shard_map`` (item 16) is ported: ``REPRO_SHARD_MAP=0``
    parses as JAX's does, and ``shard_map=False`` under a one-rank mesh
    makes kernel 1's walk record ``mesh-declined`` and run nothing of the
    kernel."""
    off = "0" if var == "REPRO_SHARD_MAP" else (
        "32" if var == "REPRO_CHUNKED_PREFILL" else "1")
    value = {"shard_map": False, "chunked_prefill": 20}.get(field, True)
    if field == "shard_map":
        _shard_map_off_declines(var, off)
        return
    if field in ("prefix_cache", "chunked_prefill", "async_sched"):
        parsed = NumericsConfig.from_env({var: off})
        assert getattr(parsed, field) == getattr(
            jnumerics.NumericsConfig.from_env({var: off}), field)
        assert getattr(parsed, field) not in (0, False)
        with numerics.use(**{field: value}):
            cfg = get_smoke_config("qwen3-0.6b")
            eng = Engine(cfg, get_model(cfg).init(seed=0, device="cpu"),
                         max_slots=1, num_pages=5, page_size=8,
                         device="cpu")
        assert getattr(eng.numerics_config, field) == value
        assert {"prefix_cache": eng.prefix is not None,
                "chunked_prefill": eng.chunk_tokens == 24,
                "async_sched": eng.async_sched}[field]
        return
    with pytest.raises(NotImplementedError, match=item):
        NumericsConfig.from_env({var: off})
    with pytest.raises(NotImplementedError, match=item):
        NumericsConfig(**{field: value})
    with pytest.raises(NotImplementedError):
        numerics.use(**{field: value})


def _shard_map_off_declines(var, off):
    import importlib

    import torch.distributed as dist

    from repro_torch.kernels import dispatch, shmap
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import ctx
    explain = importlib.import_module("repro_torch.obs.explain")
    parsed = NumericsConfig.from_env({var: off})
    assert parsed.shard_map is False
    assert jnumerics.NumericsConfig.from_env({var: off}).shard_map is False
    ran = []
    real = dispatch._matmul_local
    a = torch.randn(64, 64)
    owned = not dist.is_initialized()
    mesh = make_host_mesh(1, device="cpu")
    try:
        dispatch._matmul_local = lambda *x, **kw: (ran.append(1),
                                                   real(*x, **kw))[1]
        explain.reset()
        n0 = shmap.counters()["matmul"]
        with numerics.use(parsed), ctx.use_mesh(mesh):
            repro_torch.matmul(a, a, policy="tcec_bf16x6")
        assert ran == [] and shmap.counters()["matmul"] == n0
        assert {e["rule"] for e in explain.report().entries
                if e["kernel"] == "matmul"} == {"mesh-declined"}
    finally:
        dispatch._matmul_local = real
        if owned:
            dist.destroy_process_group()


@pytest.mark.parametrize("var,field", [("REPRO_GUARD", "guard"),
                                       ("REPRO_MONITOR", "monitor")])
def test_guard_and_monitor_are_accepted_away_from_their_default(var, field):
    """Ported (``kernels/guard.py``, ``obs/numerics_health.py``): True
    parses from the environment and builds a config, as in JAX."""
    assert getattr(NumericsConfig.from_env({var: "1"}), field) is True
    assert getattr(jnumerics.NumericsConfig.from_env({var: "1"}), field) \
        is True
    assert getattr(NumericsConfig(**{field: True}), field) is True
    with numerics.use(**{field: True}) as cfg:
        assert getattr(numerics.active(), field) is True is getattr(cfg,
                                                                    field)


def test_cli_override_parsing_equals_jax():
    pairs = ["policy=tcec_bf16x6", "enabled=false", "min_dim=0",
             "block=128,64,64", "paged_block=none", "fuse_epilogue=1",
             "attn_block=64,64", "tune=off", "tune_cache=/x.json",
             "interpret=none", "flash_attention=off"]
    assert numerics.parse_override_args(pairs) == \
        jnumerics.parse_override_args(pairs)
    for bad in (["min_dim"], ["not_a_field=1"], ["force=maybe"],
                ["policy=none"]):
        with pytest.raises(ValueError):
            numerics.parse_override_args(bad)
        with pytest.raises(ValueError):
            jnumerics.parse_override_args(bad)


# ------------------------------------------- JAX's battery, mirrored

def test_env_default_is_base_of_stack():
    assert numerics.active() == NumericsConfig.from_env()


def test_context_overrides_env_default_and_unwinds():
    base = numerics.active()
    with numerics.use(min_dim=7, policy="tcec_bf16x3") as cfg:
        assert numerics.active() is cfg
        assert cfg.min_dim == 7 and cfg.policy == "tcec_bf16x3"
        assert cfg.enabled == base.enabled
    assert numerics.active() == base


def test_nested_contexts_innermost_wins():
    with numerics.use(min_dim=1, fuse_epilogue=True):
        with numerics.use(min_dim=2):
            cfg = numerics.active()
            assert cfg.min_dim == 2 and cfg.fuse_epilogue
        assert numerics.active().min_dim == 1
    assert numerics.active().min_dim == NumericsConfig.from_env().min_dim


def test_call_site_policy_beats_context_policy():
    a, b = torch.from_numpy(_rand((64, 64), 2)), \
        torch.from_numpy(_rand((64, 64), 3))
    with numerics.use(policy="bf16"):
        y_ctx = repro_torch.matmul(a, b)
        y_kw = repro_torch.matmul(a, b, policy="fp32")
        assert get_policy(None).name == "bf16"
    assert torch.equal(y_kw, repro_torch.matmul(a, b, policy="fp32"))
    assert torch.equal(y_ctx, repro_torch.matmul(a, b, policy="bf16"))
    assert not torch.equal(y_ctx, y_kw)
    assert get_policy(None).name == "fp32"


def test_config_instance_and_overrides_compose():
    pinned = NumericsConfig(min_dim=5, policy="tcec_bf16x6")
    with numerics.use(pinned, min_dim=9) as cfg:
        assert cfg.min_dim == 9 and cfg.policy == "tcec_bf16x6"
    with pytest.raises(TypeError):
        numerics.use(object())


def test_unknown_override_and_invalid_policy_raise():
    with pytest.raises(TypeError, match="unknown numerics option"):
        numerics.use(minn_dim=3)
    with pytest.raises(TypeError, match="unknown numerics option"):
        repro_torch.matmul(torch.ones(4, 4), torch.ones(4, 4), forse=True)
    with pytest.raises(ValueError, match="unknown policy"):
        numerics.use(policy="tcec_bf16x")
    with pytest.raises(ValueError, match="unknown policy"):
        NumericsConfig(policy=None)
    with pytest.warns(UserWarning, match="not a registered policy"):
        cfg = NumericsConfig.from_env({"REPRO_POLICY": "typo"})
    assert cfg.policy == ENV_VARS["REPRO_POLICY"].default


def test_block_coercion_and_validation():
    with numerics.use(block=[8, 16, 128]) as cfg:
        assert cfg.block == (8, 16, 128)
        hash(cfg)
    with pytest.raises(ValueError):
        NumericsConfig(attn_block=(128, 128, 128))
    with pytest.raises(ValueError):
        NumericsConfig(tune="sometimes")


def test_contexts_are_thread_local():
    seen = {}

    def worker():
        seen["before"] = numerics.active().min_dim
        with numerics.use(min_dim=77):
            seen["inside"] = numerics.active().min_dim
        seen["after"] = numerics.active().min_dim

    with numerics.use(min_dim=11):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
        assert numerics.active().min_dim == 11
    env_min = NumericsConfig.from_env().min_dim
    assert seen == {"before": env_min, "inside": 77, "after": env_min}


def test_config_epoch_interning():
    base = numerics.active()
    assert numerics.config_epoch(base) == 0
    e1 = numerics.config_epoch(base.replace(min_dim=41))
    assert e1 != 0
    assert numerics.config_epoch(base.replace(min_dim=41)) == e1
    assert numerics.config_epoch(base.replace(min_dim=42)) != e1


def test_reload_env_defaults_roundtrip(monkeypatch):
    monkeypatch.setenv("REPRO_PALLAS_MIN_DIM", "32")
    try:
        assert numerics.reload_env_defaults().min_dim == 32
        assert numerics.active().min_dim == 32
    finally:
        monkeypatch.delenv("REPRO_PALLAS_MIN_DIM")
        numerics.reload_env_defaults()
    assert numerics.active().min_dim == 0


@pytest.mark.parametrize("off", ["0", "false", "no", "off", "", "  "])
def test_bool_vars_treat_falsy_and_empty_as_off(off):
    cfg = NumericsConfig.from_env({"REPRO_FORCE_PALLAS": off,
                                   "REPRO_DISABLE_PALLAS": off})
    assert not cfg.force and cfg.enabled


@pytest.mark.parametrize("on", ["1", "true", "YES", "On"])
def test_bool_vars_truthy_spellings(on):
    assert NumericsConfig.from_env({"REPRO_FORCE_PALLAS": on}).force


def test_bool_and_int_garbage_warn_and_use_the_default():
    with pytest.warns(UserWarning, match="unrecognized boolean"):
        assert NumericsConfig.from_env(
            {"REPRO_DISABLE_PALLAS": "maybe"}).enabled
    with pytest.warns(UserWarning, match="unrecognized integer"):
        assert NumericsConfig.from_env(
            {"REPRO_PALLAS_MIN_DIM": "soon"}).min_dim == 0
    assert NumericsConfig.from_env({"REPRO_PALLAS_MIN_DIM": " 64 "}) \
        .min_dim == 64


def test_tune_mode_mapping_disable_wins():
    # the port's default is "off" (JAX's "auto"; the module docstring)
    assert NumericsConfig.from_env({}).tune == "off"
    assert jnumerics.NumericsConfig.from_env({}).tune == "auto"
    assert NumericsConfig().tune == "off"
    assert NumericsConfig.from_env({"REPRO_TUNE": "1"}).tune == "force"
    assert NumericsConfig.from_env({"REPRO_TUNE_DISABLE": "1"}).tune == "off"
    assert NumericsConfig.from_env(
        {"REPRO_TUNE": "1", "REPRO_TUNE_DISABLE": "1"}).tune == "off"


_ENV_READ = re.compile(r"os\.environ\.get\(|os\.getenv\(|os\.environ\[")
_ENV_WRITE = re.compile(r"os\.environ\[[^]]+\]\s*=")


def test_no_env_reads_outside_numerics():
    offenders = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        if path.name == "numerics.py" and path.parent.name == "repro_torch":
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if _ENV_READ.search(code) and not _ENV_WRITE.search(code):
                offenders.append(f"{path.relative_to(ROOT)}:{lineno}")
    assert not offenders, offenders


def test_every_repro_var_mentioned_in_the_port_is_registered():
    unknown = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for token in set(re.findall(r"\bREPRO_[A-Z0-9_]+\b",
                                    path.read_text())):
            if token not in ENV_VARS:
                unknown.append(f"{path.relative_to(ROOT)}: {token}")
    assert not unknown


def test_force_changes_nothing_and_interpret_runs_the_plain_versions(
        monkeypatch):
    """The port has no off-backend rule: a CPU operand runs the kernel's
    plain version with or without ``force``; ``interpret=True`` sends calls
    to the plain versions (on the CPU the same function)."""
    a, b = torch.from_numpy(_rand((32, 48), 4)), \
        torch.from_numpy(_rand((48, 40), 5))
    base = policy_mm(a, b, "tcec_bf16x6")
    with numerics.use(force=True):
        assert torch.equal(policy_mm(a, b, "tcec_bf16x6"), base)
    wrapped = []
    real = dispatch.ops.tcec_matmul
    monkeypatch.setattr(dispatch.ops, "tcec_matmul",
                        lambda *x, **kw: (wrapped.append(1),
                                          real(*x, **kw))[1])
    with numerics.use(interpret=True):
        assert torch.equal(policy_mm(a, b, "tcec_bf16x6"), base)
    assert wrapped == []
    policy_mm(a, b, "tcec_bf16x6")
    assert wrapped == [1]


# -------------------------------------------------- dispatch rule walks

MM_DIMS = {
    "mk,kn": ((32, 48), (48, 40), (((1,), (0,)), ((), ()))),
    "km,kn (A^T)": ((48, 32), (48, 40), (((0,), (0,)), ((), ()))),
    "mk,nk (B^T)": ((32, 48), (40, 48), (((1,), (1,)), ((), ()))),
    "batched": ((3, 32, 48), (3, 48, 40), (((2,), (1,)), ((0,), (0,)))),
    "small": ((4, 16), (16, 8), (((1,), (0,)), ((), ()))),
}
HATCHES = [dict(min_dim=0), dict(enabled=False), dict(min_dim=16),
           dict(min_dim=64), dict(min_dim=128),
           dict(min_dim=0, flash_attention=False, paged_attention=False)]
RULE_POLICIES = ["fp32", "bf16", "tcec_bf16x3", "tcec_bf16x6",
                 "tcec_bf16x10", "tcec_bf16x9", "fp16_markidis",
                 "fp16_halfhalf", "tcec_fp8e4m3x6"]


@pytest.mark.parametrize("hatch", HATCHES, ids=str)
@pytest.mark.parametrize("policy", RULE_POLICIES)
def test_decide_slugs_equal_jax(policy, hatch):
    jpol, tpol = jpolicy.get_policy(policy), get_policy(policy)
    with jnumerics.use(force=True, **hatch) as jcfg, \
            numerics.use(force=True, **hatch) as tcfg:
        for name, (sa, sb, dims) in MM_DIMS.items():
            ja, jb = jnp.zeros(sa), jnp.zeros(sb)
            ta, tb = torch.zeros(sa), torch.zeros(sb)
            _, jrule = jdispatch._decide(ja, jb, jpol, dims, jcfg)
            _, trule = dispatch._decide(ta, tb, tpol, dims, tcfg)
            assert trule == jrule, (name, jrule, trule)
        # attention (q (B, S, H, hd), k/v (B, T, Hkv, hd)) and paged decode
        for sq, sk in [((1, 32, 4, 16), (1, 32, 2, 16)),
                       ((2, 8, 4, 16), (2, 40, 4, 16)),
                       ((1, 32, 3, 16), (1, 32, 2, 16)),
                       ((32, 4, 16), (32, 2, 16))]:
            jr = jdispatch._attention_reason(jnp.zeros(sq), jnp.zeros(sk),
                                             jnp.zeros(sk), jpol, jcfg)
            tr = dispatch._attention_reason(torch.zeros(sq),
                                            torch.zeros(sk),
                                            torch.zeros(sk), tpol, tcfg)
            assert tr == jr, (sq, jr, tr)
        for sq, sp in [((2, 4, 16), (9, 4, 2, 16)),
                       ((2, 3, 16), (9, 4, 2, 16)),
                       ((2, 4, 16, 1), (9, 4, 2, 16))]:
            jr = jdispatch._paged_reason(jnp.zeros(sq), jnp.zeros(sp),
                                         jnp.zeros(sp), jpol, jcfg)
            tr = dispatch._paged_reason(torch.zeros(sq), torch.zeros(sp),
                                        torch.zeros(sp), tpol, tcfg)
            assert tr == jr, (sq, jr, tr)
        for fuse in (False, True):
            assert dispatch.epilogue_eligible(
                tpol, tcfg.replace(fuse_epilogue=fuse)) == \
                jdispatch.epilogue_eligible(
                    jpol, jcfg.replace(fuse_epilogue=fuse))


def test_default_min_dim_is_the_divergence():
    """JAX's default ``min_dim`` 128 declines a decode product; the port's
    0 sends it to kernel 1 (path S)."""
    dims = (((1,), (0,)), ((), ()))
    pol = "tcec_bf16x6"
    with jnumerics.use(force=True) as jcfg:
        _, jrule = jdispatch._decide(jnp.zeros((4, 1024)),
                                     jnp.zeros((1024, 3072)),
                                     jpolicy.get_policy(pol), dims, jcfg)
    _, trule = dispatch._decide(torch.zeros(4, 1024), torch.zeros(1024, 3072),
                                get_policy(pol), dims, numerics.active())
    assert (jrule, trule) == ("below-min-dim", "fused")


def test_hatch_disabled_runs_no_kernel(monkeypatch):
    """``enabled=False``: the term expansion, the pdot composition and the
    page gather; none of the three wrappers is called."""
    calls = []
    for mod, name in ((tcec_matmul, "tcec_matmul_plain"),
                      (tcec_attention, "_plain_core"),
                      (tcec_paged_attention, "_plain_core")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=mod.__name__,
                            **kw: (calls.append(_n), _r(*a, **kw))[1])
    cfg = get_smoke_config("qwen3-0.6b")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    with numerics.use(enabled=False):
        out = serve.generate(cfg, params, prompts, 3, device="cpu")
    assert calls == [] and out.shape == (2, 3)
    serve.generate(cfg, params, prompts, 3, device="cpu")
    assert {c.rsplit(".", 1)[1] for c in calls} == {
        "tcec_matmul", "tcec_attention", "tcec_paged_attention"}


# -------------------------------------------------------------- verbs

def test_verbs_match_jax():
    a, b = _rand((2, 40, 72), 6), _rand((2, 72, 24), 7)
    out = repro_torch.matmul(torch.from_numpy(a), torch.from_numpy(b),
                             policy="tcec_bf16x6").numpy()
    ref = np.asarray(repro.matmul(jnp.asarray(a), jnp.asarray(b),
                                  policy="tcec_bf16x6"))
    bound = 8 * 72 * U24 * (np.abs(a) @ np.abs(b))
    assert np.all(np.abs(out - ref) <= bound)
    x, w = _rand((3, 5, 72), 8), _rand((72, 24), 9)
    out = repro_torch.einsum("bsk,kd->bsd", torch.from_numpy(x),
                             torch.from_numpy(w), policy="tcec_bf16x3")
    ref = repro.einsum("bsk,kd->bsd", jnp.asarray(x), jnp.asarray(w),
                       policy="tcec_bf16x3")
    bound = 8 * 72 * U24 * np.einsum("bsk,kd->bsd", np.abs(x), np.abs(w))
    assert np.all(np.abs(out.numpy() - np.asarray(ref)) <= bound)
    q, k, v = _rand((1, 40, 4, 32), 10), _rand((1, 40, 2, 32), 11), \
        _rand((1, 40, 2, 32), 12)
    out = repro_torch.attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), policy="tcec_bf16x6")
    with jnumerics.use(**FORCED):
        ref = repro.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              policy="tcec_bf16x6")
    assert np.max(np.abs(out.numpy() - np.asarray(ref))) <= \
        1e-5 * np.max(np.abs(v))


def test_attention_verb_is_differentiable():
    q = torch.from_numpy(_rand((1, 24, 2, 16), 13)).requires_grad_()
    k, v = torch.from_numpy(_rand((1, 24, 2, 16), 14)), \
        torch.from_numpy(_rand((1, 24, 2, 16), 15))
    (repro_torch.attention(q, k, v, policy="tcec_bf16x6") ** 2).sum() \
        .backward()
    g = q.grad.clone()
    q.grad = None
    (repro_torch.attention(q, k, v, policy="tcec_bf16x6", enabled=False)
     ** 2).sum().backward()
    _close(g.numpy(), q.grad.numpy(), 1e-5)


# --------------------------------------------------------- fused_linear

@pytest.mark.parametrize("activation", ["silu", "gelu", None])
@pytest.mark.parametrize("bias", [False, True])
def test_fused_linear_matches_jax(activation, bias, monkeypatch):
    x, w, b = _rand((2, 24, 72), 16), _rand((72, 40), 17), \
        _rand((40,), 18)
    bj = jnp.asarray(b) if bias else None
    with jnumerics.use(**FORCED, fuse_epilogue=True):
        ref, vjp = jax.vjp(
            lambda x, w, bb: jax_fused_linear(x, w, bb, activation,
                                              "tcec_bf16x6"),
            jnp.asarray(x), jnp.asarray(w), bj)
        jgrads = vjp(jnp.asarray(_rand((2, 24, 40), 19)))
    fused = []
    real = dispatch.fused_matmul
    monkeypatch.setattr(dispatch, "fused_matmul",
                        lambda *a, **kw: (fused.append(1), real(*a, **kw))[1])
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if bias else None
    with numerics.use(fuse_epilogue=True):
        out = layers.fused_linear(xt, wt, bt, activation, "tcec_bf16x6")
    assert fused == [1]
    bound = 1.2 * 8 * 72 * U24 * np.einsum("bsk,kd->bsd", np.abs(x),
                                           np.abs(w)) \
        + 8 * U24 * np.abs(np.asarray(ref))
    assert np.all(np.abs(out.detach().numpy() - np.asarray(ref)) <= bound)
    out.backward(torch.from_numpy(_rand((2, 24, 40), 19)))
    leaves = [xt.grad, wt.grad] + ([bt.grad] if bias else [])
    for g, jg in zip(leaves, jgrads):
        _close(g.numpy(), jg)
    if not bias:
        assert jgrads[2] is None


def test_backward_runs_under_the_forward_config():
    """A forward under ``use(enabled=False)`` whose backward runs after the
    scope exited launches no kernel in the backward (``_PolicyDot``,
    ``_FusedSDPA``, ``_FusedLinear`` and the remat recompute carry the
    config), and the default config's backward does reach them."""
    calls = []
    real = dispatch._kernel_matmul

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    attn = []
    real_attn = dispatch.attention

    def counted_attn(*a, **kw):
        out = real_attn(*a, **kw)
        attn.append(out is not None)
        return out

    cfg = get_smoke_config("qwen3-0.6b").replace(remat=True)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": toks, "labels": toks}
    old = dispatch._kernel_matmul, dispatch.attention
    dispatch._kernel_matmul, dispatch.attention = counted, counted_attn
    try:
        for scope in (dict(enabled=False, fuse_epilogue=True),
                      dict(fuse_epilogue=True)):
            with numerics.use(**scope):
                loss, _ = model.loss_fn(params, batch)
            forward = len(calls)
            loss.backward()
            if scope.get("enabled") is False:
                assert calls == [] and not any(attn)
            else:
                assert len(calls) > forward > 0 and any(attn)
            calls.clear()
            attn.clear()
    finally:
        dispatch._kernel_matmul, dispatch.attention = old


def test_policy_dot_backward_keeps_the_forward_config():
    a = torch.from_numpy(_rand((16, 24), 20)).requires_grad_()
    b = torch.from_numpy(_rand((24, 8), 21)).requires_grad_()
    seen = []
    real = dispatch.maybe_dispatch

    def spy(*args, **kw):
        seen.append(numerics.active().min_dim)
        return real(*args, **kw)

    dispatch.maybe_dispatch = spy
    try:
        with numerics.use(min_dim=3):
            y = policy_mm(a, b, "tcec_bf16x6")
        y.sum().backward()
    finally:
        dispatch.maybe_dispatch = real
    assert seen == [3, 3, 3]


# ---------------------------------------------- pinned models and engine

PINNED_ARCHS = ["qwen3-0.6b", "gemma-2b", "zamba2-1.2b", "deepseek-v3-671b",
                "seamless-m4t-large-v2"]


@pytest.fixture(scope="module")
def smoke_models():
    out = {}

    def get(arch):
        if arch not in out:
            jcfg = jax_smoke_config(arch)
            jparams = jax.jit(jax_get_model(jcfg).init)(
                jax.random.PRNGKey(0))
            params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
            out[arch] = (jcfg, jparams, get_smoke_config(arch), params)
        return out[arch]
    return get


@pytest.mark.parametrize("arch", PINNED_ARCHS)
def test_pinned_fused_epilogue_logits_match_jax(arch, smoke_models,
                                                monkeypatch):
    """``get_model(cfg, numerics_config)`` with ``fuse_epilogue`` against
    JAX's model pinned the same way: every ``L.mlp`` caller (the dense
    family, the hybrid's shared block, deepseek's dense layer and shared
    expert, the enc-dec encoder and decoder) takes the fused gate and up
    projections."""
    jcfg, jparams, cfg, params = smoke_models(arch)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16))}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (2, 16, cfg.frontend_dim)).astype(np.float32)
    jpin = jnumerics.active().replace(**FORCED, fuse_epilogue=True)
    ref = jax_get_model(jcfg, numerics_config=jpin).forward_logits(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    fused = []
    real = dispatch.fused_matmul
    monkeypatch.setattr(dispatch, "fused_matmul",
                        lambda *a, **kw: (fused.append(1), real(*a, **kw))[1])
    pinned = get_model(cfg, NumericsConfig(fuse_epilogue=True))
    with numerics.use(fuse_epilogue=False):     # the pin wins
        out = pinned.forward_logits(params, batch)
    assert len(fused) >= 2 and len(fused) % 2 == 0
    # deepseek's MoE layers round the experts' inputs and outputs to bf16
    # on both sides (test_torch_mla.py's 2^-8 after a MoE layer)
    _close(out.detach().numpy(), ref,
           2.0 ** -8 if cfg.n_experts else REL)
    fused.clear()
    get_model(cfg).forward_logits(params, batch)
    assert fused == []


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma-2b"])
def test_pinned_engine_tokens_equal_jax(arch, smoke_models, monkeypatch):
    jcfg, jparams, cfg, params = smoke_models(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 12, 9)]
    kw = dict(max_slots=3, num_pages=25, page_size=4)
    jpin = jnumerics.active().replace(**FORCED, fuse_epilogue=True)
    jout = JaxEngine(jcfg, jparams, numerics_config=jpin, **kw).run(
        prompts, JaxSamplingParams(max_tokens=5))
    fused = []
    real = dispatch.fused_matmul
    monkeypatch.setattr(dispatch, "fused_matmul",
                        lambda *a, **k: (fused.append(1), real(*a, **k))[1])
    engine = Engine(cfg, params, device="cpu",
                    numerics_config=NumericsConfig(fuse_epilogue=True), **kw)
    with numerics.use(enabled=False):           # ambient, mid-serve
        out = engine.run(prompts, SamplingParams(max_tokens=5))
    assert fused
    assert {r: list(v) for r, v in out.items()} == \
        {r: list(v) for r, v in jout.items()}


def test_engine_pins_the_construction_config():
    cfg = get_smoke_config("qwen3-0.6b")
    params = get_model(cfg).init(0, device="cpu")
    with numerics.use(min_dim=3):
        engine = Engine(cfg, params, max_slots=1, num_pages=16, page_size=4,
                        device="cpu")
    assert engine.numerics_config.min_dim == 3
    pinned = numerics.active().replace(min_dim=9)
    engine2 = Engine(cfg, params, max_slots=1, num_pages=16, page_size=4,
                     device="cpu", numerics_config=pinned)
    assert engine2.numerics_config.min_dim == 9


def test_cli_numerics_flag(monkeypatch, capsys, tmp_path):
    fused = []
    real = dispatch.fused_matmul
    monkeypatch.setattr(dispatch, "fused_matmul",
                        lambda *a, **k: (fused.append(1), real(*a, **k))[1])
    serve.main(["--arch", "qwen3-0.6b", "--smoke", "--batch", "2",
                "--prompt-len", "6", "--gen", "3", "--device", "cpu",
                "--numerics", "fuse_epilogue=1", "--numerics",
                "tune=off"])
    assert fused and "engine on cpu" in capsys.readouterr().out
    from repro_torch.launch import train
    fused.clear()
    train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                "--batch", "2", "--seq", "8", "--device", "cpu",
                "--ckpt-dir", str(tmp_path), "--numerics",
                "fuse_epilogue=true"])
    assert fused
    with pytest.raises(ValueError):
        serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                    "--numerics", "fuse=1"])


def test_paged_block_reaches_kernel_3():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((9, 4, 2, 16))).bfloat16()
    vp = torch.from_numpy(rng.standard_normal((9, 4, 2, 16))).bfloat16()
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    ln = torch.tensor([13, 7], dtype=torch.int32)
    with numerics.use(paged_block=2):
        out = dispatch.attention_decode(q, kp, vp, bt, ln,
                                        policy="tcec_bf16x6")
    ref = tcec_paged_attention.tcec_paged_attention_plain(
        q, kp, vp, bt, ln, policy="tcec_bf16x6", pages_per_chunk=2)
    assert torch.equal(out, ref)
