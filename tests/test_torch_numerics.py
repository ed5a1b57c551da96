"""The port's paper-analysis modules, the compensated x9 policy and blocked
attention against the JAX package, on the CPU.

Pure-data parts are held bit for bit: ``matgen``'s arrays, ``theory``'s
closed forms and bounds, ``accum``'s simulators, and ``measure_underflow``
at the same seed (the port casts through torch where JAX casts through
ml_dtypes).  Products are held to the f32 SGEMM error ``8 K 2^-24 (|A| @
|B|)`` elementwise, as the other parity tests; x9's residuals to
``theory.policy_error_bound`` and its unevaluated ``head + tail`` to 1e-13
of f64 (JAX's own pin).  Attention outputs to ``1e-5 max|v|`` (the kernel
parity tests' rule) and attention gradients to ``2^-13`` of each
gradient's largest entry (the training parity tests' rule for a leaf).
"""
import importlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import accum as jaccum  # noqa: E402
from repro.core import matgen as jmatgen  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.core import accum, matgen, theory  # noqa: E402
from repro_torch.models import layers  # noqa: E402

jpol = importlib.import_module("repro.core.policy")
tpol = importlib.import_module("repro_torch.core.policy")

U24 = 2.0 ** -24
FORMATS = ["FP16", "BF16", "TF32", "FP8E4M3", "FP8E5M2"]
X9 = "tcec_bf16x9"


def _gemm_tol(a, b):
    """8 K u (|A| @ |B|) in f64."""
    return 8 * a.shape[-1] * U24 * (np.abs(a).astype(np.float64)
                                    @ np.abs(b).astype(np.float64))


def _residual(c, a, b):
    return matgen.relative_residual(np.asarray(c), a, b)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ matgen

MATGEN_CASES = {
    "urand": ("urand", ((7, 9),), {"seed": 3}),
    "urand-band": ("urand", ((33,), -2.0, 3.0), {"seed": 1}),
    "exp_rand-type1": ("exp_rand", ((8, 8), -15, 14), {"seed": 0}),
    "exp_rand-type4": ("exp_rand", ((5, 13), -100, -35), {"seed": 5}),
    "randtlr": ("randtlr", (100,), {"rank": 4, "tile": 32, "seed": 2}),
    "spatial": ("spatial", (40,), {"seed": 1}),
    "cauchy": ("cauchy", (30,), {"seed": 4}),
}


@pytest.mark.parametrize("case", sorted(MATGEN_CASES))
def test_matgen_bitwise_equal_to_jax(case):
    fn, args, kw = MATGEN_CASES[case]
    a = getattr(matgen, fn)(*args, **kw)
    b = getattr(jmatgen, fn)(*args, **kw)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_relative_residual_equal_to_jax():
    a = matgen.urand((12, 20), seed=1)
    b = matgen.urand((20, 9), seed=2)
    c = (a @ b) * np.float32(1 + 2 ** -20)
    assert matgen.relative_residual(c, a, b) == jmatgen.relative_residual(
        c, a, b)


# ------------------------------------------------------------------ theory

def test_formats_and_tables_equal_jax():
    for name in FORMATS:
        assert vars(getattr(theory, name)) == vars(getattr(jtheory, name))
    assert theory.MAX_UNBIASED_EXP == jtheory.MAX_UNBIASED_EXP
    assert {k: vars(v) for k, v in theory.FORMATS_BY_DTYPE.items()} == {
        k: vars(v) for k, v in jtheory.FORMATS_BY_DTYPE.items()}
    assert theory.F32_MANT == jtheory.F32_MANT


@pytest.mark.parametrize("lp_mant,mode", [(10, "rn"), (7, "rz")])
def test_split_kept_bits_bitwise_equal_to_jax(lp_mant, mode):
    """Every one of the 2^23 mantissas (Tables 1-2)."""
    a = theory.split_kept_bits(lp_mant, mode)
    b = jtheory.split_kept_bits(lp_mant, mode)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert theory.F32_MANT - float(a.mean()) == (
        jtheory.F32_MANT - float(b.mean()))


def _closed_forms(mod):
    """Every closed form of ``theory`` over a grid of its arguments."""
    out = {}
    for n in range(-1, 18):
        for mant in (2, 3, 7, 10):
            out[("p_l0", n, mant)] = mod.p_l0(n, mant)
    for name in FORMATS:
        fmt = getattr(mod, name)
        out[("representable_range", name)] = mod.representable_range(fmt)
        out[("representable_range", name, 5)] = mod.representable_range(
            fmt, max_e=5)
        for sb in sorted({0, 3, 4, 8, 11, fmt.mant + 1}):
            out[("safe", name, sb)] = mod.safe_exponent_range(fmt, sb)
            for e in (-130, -110, -40, -15, -1, 0, 5, 14):
                out[("pgu", name, sb, e)] = mod.p_underflow_gradual(e, fmt,
                                                                    sb)
                out[("pu", name, sb, e)] = mod.p_underflow(e, fmt, sb)
                for term in (0, 1, 2, 3):
                    out[("pterm", name, sb, e, term)] = mod.p_underflow_term(
                        e, fmt, sb, term)
            for n in (2, 3, 4):
                for e_lo in (-120, -40, -1, 0, 10):
                    out[("srb", name, sb, n, e_lo)] = mod.split_residual_bound(
                        fmt, n, sb, e_lo=e_lo)
        for n in (2, 3, 4):
            for keep in (((0, 0),), ((0, 0), (0, 1), (1, 0)),
                         tuple((i, j) for i in range(n) for j in range(n))):
                out[("drop", name, n, keep)] = mod.dropped_product_bound(
                    keep, n, fmt)
    return out


def test_theory_closed_forms_bitwise_equal_to_jax():
    a, b = _closed_forms(theory), _closed_forms(jtheory)
    assert a.keys() == b.keys()
    bad = [k for k in a if a[k] != b[k]]
    assert not bad, [(k, a[k], b[k]) for k in bad[:5]]


@pytest.mark.parametrize("k_depth", [64, 256, 4096])
def test_policy_error_bound_bitwise_equal_to_jax(k_depth):
    """Every registered policy, at the default band and at the low ends the
    Fig. 11 battery uses (the bound grows where a band dips below the
    format's zero-underflow range)."""
    assert sorted(tpol.POLICIES) == sorted(jpol.POLICIES)
    for name in sorted(tpol.POLICIES):
        for e_lo in (0, -15, -35, -40, -100):
            got = theory.policy_error_bound(tpol.POLICIES[name], k_depth,
                                            e_lo=e_lo)
            want = jtheory.policy_error_bound(jpol.POLICIES[name], k_depth,
                                              e_lo=e_lo)
            assert got == want, (name, e_lo, got, want)
        assert theory.policy_error_bound(name, k_depth) == \
            jtheory.policy_error_bound(name, k_depth)


@pytest.mark.parametrize("fmt", ["FP16", "BF16", "FP8E4M3", "FP8E5M2"])
def test_measure_underflow_equal_to_jax(fmt):
    """The Monte-Carlo counterpart of Eqs. (15)/(17): the same draws and
    the same split, the narrow cast through torch here and ml_dtypes there,
    at exponents on both sides of each format's underflow band."""
    for e_v in (-30, -14, -5, 0, 3):
        for sb in (0, 8):
            got = theory.measure_underflow(e_v, getattr(theory, fmt), sb,
                                           n=20_000, seed=100 + e_v + sb)
            want = jtheory.measure_underflow(e_v, getattr(jtheory, fmt), sb,
                                             n=20_000, seed=100 + e_v + sb)
            assert got == want, (fmt, e_v, sb, got, want)


@pytest.mark.parametrize("name", ["fp16", "bf16"] + sorted(tpol.POLICIES))
def test_representable_relative_error_bitwise_equal_to_jax(name):
    """Fig. 9 over a grid from 1e-30 to the top of the f32 range (fp8
    overflow included).  The grid stays where no split term or residual is
    an f32 subnormal: XLA's CPU backend flushes those to zero, torch keeps
    them."""
    v = np.concatenate([np.geomspace(1e-30, 3e38, 301),
                        -np.geomspace(1e-20, 1e20, 53), [0.0]])
    v = v.astype(np.float32)
    got = theory.representable_relative_error(v, name)
    with np.errstate(over="ignore"):
        want = jtheory.representable_relative_error(v, name)
    assert np.array_equal(got, want, equal_nan=True)


# ------------------------------------------------------------------- accum

@pytest.mark.parametrize("mode", ["rn", "rz"])
def test_mma_sim_bitwise_equal_to_jax(mode):
    rng = np.random.default_rng(3)
    a = rng.uniform(-1, 1, (2, 8, 48)).astype(np.float16)
    b = rng.uniform(-1, 1, (2, 48, 6)).astype(np.float16)
    c = rng.standard_normal((2, 8, 6))
    got = accum.mma_sim(a, b, c, mode)
    assert np.array_equal(got, jaccum.mma_sim(a, b, c, mode))
    assert np.array_equal(accum.mma_sim(a, b, c, mode, acc_bits=11),
                          jaccum.mma_sim(a, b, c, mode, acc_bits=11))


@pytest.mark.parametrize("chain", [True, False])
def test_markidis_gemm_sim_bitwise_equal_to_jax(chain):
    a = matgen.urand((8, 256), seed=1)
    b = matgen.urand((256, 8), seed=2)
    for mode in ("rn", "rz"):
        assert np.array_equal(accum.markidis_gemm_sim(a, b, mode, chain),
                              jaccum.markidis_gemm_sim(a, b, mode, chain))


def test_mma_rz_reproduces_markidis_error_fig5():
    """Fig. 5 on the port's simulator: RN accumulation matches SGEMM, RZ
    is visibly worse (the JAX package's own pin)."""
    k = 4096
    a = matgen.urand((16, k), seed=7)
    b = matgen.urand((k, 16), seed=8)
    r_rn = _residual(accum.markidis_gemm_sim(a, b, "rn"), a, b)
    r_rz = _residual(accum.markidis_gemm_sim(a, b, "rz"), a, b)
    r_32 = _residual(tpol.policy_mm(_t(a), _t(b), "fp32").numpy(), a, b)
    assert r_rn <= 3 * r_32
    assert r_rz > 5 * r_rn


# --------------------------------------------------------- compensated x9

def test_x9_policy_mm_and_unevaluated_pair_match_jax():
    """x9 through ``policy_mm`` and ``tcec_dot_unevaluated`` on both sides:
    within ``policy_error_bound`` of f64, bitwise equal to each other (the
    same K scan and fold), ``head + tail`` within 1e-13 of f64 on both
    sides."""
    a = matgen.urand((64, 256), seed=31)
    b = matgen.urand((256, 64), seed=32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    bound = theory.policy_error_bound(X9, 256)
    got = tpol.policy_mm(_t(a), _t(b), X9).numpy()
    want = np.asarray(jpol.policy_mm(jnp.asarray(a), jnp.asarray(b), X9))
    assert _residual(got, a, b) <= bound
    assert _residual(want, a, b) <= bound
    assert np.array_equal(got, want)
    h, t = tpol.tcec_dot_unevaluated(_t(a), _t(b), X9)
    jh, jt = jpol.tcec_dot_unevaluated(jnp.asarray(a), jnp.asarray(b), X9)
    assert np.array_equal(h.numpy(), got)
    assert np.array_equal(h.numpy(), np.asarray(jh))
    assert np.array_equal(t.numpy(), np.asarray(jt))
    for head, tail in ((h.numpy(), t.numpy()), (jh, jt)):
        val = np.asarray(head, np.float64) + np.asarray(tail, np.float64)
        assert np.linalg.norm(val - ref) / np.linalg.norm(ref) < 1e-13


def test_x9_pdot_gradient_matches_jax_grad():
    """x9's forward and both gradient products through ``pdot`` (the
    attention scores' einsum) against ``jax.vjp`` of the JAX ``pdot`` under
    x9: the gradient products keep the policy on both sides."""
    spec, ashape, bshape = "bqhrd,bkhd->bhrqk", (2, 6, 2, 2, 16), (2, 7, 2, 16)
    rng = np.random.default_rng(12)
    a = rng.uniform(-1, 1, ashape).astype(np.float32)
    b = rng.uniform(-1, 1, bshape).astype(np.float32)
    out, vjp = jax.vjp(lambda x, y: jpol.pdot(spec, x, y, X9),
                       jnp.asarray(a), jnp.asarray(b))
    g = rng.uniform(-1, 1, out.shape).astype(np.float32)
    jda, jdb = vjp(jnp.asarray(g))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    tout = tpol.pdot(spec, ta, tb, X9)
    (lhs, rhs), out_sub = spec.split("->")[0].split(","), spec.split("->")[1]
    size = dict(zip(lhs, ashape)) | dict(zip(rhs, bshape))
    absd = {"a": np.abs(a).astype(np.float64),
            "b": np.abs(b).astype(np.float64),
            "g": np.abs(g).astype(np.float64)}
    tout.backward(_t(g))
    # out = a . b over d, da = g . b over the n dims, db = a . g over m
    for got, ref, terms, x, y, summed in (
            (tout.detach(), out, f"{lhs},{rhs}->{out_sub}", "a", "b", "d"),
            (ta.grad, jda, f"{out_sub},{rhs}->{lhs}", "g", "b",
             [c for c in out_sub if c not in lhs]),
            (tb.grad, jdb, f"{lhs},{out_sub}->{rhs}", "a", "g",
             [c for c in lhs if c not in rhs])):
        k = int(np.prod([size[c] for c in summed]))
        tol = 8 * k * U24 * np.einsum(terms, absd[x], absd[y])
        assert got.shape == ref.shape
        assert np.all(np.abs(got.numpy() - np.asarray(ref)) <= tol)


# ------------------------------------------------------ Fig. 11 battery

def _chip_smoke():
    """``chip_smoke.py``'s module: phase 11's bands, Types and the
    conformance battery's ``operand_band`` are the ones held here."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
TYPES = CS.FIG11_TYPES
TYPE_POLICIES = [n for n in sorted(tpol.POLICIES) if "fp8" not in n]


def _battery_inputs(row, n=128):
    """The JAX bench's inputs: its seeds on the Types, and each policy's
    own band for the safe-band row."""
    if row in TYPES:
        ti = list(TYPES).index(row)
        (alo, ahi), (blo, bhi) = (CS.FIG11_BANDS[x] for x in TYPES[row])
        return (matgen.exp_rand((n, n), alo, ahi, seed=2 * ti),
                matgen.exp_rand((n, n), blo, bhi, seed=2 * ti + 1))
    lo, hi = CS.operand_band(tpol.POLICIES[row])
    return (matgen.exp_rand((n, n), lo, hi, seed=400),
            matgen.exp_rand((n, n), lo, hi, seed=401))


def test_phase11_bands_are_the_jax_bench_bands():
    """``chip_smoke.py``'s Types, bands and per-policy band are the JAX
    Fig. 11 bench's (``benchmarks/fig11_exponent_range.py``)."""
    from benchmarks import fig11_exponent_range as bench
    assert CS.FIG11_TYPES == bench.TYPES
    for kind in ("hi", "lo", "out"):
        x = bench._mats(64, kind, seed=3)
        assert x.tobytes() == matgen.exp_rand(
            (64, 64), *CS.FIG11_BANDS[kind], seed=3).tobytes()
    for name in sorted(tpol.POLICIES):
        assert CS.operand_band(tpol.POLICIES[name]) == bench._band(
            jpol.POLICIES[name]), name


@pytest.mark.parametrize("row", sorted(TYPES) + ["SafeBand"])
def test_fig11_battery_matches_jax(row):
    """Every policy at 128^3 on each Fig. 11 Type (the fp8 policies, whose
    band excludes the Types, on their own safe band): the port's
    ``policy_mm`` against JAX's within the f32 SGEMM error; then the JAX
    bench's gates on the port's residuals."""
    names = TYPE_POLICIES if row in TYPES else sorted(tpol.POLICIES)
    res = {}
    for name in names:
        a, b = _battery_inputs(row if row in TYPES else name)
        got = tpol.policy_mm(_t(a), _t(b), name).numpy()
        want = np.asarray(jpol.policy_mm(jnp.asarray(a), jnp.asarray(b),
                                         name))
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got)), name
        assert np.all(np.abs(got - want)[fin] <= _gemm_tol(a, b)[fin]), name
        res[name] = _residual(got, a, b)
        if row == "SafeBand":
            lo, _ = CS.operand_band(tpol.POLICIES[name])
            assert res[name] <= theory.policy_error_bound(name, 128,
                                                          e_lo=lo), name
    if row in TYPES:
        assert res["tcec_bf16x6"] <= 4 * res["fp32"] + 1e-12
        assert res[X9] < 0.5 * res["tcec_bf16x6"]
        assert res["tcec_bf16x10"] <= 1.1 * res["tcec_bf16x6"]
    if row == "Type3":
        assert res["fp16_halfhalf"] > 10 * res["tcec_bf16x6"]


# ------------------------------------------------------- blocked attention

S_LONG = 8192


def _attn_inputs(seed=0, S=S_LONG, T=S_LONG, B=1, H=2, Hkv=1, hd=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    qp = np.arange(T - S, T, dtype=np.int32)[None].repeat(B, 0)
    kp = np.arange(T, dtype=np.int32)[None].repeat(B, 0)
    return q, k, v, qp, kp


def test_blocked_attention_skips_only_future_chunks(monkeypatch):
    """The skip rule reads positions: with the usual ``arange`` a causal
    call runs the nq (nq + 1) / 2 chunk pairs on or below the diagonal,
    non-causal all of them, and positions shifted by one chunk (a query
    tail against a longer key range) every pair up to that diagonal.
    Chunks of 64 keep the products small."""
    calls = []
    pdot = layers.pdot

    def counting(spec, a, b, policy=None):
        if spec.endswith("->bhrqk"):
            calls.append(spec)
        return pdot(spec, a, b, policy)

    monkeypatch.setattr(layers, "pdot", counting)
    cfg = types.SimpleNamespace(mix_policy="fp32", attn_softcap=None)
    for (S, T), causal, live in (((256, 256), True, 10),
                                 ((256, 256), False, 16),
                                 ((128, 192), True, 2 + 3)):
        q, k, v, qp, kp = _attn_inputs(S=S, T=T, hd=4)
        calls.clear()
        layers.blocked_attention(*map(_t, (q, k, v)), cfg, _t(qp), _t(kp),
                                 causal, q_chunk=64, k_chunk=64)
        assert len(calls) == live


@pytest.mark.parametrize("window", [0, 3000])
def test_fused_sdpa_backward_takes_blocked_and_matches_jax(window,
                                                           monkeypatch):
    """S = T = 8192 in 2048-wide chunks, causal and windowed (10 of 16
    chunk pairs live in both: chunks are skipped by the causal rule alone,
    as in JAX): ``_FusedSDPA``'s recompute backward goes
    through ``blocked_attention``, whose output is JAX's
    ``blocked_attention``'s and whose gradients are ``jax.vjp``'s of JAX's
    composition."""
    q, k, v, qp, kp = _attn_inputs(seed=1)
    rng = np.random.default_rng(2)
    g = rng.standard_normal(q.shape).astype(np.float32)
    pol = "tcec_bf16x3"
    cfg = types.SimpleNamespace(mix_policy=pol, attn_softcap=None)
    want_out, vjp = jax.vjp(
        lambda x, y, z: jlayers._sdpa_composition(
            x, y, z, cfg, jnp.asarray(qp), jnp.asarray(kp), True, window),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    blocked = []
    fn = layers.blocked_attention

    def recording(*a, **kw):
        blocked.append(fn(*a, **kw))
        return blocked[-1]

    monkeypatch.setattr(layers, "blocked_attention", recording)
    qkv = [_t(x).requires_grad_() for x in (q, k, v)]
    out = layers._FusedSDPA.apply(*qkv, _t(qp), _t(kp), pol, None, True,
                                  window)
    out.backward(_t(g))
    assert len(blocked) == 1 and blocked[0].shape == want_out.shape
    assert np.max(np.abs(blocked[0].detach().numpy() - np.asarray(
        want_out))) <= 1e-5 * np.max(np.abs(v))
    for t, ref in zip(qkv, want):
        ref = np.asarray(ref)
        assert np.max(np.abs(t.grad.numpy() - ref)) <= \
            2.0 ** -13 * np.max(np.abs(ref))


@pytest.mark.parametrize("S,T,path", [
    (4096, 4096, "mha"),          # below the threshold
    (6144, 8192, "mha"),          # queries below it (cross lengths)
    (8192, 8192, "blocked"),
    (10240, 10240, "blocked"),
    (9216, 9216, "mha"),          # at or above, but not a chunk multiple
    (8192, 9000, "mha"),          # T not a chunk multiple
])
def test_sdpa_composition_picks_mha_or_blocked_as_jax(S, T, path,
                                                      monkeypatch):
    taken = []
    monkeypatch.setattr(layers, "mha", lambda *a, **k: taken.append("mha"))
    monkeypatch.setattr(layers, "blocked_attention",
                        lambda *a, **k: taken.append("blocked"))
    q = torch.zeros(1, S, 2, 4)
    k = torch.zeros(1, T, 1, 4)
    pos = torch.zeros(1, max(S, T), dtype=torch.int32)
    layers._sdpa_composition(q, k, k, None, pos, pos, True, 0)
    assert taken == [path]
    assert layers.ATTN_BLOCK_THRESHOLD == jlayers.ATTN_BLOCK_THRESHOLD


# ------------------------------------------- scripts/accum_granularity.py

def test_accum_granularity_script_runs_and_chains_as_described():
    """The simulation at a small size: one row per rule and SGEMM; chaining
    over all of K steps equals ``chain_all``, and with one k16 step the
    chained rules equal one another."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "accum_granularity.py"
    spec = importlib.util.spec_from_file_location("accum_granularity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.run(m=8, k=128, kinds=("type1",))
    rules = [r["rule"] for r in out["rows"]]
    assert rules == ["f32_sgemm", "every_fragment_rn", "chain_1", "chain_4",
                     "chain_8", "chain_all"]
    assert all(np.isfinite(r["residual"]) for r in out["rows"])
    a, b = mod.inputs("type1", 8, 128, 8)
    assert np.array_equal(mod.simulate(a, b, "chain_8"),
                          mod.simulate(a, b, "chain_all"))
    a, b = a[:, :16], b[:16]
    one = mod.simulate(a, b, "chain_1")
    assert all(np.array_equal(one, mod.simulate(a, b, r))
               for r in ("chain_4", "chain_8", "chain_all"))
