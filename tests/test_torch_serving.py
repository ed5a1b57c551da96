"""The port's model and serving engine against the JAX package.

The JAX model runs under ``numerics.use(force=True, interpret=True,
min_dim=0)``, so its attention goes through the Pallas kernels in interpret
mode (its projections take the XLA term expansion, which computes the same
function as kernel 1).  The port runs its kernels' plain versions on the
CPU.  Parameters come from the JAX ``lm.init`` and are bridged exactly.

Logit tolerances are relative to the logits' scale: the two sides differ
by f32 rounding of summation order through two layers, far below the
``2^-13`` relative bound asserted; greedy tokens must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import sampling as jax_sampling  # noqa: E402
from repro.serving.kv_cache import (  # noqa: E402
    write_prompt_pages as jax_write_prompt_pages)
from repro_torch.bridge import (numpy_from_tensor,  # noqa: E402
                                params_from_jax, tensor_from_numpy)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import (Engine, PagePool, PagePoolError,  # noqa: E402
                                 RequestRejected, SamplingParams)
from repro_torch.serving import sampling  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
ARCH = "qwen3-0.6b"
REL = 2.0 ** -13


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(ARCH), params


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref))


@pytest.mark.parametrize("policy", ["tcec_bf16x6", "fp32"])
def test_prefill_logits_and_kv_match_jax(smoke, policy):
    """x6 runs kernels 1 and 2; fp32 declines both and takes the plain
    product and the pdot attention composition on both sides."""
    jcfg, jparams, cfg, params = smoke
    jcfg, cfg = jcfg.replace(policy=policy), cfg.replace(policy=policy)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    with numerics.use(**FORCED):
        jlogits, jkv = jax_get_model(jcfg).prefill(jparams,
                                                    jnp.asarray(toks))
    logits, kv = get_model(cfg).prefill(params, torch.from_numpy(toks))
    _close(logits.numpy(), jlogits)
    assert torch.equal(get_model(cfg).forward_logits(
        params, torch.from_numpy(toks)), logits)
    for name in ("k", "v"):
        _close(kv["dense_blocks"][name].numpy(), jkv["dense_blocks"][name])


@pytest.mark.parametrize("policy", ["tcec_bf16x6", "fp32"])
def test_decode_step_paged_logits_match_jax(smoke, policy):
    """x6 runs kernel 3; fp32 gathers the pages and attends in bf16, as the
    JAX fallback does."""
    jcfg, jparams, cfg, params = smoke
    jcfg, cfg = jcfg.replace(policy=policy), cfg.replace(policy=policy)
    jmodel = jax_get_model(jcfg)
    rng = np.random.default_rng(1)
    B, P, ps, maxp = 3, 8, 4, 4
    toks = rng.integers(0, cfg.vocab_size, (B, P))
    pages = np.arange(1, 1 + B * (P // ps)).reshape(B, P // ps)
    bt = np.zeros((B, maxp), np.int32)
    bt[:, :P // ps] = pages
    bt[:, P // ps] = np.arange(1 + B * (P // ps), 1 + B * (P // ps) + B)
    lengths = np.asarray([P, P - 3, 5], np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (B,))
    with numerics.use(**FORCED):
        _, jkv = jmodel.prefill(jparams, jnp.asarray(toks))
        jpools = jax_write_prompt_pages(
            jmodel.init_paged_cache(1 + B * maxp, ps), jkv,
            jnp.asarray(pages, jnp.int32))
        # both sides start from the same (bridged) page contents
        pools = jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x)),
                             jpools)
        jlogits, _ = jmodel.decode_step_paged(
            jparams, jpools, jnp.asarray(bt), jnp.asarray(lengths),
            jnp.asarray(nxt, jnp.int32))
    logits = get_model(cfg).decode_step_paged(
        params, pools, torch.from_numpy(bt), torch.from_numpy(lengths),
        torch.from_numpy(nxt))
    _close(logits.numpy(), jlogits)


ENGINE_CASES = {
    # prompt lengths, max_slots, num_pages, page_size, max_tokens
    "mixed-lengths": ([5, 12, 20, 9], 4, 33, 4, 6),
    "more-requests-than-slots": ([7, 3, 11, 6, 9, 4], 2, 17, 4, 5),
    "preemption": ([6, 7, 5], 3, 10, 4, 10),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_tokens_equal_jax(smoke, case):
    jcfg, jparams, cfg, params = smoke
    lens, slots, num_pages, ps, max_tokens = ENGINE_CASES[case]
    rng = np.random.default_rng(len(lens))
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    kw = dict(max_slots=slots, num_pages=num_pages, page_size=ps)
    with numerics.use(**FORCED):
        jeng = JaxEngine(jcfg, jparams, **kw)
        jout = jeng.run(prompts, JaxSamplingParams(max_tokens=max_tokens))
    eng = Engine(cfg, params, device="cpu", **kw)
    out = eng.run(prompts, SamplingParams(max_tokens=max_tokens))
    assert {r: list(v) for r, v in out.items()} == \
        {r: list(v) for r, v in jout.items()}
    assert {r: v.finish_reason for r, v in out.items()} == \
        {r: v.finish_reason for r, v in jout.items()}
    assert eng.stats()["preemptions"] == jeng.stats()["preemptions"]
    if case == "preemption":
        assert eng.stats()["preemptions"] > 0


def test_generate_equals_jax_generate(smoke):
    jcfg, jparams, cfg, params = smoke
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 8))
    with numerics.use(**FORCED):
        ref = np.asarray(jax_generate(jcfg, jparams, jnp.asarray(prompts), 6))
    out = serve.generate(cfg, params, prompts, 6, device="cpu")
    np.testing.assert_array_equal(out, ref)


def test_sampled_streams_are_per_request_and_deterministic(smoke):
    _, _, cfg, params = smoke
    prompts = [np.arange(5) + i for i in range(3)]
    sp = [SamplingParams(temperature=0.9, top_k=20, top_p=0.9, seed=s,
                         max_tokens=5) for s in (1, 2, 3)]
    a = Engine(cfg, params, max_slots=3, device="cpu").run(prompts, sp)
    b = Engine(cfg, params, max_slots=1, device="cpu").run(prompts, sp)
    assert a == b                     # batch composition changes nothing
    greedy = Engine(cfg, params, device="cpu").run(
        prompts, SamplingParams(max_tokens=5))
    top1 = Engine(cfg, params, device="cpu").run(
        prompts, SamplingParams(temperature=1.0, top_k=1, max_tokens=5))
    assert greedy == top1


def test_engine_rejects_and_stops(smoke):
    _, _, cfg, params = smoke
    eng = Engine(cfg, params, max_slots=2, num_pages=5, page_size=4,
                 device="cpu")
    with pytest.raises(RequestRejected):
        eng.add_request([1, 2, 3], SamplingParams(max_tokens=0))
    with pytest.raises(RequestRejected):
        eng.add_request(list(range(40)))          # beyond the page cap
    greedy = Engine(cfg, params, device="cpu").run(
        [[3, 4, 5]], SamplingParams(max_tokens=4))[0]
    out = eng.run([[3, 4, 5]], SamplingParams(max_tokens=4,
                                              stop_tokens=(greedy[1],)))
    assert list(out[0]) == greedy[:1] and out[0].finish_reason == "stop"


def test_page_pool_bookkeeping():
    pool = PagePool(4, 2)
    got = pool.alloc(3)
    assert sorted(got) == [1, 2, 3] and pool.alloc(1) is None
    pool.free(got[:1])
    with pytest.raises(PagePoolError):
        pool.free(got[:1])
    with pytest.raises(ValueError):
        PagePool(1, 2)


def test_bridge_round_trip_is_exact_for_narrow_dtypes():
    rng = np.random.default_rng(5)
    for dt in (jnp.bfloat16, jnp.float8_e4m3fn, jnp.float8_e5m2):
        x = np.asarray(jnp.asarray(rng.standard_normal(64) * 8, dt))
        t = tensor_from_numpy(x)
        back = numpy_from_tensor(t, x.dtype)
        assert back.dtype == x.dtype
        assert back.tobytes() == x.tobytes()
        np.testing.assert_array_equal(t.float().numpy(),
                                      x.astype(np.float32))


def test_serve_cli_runs_on_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--batch", "3", "--prompt-len",
                "6", "--gen", "4", "--max-slots", "2", "--device", "cpu"])
    assert "finish reasons: {'length': 3}" in capsys.readouterr().out


# ------------------------------------------------------------- sampler

def _knob_rows(V, reps=2):
    """Every (k, p) of k in {0, 1, 5, V + 3} x p in {0.3, 0.9, 1.0}, ``reps``
    rows each, in one batch: (top_k i32, top_p f32)."""
    ks, ps = np.meshgrid([0, 1, 5, V + 3], [0.3, 0.9, 1.0], indexing="ij")
    return (np.repeat(ks.ravel(), reps).astype(np.int32),
            np.repeat(ps.ravel(), reps).astype(np.float32))


def test_sample_masks_equal_jax():
    """The vectorized masks keep exactly what JAX's keep (same tie rules,
    same "off" values), bit for bit, on rows with many tied logits."""
    V = 40
    k, p = _knob_rows(V)
    rng = np.random.default_rng(11)
    # logits on a coarse grid: every row has ties, at the k-th value too
    logits = (np.round(rng.standard_normal((len(k), V)) * 2) / 2).astype(
        np.float32)
    t_logits = torch.from_numpy(logits)
    tk = sampling._top_k_mask(t_logits, torch.from_numpy(k))
    jk = jax_sampling._top_k_mask(jnp.asarray(logits), jnp.asarray(k))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    tp = sampling._top_p_mask(t_logits, torch.from_numpy(p))
    jp = jax_sampling._top_p_mask(jnp.asarray(logits), jnp.asarray(p))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    both = sampling._top_p_mask(tk, torch.from_numpy(p))
    jboth = jax_sampling._top_p_mask(jk, jnp.asarray(p))
    np.testing.assert_array_equal(both.numpy(), np.asarray(jboth))
    kept = (np.asarray(jboth) > sampling.NEG_INF / 2).sum(-1)
    assert kept.min() >= 1 and kept.max() == V       # masks on and off


def test_sample_inverse_cdf_draw():
    """A sampled row's token is the first index of its masked cumulative
    distribution (float64 numpy reference) that reaches its uniform; a
    greedy row's is the argmax.  The device sums f32 probabilities, which
    lie within ~V 2^-24 of the f64 ones, so a uniform within 1e-6 of a
    step of the distribution may land on either side of it."""
    V = 50
    k, p = _knob_rows(V, reps=5)
    B = len(k)
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((B, V)).astype(np.float32)
    temps = rng.uniform(0.5, 1.5, B).astype(np.float32)
    temps[::5] = 0.0                                   # greedy rows
    u = 1.0 - rng.random(B)                            # (0, 1]
    u[1] = 1.0
    tok = sampling.sample(torch.from_numpy(logits), torch.from_numpy(temps),
                          torch.from_numpy(k), torch.from_numpy(p),
                          torch.from_numpy(u)).numpy()
    masked = np.asarray(jax_sampling._top_p_mask(jax_sampling._top_k_mask(
        jnp.asarray(logits / np.maximum(temps, 1e-6)[:, None]),
        jnp.asarray(k)), jnp.asarray(p)), np.float64)
    for b in range(B):
        if temps[b] <= 0:
            assert tok[b] == int(np.argmax(logits[b]))
            continue
        keep = masked[b] > sampling.NEG_INF / 2
        w = np.where(keep, np.exp(masked[b] - masked[b][keep].max()), 0.0)
        cdf = np.cumsum(w / w.sum())
        ref = min(int(np.searchsorted(cdf, u[b], side="left")),
                  int(np.flatnonzero(keep)[-1]))
        assert keep[tok[b]]
        if tok[b] != ref:
            lo, hi = sorted((tok[b], ref))
            assert abs(cdf[lo] - u[b]) <= 1e-6 and hi == lo + 1, (b, tok[b],
                                                                   ref)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (6, 0.8)])
def test_sample_matches_jax_in_distribution(top_k, top_p):
    """Draws from seeded uniforms have JAX's support and pass a chi-square
    test against the masked softmax (p-value above 1e-3); JAX's own
    draws, from seeded keys, pass the same test."""
    from scipy import stats
    V, N, temp = 10, 20000, 0.8
    rng = np.random.default_rng(13)
    row = rng.standard_normal(V).astype(np.float32) * 1.5
    logits = np.tile(row, (N, 1))
    temps = np.full(N, temp, np.float32)
    ks = np.full(N, top_k, np.int32)
    pp = np.full(N, top_p, np.float32)
    gen = torch.Generator().manual_seed(0)
    u = 1.0 - torch.rand(N, generator=gen, dtype=torch.float64)
    tok = sampling.sample(torch.from_numpy(logits), torch.from_numpy(temps),
                          torch.from_numpy(ks), torch.from_numpy(pp),
                          u).numpy()
    masked = np.asarray(jax_sampling._top_p_mask(jax_sampling._top_k_mask(
        jnp.asarray(row[None] / temp), jnp.asarray(ks[:1])),
        jnp.asarray(pp[:1])), np.float64)[0]
    keep = masked > sampling.NEG_INF / 2
    w = np.where(keep, np.exp(masked - masked[keep].max()), 0.0)
    probs = w / w.sum()
    counts = np.bincount(tok, minlength=V)
    assert set(np.flatnonzero(counts)) == set(np.flatnonzero(keep))
    assert stats.chisquare(counts[keep], N * probs[keep]).pvalue > 1e-3
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jtok = np.asarray(jax_sampling.sample(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(ks),
        jnp.asarray(pp), keys))
    jcounts = np.bincount(jtok, minlength=V)
    assert set(np.flatnonzero(jcounts)) == set(np.flatnonzero(keep))
    assert stats.chisquare(jcounts[keep], N * probs[keep]).pvalue > 1e-3


def test_engine_mixed_batch_greedy_rows_equal_jax(smoke):
    """Greedy requests that share decode steps with sampled ones give
    exactly the JAX engine's tokens; the sampled ones only their count."""
    jcfg, jparams, cfg, params = smoke
    rng = np.random.default_rng(14)
    lens = [5, 9, 12, 4, 7, 10]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    knobs = [dict(), dict(temperature=0.9, top_k=20, top_p=0.9, seed=1),
             dict(), dict(temperature=1.2, seed=2), dict(),
             dict(temperature=0.7, top_p=0.5, seed=3)]
    kw = dict(max_slots=3, num_pages=33, page_size=4)
    with numerics.use(**FORCED):
        jout = JaxEngine(jcfg, jparams, **kw).run(
            prompts, [JaxSamplingParams(max_tokens=6, **k) for k in knobs])
    out = Engine(cfg, params, device="cpu", **kw).run(
        prompts, [SamplingParams(max_tokens=6, **k) for k in knobs])
    for rid, k in enumerate(knobs):
        assert out[rid].finish_reason == jout[rid].finish_reason == "length"
        assert len(out[rid]) == len(jout[rid]) == 6
        if not k:
            assert list(out[rid]) == list(jout[rid])
