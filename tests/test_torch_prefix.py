"""The port's prefix cache, chunked prefill and defragment against the JAX
package, on the CPU.

JAX's ``tests/test_prefix.py``, mirrored: the refcounted pool and the
prefix tree run the same operations in both packages and must agree
bitwise (refcounts, defrag mappings, matches, LRU order); the device
helpers (span writes, scratch loads, the defrag permutation) must land the
same bits; and the engine scenarios (the copy-on-write split of a hit on a
whole prompt, eviction under pool pressure, defragment mid-serve, chunked
prefill interleaved with decode, the poisoned lookup, the chunk fault's
requeue and its three strikes, the prefix counters in ``obs.snapshot()``)
give the JAX engine's greedy tokens and counters, and the port's own
knob-off tokens, with f32 pools.  ``prefill_chunk``'s logits are held to
JAX's within ``2^-13`` of their largest entry (f32 sums in another order)
for a dense, a windowed-and-softcapped and an MLA config, and the port's
chunked rows to its monolithic prefill's.

The JAX engine runs under ``numerics.use(force=True, interpret=True,
min_dim=0)``, as in ``tests/test_torch_serving.py``: its attention takes
the Pallas kernels in interpret mode, the port's the plain versions of
kernels 2 and 3.  Each JAX run is made once a module (``_jax_tokens``).
The arch-by-knob matrix is ``tests/test_torch_prefix_parity.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro import numerics as jnumerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import PagePool as JaxPagePool  # noqa: E402
from repro.serving import PagePoolError as JaxPagePoolError  # noqa: E402
from repro.serving import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch import faults, numerics, obs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.serving import (Engine, PagePool, PagePoolError,  # noqa: E402
                                 SamplingParams, kv_cache)
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
REL = 2.0 ** -13

# ========================================== refcounted pool and prefix tree
#
# Each scenario runs on one package's (PagePool, PrefixCache, error) and
# returns what it observed; the test runs it on both and compares.  The
# asserts inside are JAX's own.


def _toks(n, seed=0):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, 97, n)]


def _pool_share_and_free(Pool, Cache, Err):
    pool = Pool(8, 4)
    pages = pool.alloc(2)
    log = [pages, [pool.refcount(p) for p in pages]]
    pool.share(pages)
    log.append([pool.refcount(p) for p in pages])
    free_before = pool.num_free
    pool.free(pages)
    assert pool.num_free == free_before
    log.append([pool.refcount(p) for p in pages])
    pool.free(pages)
    assert pool.num_free == free_before + 2
    log += [[pool.refcount(p) for p in pages], pool.num_free]
    assert log[1] == [1, 1] and log[2] == [2, 2] and log[4] == [0, 0]
    return log


def _pool_share_of_non_live_raises(Pool, Cache, Err):
    pool = Pool(8, 4)
    with pytest.raises(Err):
        pool.share([3])
    pages = pool.alloc(1)
    pool.free(pages)
    with pytest.raises(Err):
        pool.share(pages)
    return [pages, pool.num_free]


def _pool_double_free(Pool, Cache, Err):
    pool = Pool(8, 4)
    pages = pool.alloc(1)
    pool.free(pages)
    with pytest.raises(Err):
        pool.free(pages)
    return [pages, pool.num_free]


def _pool_defrag(Pool, Cache, Err):
    pool = Pool(10, 4)
    a, b = pool.alloc(2), pool.alloc(2)
    pool.share(b)
    pool.free(a)
    mapping = pool.defrag()
    assert [pool.refcount(mapping[p]) for p in b] == [2, 2]
    assert sorted(mapping[p] for p in b) == [1, 2]
    return [sorted(mapping.items()), pool.num_free, pool.alloc(3)]


def _tree_insert_match(Pool, Cache, Err):
    pool = Pool(16, 4)
    cache = Cache(pool)
    toks = _toks(10)
    pages = pool.alloc(3)
    assert cache.insert(toks, pages) == 2
    got, matched = cache.match(toks)
    assert got == pages[:2] and matched == 8
    assert [pool.refcount(p) for p in pages] == [2, 2, 1]
    other = list(toks)
    other[5] = (other[5] + 1) % 97
    got2 = cache.match(other)
    assert got2 == (pages[:1], 4)
    return [pages, got, matched, got2, cache.n_nodes]


def _tree_insert_idempotent(Pool, Cache, Err):
    pool = Pool(16, 4)
    cache = Cache(pool)
    toks = _toks(8)
    pages = pool.alloc(2)
    assert cache.insert(toks, pages) == 2
    dup = pool.alloc(2)
    assert cache.insert(toks, dup) == 0
    assert [pool.refcount(p) for p in pages] == [2, 2]
    assert [pool.refcount(p) for p in dup] == [1, 1]
    return [pages, dup, cache.match(toks)]


def _tree_eviction_lru(Pool, Cache, Err):
    pool = Pool(16, 4)
    cache = Cache(pool)
    a, b = _toks(4, seed=1), _toks(4, seed=2)
    pa, pb = pool.alloc(1), pool.alloc(1)
    cache.insert(a, pa)
    cache.insert(b, pb)
    pool.free(pa)
    pool.free(pb)
    cache.match(a)                        # touch a: b becomes LRU
    log = [cache.evict_for(1), cache.match(b), cache.match(a)]
    assert log == [1, ([], 0), (pa, 4)]
    pool.share(pa)                        # shared with a request: kept
    log.append(cache.evict_for(1))
    pool.free(pa)
    log += [cache.evict_for(1), cache.n_nodes, pool.num_free,
            cache.n_evictions]
    assert log[3:6] == [0, 1, 0] and pool.num_free == pool.num_pages - 1
    return log


def _tree_eviction_deepest_first(Pool, Cache, Err):
    pool = Pool(16, 4)
    cache = Cache(pool)
    toks = _toks(12, seed=3)
    pages = pool.alloc(3)
    cache.insert(toks, pages)
    pool.free(pages)
    assert cache.evict_for(2) == 2
    got, matched = cache.match(toks)
    assert got == pages[:1] and matched == 4
    return [pages, got, pool.num_free]


def _tree_remap(Pool, Cache, Err):
    pool = Pool(16, 4)
    cache = Cache(pool)
    hole = pool.alloc(2)
    toks = _toks(8, seed=4)
    pages = pool.alloc(2)
    cache.insert(toks, pages)
    pool.free(pages)
    pool.free(hole)
    mapping = pool.defrag()
    cache.remap(mapping)
    got, matched = cache.match(toks)
    assert got == [mapping[p] for p in pages] and matched == 8
    assert all(pool.refcount(p) == 1 for p in got)
    return [sorted(mapping.items()), got, matched]


UNITS = {f.__name__[1:]: f for f in (
    _pool_share_and_free, _pool_share_of_non_live_raises, _pool_double_free,
    _pool_defrag, _tree_insert_match, _tree_insert_idempotent,
    _tree_eviction_lru, _tree_eviction_deepest_first, _tree_remap)}


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_pool_and_tree_equal_jax(unit):
    jax_log = UNITS[unit](JaxPagePool, JaxPrefixCache, JaxPagePoolError)
    port_log = UNITS[unit](PagePool, PrefixCache, PagePoolError)
    assert port_log == jax_log


def test_poisoned_match_is_a_miss_in_both_packages():
    toks = _toks(8, seed=5)
    seen = []
    for Pool, Cache, flt in ((JaxPagePool, JaxPrefixCache, jfaults),
                             (PagePool, PrefixCache, faults)):
        pool = Pool(8, 4)
        cache = Cache(pool)
        pages = pool.alloc(2)
        cache.insert(toks, pages)
        plan = flt.FaultPlan([flt.FaultSpec("prefix.lookup", at=(0,))])
        with flt.use(plan):
            seen.append((cache.match(toks), cache.match(toks)))
        assert plan.log == [("prefix.lookup", 0)]
    assert seen[0] == seen[1] == (([], 0), (pages, 8))


# ============================================================ device helpers

def _trees(seed=0, nL=2, NP=9, ps=4, T=16, Hkv=2, hd=8):
    rng = np.random.default_rng(seed)
    pools = {"dense_blocks": {
        k: rng.standard_normal((nL, NP, ps, Hkv, hd)).astype(np.float32)
        for k in ("k", "v")}}
    scratch = {"dense_blocks": {
        k: rng.standard_normal((nL, 1, T, Hkv, hd)).astype(np.float32)
        for k in ("k", "v")}}
    return pools, scratch


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _torch_tree(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_helpers_land_the_bits_jax_lands(dtype):
    """``write_span_pages``, ``load_pages_into_scratch`` and
    ``permute_pages`` (in place) against JAX's (functional), bitwise, on
    f32 and bf16 pools."""
    pools, scratch = _trees()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jpools = jax.tree.map(lambda x: jnp.asarray(x, jd), pools)
    tpools = jax.tree.map(lambda x: torch.from_numpy(x).to(td), pools)
    pages = [5, 2, 7]
    ref = jkv.write_span_pages(jpools, jax.tree.map(jnp.asarray, scratch),
                               jnp.int32(4), jnp.asarray(pages, jnp.int32))
    out = kv_cache.write_span_pages(tpools, _torch_tree(scratch), 4,
                                    torch.tensor(pages))
    assert out is tpools
    for a, b in zip(jax.tree.leaves(_np_tree(ref)),
                    jax.tree.leaves(jax.tree.map(
                        lambda t: t.float().numpy(), out))):
        assert np.array_equal(a, b)
    # a scratch loaded from those pages: the f32 of each pooled value
    jscr = jkv.load_pages_into_scratch(
        jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, scratch)),
        ref, jnp.asarray(pages[:2], jnp.int32))
    tscr = kv_cache.load_pages_into_scratch(
        jax.tree.map(torch.zeros_like, _torch_tree(scratch)), out,
        torch.tensor(pages[:2]))
    for a, b in zip(jax.tree.leaves(_np_tree(jscr)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 tscr))):
        assert np.array_equal(a, b)
    # the defrag permutation of a pool with holes
    jpool, tpool = JaxPagePool(9, 4), PagePool(9, 4)
    for p in (jpool, tpool):
        a = p.alloc(3)
        b = p.alloc(3)
        p.free(a[1:])
        p.share(b[:1])
    mapping = tpool.defrag()
    assert mapping == jpool.defrag()
    jperm = jkv.inverse_permutation(mapping, 9)
    tperm = kv_cache.inverse_permutation(mapping, 9)
    assert np.array_equal(np.asarray(jperm), tperm.numpy())
    jout = jkv.permute_pages(ref, jperm)
    tout = kv_cache.permute_pages(out, tperm)
    assert tout is out
    for a, b in zip(jax.tree.leaves(_np_tree(jout)),
                    jax.tree.leaves(jax.tree.map(
                        lambda t: t.float().numpy(), tout))):
        assert np.array_equal(a, b)


# ============================================================ the engine

_MODELS: dict = {}


def _models(arch):
    """JAX's smoke config, its ``init`` parameters, the port's config and
    the same parameters bridged (once a module)."""
    if arch not in _MODELS:
        jcfg = jax_smoke_config(arch)
        jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams),
                                 device="cpu")
        _MODELS[arch] = (jcfg, jparams, get_smoke_config(arch), params)
    return _MODELS[arch]


def _shared_prompts(vocab, B=3, P=24, shared=16, seed=0):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, vocab, (B, P))
    prompts[:, :shared] = prompts[0, :shared]
    return prompts


def _engine_kw(max_slots=2, num_pages=25, page_size=16, **kw):
    return dict(max_slots=max_slots, num_pages=num_pages,
                page_size=page_size, max_pages_per_slot=8, **kw)


_PREFIX_STATS = ("prefix_hits", "prefix_tokens_reused", "cow_splits",
                 "prefix_evictions", "prefill_chunks", "prefill_faults",
                 "prefills", "preemptions", "parks", "clock")


def _summary(eng, rids, out):
    stats = eng.stats()
    return ([list(out[r]) for r in rids],
            [out[r].finish_reason for r in rids],
            {k: stats[k] for k in _PREFIX_STATS})


def _run_jax(arch, prompts, knob, gen=4, plan=None, loop=None, **kw):
    jcfg, jparams, _, _ = _models(arch)
    with jnumerics.use(**FORCED):
        nc = jnumerics.active().replace(**knob)
        eng = JaxEngine(jcfg, jparams, numerics_config=nc,
                        cache_dtype=jnp.float32, **_engine_kw(**kw))
        rids = [eng.add_request(p, JaxSamplingParams(max_tokens=gen, seed=i))
                for i, p in enumerate(prompts)]
        with jfaults.use(plan):
            (loop or (lambda e, r: e.run()))(eng, rids)
        return _summary(eng, rids, eng.results())


def _run_port(arch, prompts, knob, gen=4, plan=None, loop=None, **kw):
    _, _, cfg, params = _models(arch)
    nc = numerics.active().replace(**knob)
    eng = Engine(cfg, params, numerics_config=nc, cache_dtype=torch.float32,
                 device="cpu", **_engine_kw(**kw))
    rids = [eng.add_request(p, SamplingParams(max_tokens=gen, seed=i))
            for i, p in enumerate(prompts)]
    with faults.use(plan):
        (loop or (lambda e, r: e.run()))(eng, rids)
    return _summary(eng, rids, eng.results()), eng


_JAX: dict = {}


def _jax_tokens(name, *a, **kw):
    """Each JAX engine run once a module, keyed by the scenario's name."""
    if name not in _JAX:
        _JAX[name] = _run_jax(*a, **kw)
    return _JAX[name]


def _prompts(kind):
    vocab = get_smoke_config("qwen3-0.6b").vocab_size
    if kind == "shared":
        return _shared_prompts(vocab)
    if kind == "whole":
        return np.tile(_shared_prompts(vocab, B=1, P=32, shared=32), (3, 1))
    return np.random.default_rng(1).integers(0, vocab, (3, 32))


def test_full_prompt_hit_forces_deterministic_cow_split():
    """Identical prompts: the last position is always recomputed, so each
    hit rewrites its shared last page through a copy-on-write split."""
    prompts = _prompts("whole")
    knob = dict(prefix_cache=True)
    ref = _jax_tokens("cow", "qwen3-0.6b", prompts, knob, max_slots=1)
    got, _ = _run_port("qwen3-0.6b", prompts, knob, max_slots=1)
    off, _ = _run_port("qwen3-0.6b", prompts, {}, max_slots=1)
    assert got == ref
    assert got[0] == off[0]
    stats = got[2]
    assert stats["prefix_hits"] == 2 and stats["cow_splits"] == 2
    assert stats["prefix_tokens_reused"] == 32


def test_eviction_under_pool_pressure_keeps_parity():
    prompts = _prompts("distinct")
    knob = dict(prefix_cache=True)
    ref = _jax_tokens("evict", "qwen3-0.6b", prompts, knob, max_slots=1,
                      num_pages=5)
    got, _ = _run_port("qwen3-0.6b", prompts, knob, max_slots=1,
                       num_pages=5)
    off, _ = _run_port("qwen3-0.6b", prompts, {}, max_slots=1, num_pages=5)
    assert got == ref
    assert got[0] == off[0]
    assert got[2]["prefix_evictions"] >= 1


def _defrag_after_first(eng, rids):
    while not any(eng._requests[r].finished for r in rids):
        eng.step()
    eng.defragment()                      # cached pages move mid-serve
    eng.run()


def test_shared_prefix_then_defrag_stays_token_identical():
    prompts = _prompts("shared")
    knob = dict(prefix_cache=True)
    ref = _jax_tokens("defrag", "qwen3-0.6b", prompts, knob, max_slots=1,
                      loop=_defrag_after_first)
    got, eng = _run_port("qwen3-0.6b", prompts, knob, max_slots=1,
                         loop=_defrag_after_first)
    off, _ = _run_port("qwen3-0.6b", prompts, {}, max_slots=1)
    assert got == ref
    assert got[0] == off[0]
    assert got[2]["prefix_hits"] >= 1
    stack = list(eng.prefix._children.values())
    while stack:                          # every node's page is live
        node = stack.pop()
        assert eng.pool.refcount(node.page) >= 1
        stack.extend(node.children.values())
    assert eng.pool.num_live == eng.prefix.n_nodes


def test_defragment_with_a_step_in_flight_and_a_prefill_in_chunks():
    """``all`` the knobs: defragment lands the in-flight decode step first
    and moves a chunked prefill's pages too; tokens as knob-off."""
    prompts = _prompts("shared")
    knob = dict(prefix_cache=True, chunked_prefill=16, async_sched=True)

    def drive(eng, rids):
        eng.step()
        eng.step()
        assert eng._inflight is not None
        eng.defragment()
        assert eng._inflight is None
        eng.run()

    ref = _jax_tokens("defrag-all", "qwen3-0.6b", prompts, knob,
                      loop=drive)
    got, _ = _run_port("qwen3-0.6b", prompts, knob, loop=drive)
    off, _ = _run_port("qwen3-0.6b", prompts, {})
    assert got == ref
    assert got[0] == off[0]


def test_preemption_storm_with_defragment_equals_jax():
    """JAX's ``test_preemption_storm_parks_and_recovers``: a pool sized to
    thrash, ``max_preemptions=1``, and a defragment mid-storm (after step
    5); page accounting holds after every step, every request finishes,
    tokens and counters equal the JAX engine's and the run without the
    defragment's."""
    _, _, cfg, _ = _models("qwen3-0.6b")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (4, 4, 6)]
    kw = dict(gen=16, num_pages=8, page_size=4, max_preemptions=1)

    def drive(eng, rids):
        steps = 0
        while eng.sched.has_work:
            eng.step()
            if steps == 5:
                eng.defragment()
            steps += 1
            held = sum(len(r.pages) for r in eng.sched.running.values())
            assert eng.pool.num_free + held == eng.pool.num_pages - 1
            assert steps <= 500

    ref = _jax_tokens("storm", "qwen3-0.6b", prompts, {}, loop=drive,
                      **kw)
    got, eng = _run_port("qwen3-0.6b", prompts, {}, loop=drive, **kw)
    plain, _ = _run_port("qwen3-0.6b", prompts, {}, **kw)
    assert got == ref
    assert got[0] == plain[0] and got[1] == ["length"] * 3
    assert got[2]["preemptions"] >= 2 and got[2]["parks"] >= 1
    assert eng.pool.num_live == 0


def test_chunked_prefill_interleaves_with_decode():
    """A long prompt admitted behind a running request does not stall it:
    one chunk a step while the short request decodes."""
    _, _, cfg, _ = _models("qwen3-0.6b")
    rng = np.random.default_rng(2)
    short, long = rng.integers(0, cfg.vocab_size, (2, 64))
    prompts = [short[:16], long]
    progress = []

    def drive(eng, rids):
        eng.step()                        # r0 prefills; r1 starts chunking
        r0, r1 = (eng._requests[r] for r in rids)
        progress.append(r1.prefill_done)
        before = len(r0.out)
        eng.step()                        # r1 still chunking, r0 decodes
        progress.append(len(r0.out) - before)
        eng.run()

    knob = dict(chunked_prefill=16)
    ref = _jax_tokens("interleave", "qwen3-0.6b", prompts, knob, gen=8,
                      num_pages=16, loop=drive)
    got, eng = _run_port("qwen3-0.6b", prompts, knob, gen=8, num_pages=16,
                         loop=drive)
    off, _ = _run_port("qwen3-0.6b", prompts, {}, gen=8, num_pages=16)
    assert got == ref
    assert got[0] == off[0]
    assert progress[0] > 0 and progress[1] > 0          # JAX, then port
    assert progress[2:] == progress[:2]
    assert eng.n_prefill_chunks == 4      # 64 tokens / 16-token chunks


def test_poisoned_lookup_degrades_to_full_prefill_identically():
    prompts = _prompts("shared")
    knob = dict(prefix_cache=True)
    spec = [("prefix.lookup", dict(every=1))]
    jplan = jfaults.FaultPlan([jfaults.FaultSpec(s, **kw) for s, kw in spec])
    plan = faults.FaultPlan([faults.FaultSpec(s, **kw) for s, kw in spec])
    ref = _jax_tokens("poison", "qwen3-0.6b", prompts, knob, plan=jplan)
    got, _ = _run_port("qwen3-0.6b", prompts, knob, plan=plan)
    off, _ = _run_port("qwen3-0.6b", prompts, {})
    assert got == ref
    assert got[0] == off[0]
    assert got[2]["prefix_hits"] == 0
    assert plan.log == jplan.log and plan.log
    assert all(s == "prefix.lookup" for s, _ in plan.log)


def test_chunk_fault_requeues_request_token_identically():
    prompts = _prompts("shared")
    knob = dict(prefix_cache=True, chunked_prefill=16)
    jplan = jfaults.FaultPlan([jfaults.FaultSpec("prefill.chunk", at=(0,))])
    plan = faults.FaultPlan([faults.FaultSpec("prefill.chunk", at=(0,))])
    ref = _jax_tokens("chunk-fault", "qwen3-0.6b", prompts, knob, plan=jplan)
    got, _ = _run_port("qwen3-0.6b", prompts, knob, plan=plan)
    off, _ = _run_port("qwen3-0.6b", prompts, {})
    assert got == ref
    assert got[0] == off[0]
    assert got[2]["prefill_faults"] == 1
    assert plan.log == jplan.log == [("prefill.chunk", 0)]


def test_chunk_fault_three_strikes_finishes_with_error():
    prompts = _prompts("shared")[:1, :]
    prompts = np.concatenate([prompts, prompts[:, :8]], axis=1)   # 32
    knob = dict(chunked_prefill=16)
    jplan = jfaults.FaultPlan([jfaults.FaultSpec("prefill.chunk", every=1)])
    plan = faults.FaultPlan([faults.FaultSpec("prefill.chunk", every=1)])
    ref = _jax_tokens("three-strikes", "qwen3-0.6b", prompts, knob,
                      plan=jplan, max_slots=1)
    got, eng = _run_port("qwen3-0.6b", prompts, knob, plan=plan,
                         max_slots=1)
    assert got == ref
    assert got[0] == [[]] and got[1] == ["error"]
    assert got[2]["prefill_faults"] == Engine.MAX_PREFILL_FAULTS
    assert eng.pool.num_live == 0         # a failed chunked prefill leaks
    assert plan.log == jplan.log


def test_prefix_stats_surface_in_engine_and_obs_snapshot():
    prompts = _prompts("whole")[:2]
    knob = dict(prefix_cache=True)
    ref = _jax_tokens("obs", "qwen3-0.6b", prompts, knob, max_slots=1)
    got, eng = _run_port("qwen3-0.6b", prompts, knob, max_slots=1)
    assert got == ref
    stats = eng.stats()
    src = obs.snapshot()["sources"]["serving/engine"]
    for key in ("prefix_hits", "prefix_tokens_reused", "cow_splits",
                "prefix_evictions", "prefill_chunks"):
        assert key in stats and key in src
    assert src["prefix_hits"] >= stats["prefix_hits"] >= 1
    assert src["prefix_tokens_reused"] >= stats["prefix_tokens_reused"]


def test_cache_dtype_takes_bf16_or_f32():
    _, _, cfg, params = _models("qwen3-0.6b")
    for dt in (torch.bfloat16, torch.float32):
        eng = Engine(cfg, params, device="cpu", cache_dtype=dt,
                     **_engine_kw())
        assert all(t.dtype == dt for t in tree_leaves(eng.pools))
    with pytest.raises(ValueError):
        Engine(cfg, params, device="cpu", cache_dtype=torch.float16,
               **_engine_kw())


# ============================================================ prefill_chunk

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b",
                                  "deepseek-v3-671b"])
def test_prefill_chunk_logits_match_jax(arch):
    """Three 16-token chunks over an f32 scratch of 48: each chunk's logits
    against JAX's ``prefill_chunk`` (2^-13 of the largest), and the port's
    chunked logits against its monolithic prefill's (the same tolerance;
    the MoE family's routing groups are the chunk's, so deepseek's are
    compared with JAX's chunks only)."""
    jcfg, jparams, cfg, params = _models(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 48))
    jmodel, model = jax_get_model(jcfg), get_model(cfg)
    jscr = jmodel.init_cache(1, 48, dtype=jnp.float32)
    scr = model.init_cache(1, 48, dtype=torch.float32, device="cpu")
    rows = []
    for start in (0, 16, 32):
        with jnumerics.use(**FORCED):
            jl, jscr = jmodel.prefill_chunk(
                jparams, jscr, jnp.asarray(toks[:, start:start + 16]),
                jnp.int32(start))
        out = model.prefill_chunk(
            params, scr, torch.from_numpy(toks[:, start:start + 16]), start)
        jl = np.asarray(jl, np.float64)
        assert np.max(np.abs(out.numpy() - jl)) <= REL * np.max(np.abs(jl))
        rows.append(out)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jscr)),
                    jax.tree.leaves(jax.tree.map(
                        lambda t: t.numpy(), scr))):
        assert np.max(np.abs(a - b)) <= REL * max(np.max(np.abs(a)), 1e-30)
    if not cfg.n_experts:
        mono, _ = model.prefill(params, torch.from_numpy(toks))
        chunked = torch.cat(rows, dim=1)
        assert float((chunked - mono).abs().max()) <= REL * float(
            mono.abs().max())
