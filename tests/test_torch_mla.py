"""The port's MLA attention and multi-token prediction (deepseek-v3-671b)
against the JAX package, on the CPU.

The deepseek-v3-671b smoke config (3 layers: 1 dense MLA layer and 2 MoE
layers, d_model 64, 4 heads, q rank 32, kv rank 16, nope 16 + rope 8, v
16, 4 experts top 2 and a shared expert, the MTP head on), parameters from
the JAX ``lm.init`` bridged exactly.  JAX runs its plain reference (the
term expansion; no Pallas kernel is forced), jitted, and the model is
built once for the module; the port runs its kernels' plain versions.

Routes are recorded on both sides, as in ``test_torch_moe.py`` (JAX's
``lax.top_k`` through a debug callback, the port's ``layers.moe_route``),
and a model's outputs are compared only where no route moved.

Tolerances, as in ``test_torch_moe.py`` but the gradients': ``2^-13`` of the largest entry
where only f32 products enter (the MLA layer's prefill outputs and latent
entries, the first, dense layer's entries in a model: f32-accurate
products summed in another order); ``2^-8`` where JAX's bf16 roundings
enter, since the two sides' f32 values may round to neighbouring bf16
values: everything after a MoE layer (its dispatch and combine products
round the experts' inputs and outputs to bf16: the logits, the later
layers' entries), MLA's latent attend at decode (three ``bf16`` products)
and the bf16 cache entries a decode step writes; ``2^-7`` for each
gradient leaf (the bf16 products' backward rounds its cotangent to bf16:
JAX against itself, with its parameters perturbed by 1e-7 relative, moves
this model's leaves by up to 5.9e-3 of their largest entries, the
routers' and ``w_down``'s most, where granite's moved 3e-4); the loss and
its metrics ``2^-17`` relative as in ``test_torch_train.py``.  Greedy
tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.serve import (  # noqa: E402
    fill_dense_cache as jax_fill_dense_cache,
    generate_dense as jax_generate_dense)
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import mla as jax_mla  # noqa: E402
from repro.serving.kv_cache import (  # noqa: E402
    write_prompt_pages as jax_write_prompt_pages)
from repro_torch.bridge import params_from_jax, tensor_from_numpy  # noqa
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, host_batch  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch.serve import generate, generate_dense  # noqa: E402
from repro_torch.models import get_model, layers, lm, mla  # noqa: E402
from repro_torch.models.modules import layer, tree_leaves, tree_map  # noqa

ARCH = "deepseek-v3-671b"
REL = 2.0 ** -13
BF16 = 2.0 ** -8


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config(ARCH)
    jmodel = jax_get_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jmodel, jparams, get_smoke_config(ARCH), params


class Routes:
    """Every routing decision of both sides, in call order: JAX's top-k
    indices and the port's :func:`layers.moe_route` dicts."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        top_k, route = jax.lax.top_k, layers.moe_route

        def jax_top_k(x, k):
            v, i = top_k(x, k)
            jax.debug.callback(lambda a: self.jax.append(np.asarray(a)), i,
                               ordered=True)
            return v, i

        def port_route(*a):
            self.port.append(route(*a))
            return self.port[-1]

        monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
        monkeypatch.setattr(layers, "moe_route", port_route)

    def moved(self) -> int:
        """Tokens whose expert sets differ (printed); both sides must have
        routed the same calls."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.port) > 0
        n = sum(int((np.sort(j, -1) != np.sort(r["topi"].numpy(), -1))
                    .any(-1).sum()) for j, r in zip(self.jax, self.port))
        print(f"routes: {n} tokens moved to another expert set")
        return n

    def clear(self):
        jax.effects_barrier()
        self.jax.clear()
        self.port.clear()


@pytest.fixture
def routes(monkeypatch):
    return Routes(monkeypatch)


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_trees(tree, jtree, rel):
    """Leaf by leaf, by key (JAX's trees order their keys)."""
    assert sorted(tree) == sorted(jtree)
    for k in tree:
        if isinstance(tree[k], dict):
            _close_trees(tree[k], jtree[k], rel)
        else:
            _close(tree[k].float().numpy(), _np(jtree[k]), rel)


def _attn(jparams, params):
    """Layer 0's MLA parameters on both sides."""
    jp = jax.tree.map(lambda a: a[0], jparams["dense_blocks"])["attn"]
    return jp, layer(params["dense_blocks"], 0)["attn"]


# ------------------------------------------------------------- layer

def test_mla_attention_prefill_matches_jax(smoke):
    jcfg, _, jparams, cfg, params = smoke
    jp, p = _attn(jparams, params)
    B, S = 2, 12
    x = np.random.default_rng(1).standard_normal((B, S, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jout, jkv = jax.jit(lambda p_, x_: jax_mla.mla_attention_prefill(
        p_, x_, jcfg, jnp.asarray(pos)))(jp, jnp.asarray(x))
    out, kv = mla.mla_attention_prefill(p, torch.from_numpy(x), cfg,
                                        torch.from_numpy(pos.copy()))
    _close(out.numpy(), jout)
    assert sorted(kv) == sorted(jkv) == ["c_kv", "k_rope"]
    assert kv["c_kv"].shape == (B, S, cfg.kv_lora_rank)
    assert kv["k_rope"].shape == (B, S, cfg.qk_rope_dim)
    for k in kv:
        _close(kv[k].numpy(), jkv[k])
    assert torch.equal(out, mla.mla_attention(
        p, torch.from_numpy(x), cfg, torch.from_numpy(pos.copy())))


def _latent_cache(jcfg, jp, B, P, T, seed):
    """A dense bf16 latent cache of length T whose first P positions hold
    JAX's prefill entries of random inputs, on both sides."""
    x = np.random.default_rng(seed).standard_normal(
        (B, P, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[None], (B, P))
    _, kv = jax.jit(jax_mla.mla_attention_prefill, static_argnums=(2,))(
        jp, jnp.asarray(x), jcfg, pos)
    jc = jax_mla.mla_init_cache(jcfg, B, T)
    jc = {k: jc[k].at[:, :P].set(kv[k].astype(jc[k].dtype)) for k in jc}
    return jc, {k: tensor_from_numpy(np.asarray(v)) for k, v in jc.items()}


def test_mla_decode_over_a_dense_cache_matches_jax(smoke):
    jcfg, _, jparams, cfg, params = smoke
    jp, p = _attn(jparams, params)
    B, P, T = 3, 9, 16
    jc, cache = _latent_cache(jcfg, jp, B, P, T, seed=2)
    x = np.random.default_rng(3).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    jout, jnew = jax.jit(jax_mla.mla_decode, static_argnums=(2,))(
        jp, jnp.asarray(x), jcfg, jc, P)
    out, new = mla.mla_decode(p, torch.from_numpy(x), cfg, cache, P)
    assert new is cache                  # written in place
    assert cache["c_kv"].dtype == torch.bfloat16
    _close(out.numpy(), jout, BF16)
    for k in cache:
        _close(cache[k].float().numpy(), _np(jnew[k]), BF16)
        # only position P was written
        np.testing.assert_array_equal(
            np.delete(cache[k].float().numpy(), P, axis=1),
            np.delete(_np(jc[k]), P, axis=1))


def test_mla_decode_paged_matches_jax_and_the_dense_decode(smoke):
    """Ragged slots over pages; then, with every slot at one position, the
    paged decode is bitwise the port's dense decode over the same rows."""
    jcfg, _, jparams, cfg, params = smoke
    jp, p = _attn(jparams, params)
    B, P, ps, maxp = 3, 12, 4, 4
    jc, _ = _latent_cache(jcfg, jp, B, P, P, seed=4)
    pages = np.arange(1, 1 + B * maxp, dtype=np.int32).reshape(B, maxp)
    jpool = {k: jnp.zeros((1 + B * maxp, ps, v.shape[-1]), v.dtype)
             for k, v in jc.items()}
    jpool = {k: jpool[k].at[pages[:, :P // ps].reshape(-1)].set(
        jc[k].reshape(-1, ps, jc[k].shape[-1])) for k in jpool}
    x = np.random.default_rng(5).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    step = jax.jit(jax_mla.mla_decode_paged, static_argnums=(2,))

    def both(lengths):
        pool = {k: tensor_from_numpy(np.asarray(v)) for k, v in
                jpool.items()}
        jout, jnew = step(jp, jnp.asarray(x), jcfg, jpool,
                          jnp.asarray(pages), jnp.asarray(lengths))
        out = mla.mla_decode_paged(p, torch.from_numpy(x), cfg, pool,
                                   torch.from_numpy(pages),
                                   torch.from_numpy(lengths))
        return out, pool, jout, jnew

    out, pool, jout, jnew = both(np.asarray([P, 5, 9], np.int32))
    _close(out.numpy(), jout, BF16)
    for k in pool:
        _close(pool[k].float().numpy(), _np(jnew[k]), BF16)
    # every slot at position P: the dense decode over the slots' own rows
    out, _, _, _ = both(np.full(B, P, np.int32))
    cache = {k: torch.zeros((B, maxp * ps, v.shape[-1]), dtype=torch.bfloat16)
             for k, v in jc.items()}
    for k in cache:
        cache[k][:, :P] = tensor_from_numpy(np.asarray(jc[k]))
    dense, _ = mla.mla_decode(p, torch.from_numpy(x), cfg, cache, P)
    assert torch.equal(out, dense)


@pytest.mark.parametrize("spec,key,a_shape", [
    ("bshk,rhk->bshr", "w_uk", (4, 1, 128, 128)),
    ("bshr,rhk->bshk", "w_uv", (4, 1, 128, 512)),
    ("bsr,rhk->bshk", "w_uk", (4, 1, 512))])
def test_kernel_1_reads_the_absorbed_weights_in_place(spec, key, a_shape,
                                                      monkeypatch):
    """Kernel 1's operand B for MLA's products at full width (128 heads of
    128, kv rank 512), as ``pdot`` hands it over: the absorbed decode's
    per-head views of ``w_uk`` and ``w_uv`` (batch stride k, row stride h
    k, and that view's transpose) and the prefill's ``(r, h k)`` keep the
    weight's storage."""
    H, k, r = 128, 128, 512
    w = torch.randn(r, H, k)
    seen = []
    canon = dispatch._canonicalize
    monkeypatch.setattr(dispatch, "_canonicalize",
                        lambda *a: seen.append(canon(*a)) or seen[-1])
    out = mla.pdot(spec, torch.randn(a_shape), w, "tcec_bf16x6")
    assert len(seen) == 1
    b3 = seen[0][1]
    assert b3.untyped_storage().data_ptr() == w.untyped_storage().data_ptr()
    assert dispatch.b_layout(b3) is not None
    if spec.startswith("bsh"):
        assert b3.shape[0] == H and b3.stride(0) == k
        assert H * k in b3.stride()[-2:]
    assert out.shape == (4, 1, H, r if spec.endswith("bshr") else k)


# ------------------------------------------------------------- model

def test_forward_logits_match_jax(smoke, routes):
    jcfg, jmodel, jparams, cfg, params = smoke
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 20))
    jlogits = jax.jit(jmodel.forward_logits)(
        jparams, {"tokens": jnp.asarray(toks)})
    logits = get_model(cfg).forward_logits(params, torch.from_numpy(toks))
    assert logits.shape == (2, 20, cfg.padded_vocab)
    if routes.moved() == 0:
        _close(logits.numpy(), jlogits, BF16)


def test_prefill_logits_and_latent_cache_match_jax(smoke, routes):
    jcfg, jmodel, jparams, cfg, params = smoke
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16))
    jlogits, jkv = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    logits, kv = get_model(cfg).prefill(params, torch.from_numpy(toks))
    stacks = {n: k for n, k, _ in lm.stacks(cfg)}
    assert stacks == {"dense_blocks": 1, "moe_blocks": 2}
    assert sorted(kv) == sorted(jkv) == sorted(stacks)
    for name, n in stacks.items():
        assert sorted(kv[name]) == sorted(jkv[name]) == ["c_kv", "k_rope"]
        assert kv[name]["c_kv"].shape == (n, 2, 16, cfg.kv_lora_rank)
        assert kv[name]["k_rope"].shape == (n, 2, 16, cfg.qk_rope_dim)
    _close_trees(kv["dense_blocks"], jkv["dense_blocks"], REL)
    if routes.moved() == 0:
        _close(logits.numpy(), jlogits, BF16)
        _close_trees(kv["moe_blocks"], jkv["moe_blocks"], BF16)


def test_decode_steps_over_the_dense_cache_match_jax(smoke, routes):
    """Prefill 3 x 10, then three ``decode_step``s over the dense latent
    cache (updated in place); logits and the caches each step."""
    jcfg, jmodel, jparams, cfg, params = smoke
    model = get_model(cfg)
    rng = np.random.default_rng(8)
    B, P, T = 3, 10, 16
    toks = rng.integers(0, cfg.vocab_size, (B, P))
    jstep = jax.jit(jmodel.decode_step)
    _, jkv = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    jc = jax_fill_dense_cache(jmodel.init_cache(B, T), jkv)
    cache = tree_map(lambda t: tensor_from_numpy(np.asarray(t)), jc)
    assert {n: sorted(c) for n, c in cache.items()} == {
        n: ["c_kv", "k_rope"] for n in ("dense_blocks", "moe_blocks")}
    fresh = model.init_cache(B, T, device="cpu")
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(tree_leaves(fresh), tree_leaves(cache)))
    routes.clear()
    for i in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jlogits, jc = jstep(jparams, jc, jnp.asarray(nxt), P + i)
        logits, new = model.decode_step(params, cache, torch.from_numpy(nxt),
                                        P + i)
        assert new is cache
        if routes.moved() == 0:
            _close(logits.numpy(), jlogits, BF16)
            _close_trees(cache, jc, BF16)
        routes.clear()


def test_decode_steps_over_pages_match_jax(smoke, routes):
    """Prefill 3 ragged prompts into pages, then three
    ``decode_step_paged``s, the slots at unequal depths."""
    jcfg, jmodel, jparams, cfg, params = smoke
    model = get_model(cfg)
    rng = np.random.default_rng(9)
    B, P, ps, maxp = 3, 8, 4, 4
    toks = rng.integers(0, cfg.vocab_size, (B, P))
    pages = np.arange(1, 1 + B * maxp, dtype=np.int32).reshape(B, maxp)
    lengths = np.asarray([P, P - 3, 5], np.int32)
    _, jkv = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    jpools = jax_write_prompt_pages(jmodel.init_paged_cache(1 + B * maxp, ps),
                                    jkv, jnp.asarray(pages[:, :P // ps]))
    pools = tree_map(lambda t: tensor_from_numpy(np.asarray(t)), jpools)
    fresh = model.init_paged_cache(1 + B * maxp, ps, device="cpu")
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in
               zip(tree_leaves(fresh), tree_leaves(pools)))
    jstep = jax.jit(jmodel.decode_step_paged)
    routes.clear()
    for i in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
        jlogits, jpools = jstep(jparams, jpools, jnp.asarray(pages),
                                jnp.asarray(lengths + i), jnp.asarray(nxt))
        logits = model.decode_step_paged(
            params, pools, torch.from_numpy(pages),
            torch.from_numpy(lengths + i), torch.from_numpy(nxt))
        if routes.moved() == 0:
            _close(logits.numpy(), jlogits, BF16)
            _close_trees(pools, jpools, BF16)
        routes.clear()


def test_engine_and_generate_dense_tokens_equal_jax(smoke):
    """3 prompts of 16 tokens, 6 greedy tokens each: JAX's
    ``generate_dense`` (the dense oracle) against the port's engine
    (``generate``: one slot a prompt, the three prefilled together, so
    their MoE groups are the oracle's) and the port's ``generate_dense``."""
    jcfg, _, jparams, cfg, params = smoke
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (3, 16))
    ref = np.asarray(jax_generate_dense(jcfg, jparams, jnp.asarray(prompts),
                                        6))
    assert generate_dense(cfg, params, prompts, 6, device="cpu").tolist() \
        == ref.tolist()
    assert generate(cfg, params, prompts, 6, device="cpu").tolist() \
        == ref.tolist()


def test_loss_with_mtp_and_grads_match_jax_value_and_grad(smoke, routes):
    """``loss_fn`` = lm + 0.01 aux + 0.3 mtp, its metrics and the gradient
    of every leaf (``mtp_block`` and ``mtp_proj`` included) against JAX's
    ``value_and_grad``; remat on, as configured."""
    jcfg, jmodel, jparams, cfg, params = smoke
    assert cfg.mtp and cfg.remat
    nb = host_batch(cfg, DataConfig(seed=0, global_batch=2, seq_len=16), 4)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn, has_aux=True))(jparams, jax.tree.map(jnp.asarray, nb))
    jax.effects_barrier()
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, met = get_model(cfg).loss_fn(
        p, {k: torch.from_numpy(v) for k, v in nb.items()})
    loss.backward()
    # the forward's routes: the MoE layers', then the MTP block's; remat
    # routes each layer again in the backward
    n = dict((name, k) for name, k, _ in lm.stacks(cfg))["moe_blocks"] + 1
    routes.jax, routes.port = routes.jax[:n], routes.port[:n]
    assert routes.moved() == 0
    met = {k: float(v.detach()) for k, v in met.items()}
    assert sorted(met) == sorted(jmet) == ["aux_loss", "lm_loss", "loss",
                                           "mtp_loss", "tokens"]
    for k in met:
        _close(met[k], float(jmet[k]), 2.0 ** -17)
    _close(met["loss"], met["lm_loss"] + 0.01 * met["aux_loss"]
           + 0.3 * met["mtp_loss"], 2.0 ** -22)

    def walk(t, j, path=""):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j), path
            for k in t:
                walk(t[k], j[k], f"{path}/{k}")
        else:
            assert t.grad is not None, path
            _close(t.grad.numpy(), j, 2.0 ** -7)

    assert {"mtp_block", "mtp_proj"} <= set(p)
    walk(p, jgrads)


def test_bridge_maps_every_mla_and_mtp_leaf(smoke):
    """``params_from_jax`` carries JAX's tree key for key and bit for bit,
    and the port's own ``init`` makes the same tree: the MLA leaves in both
    stacks, the shared expert, ``mtp_block`` (a MoE block) and
    ``mtp_proj``."""
    jcfg, _, jparams, cfg, params = smoke
    own = lm.init(cfg, seed=0, device="cpu")

    def walk(t, o, j, path=""):
        if isinstance(j, dict):
            assert sorted(t) == sorted(o) == sorted(j), path
            for k in j:
                walk(t[k], o[k], j[k], f"{path}/{k}")
        else:
            j = np.asarray(j)
            assert t.shape == o.shape == j.shape, path
            assert t.dtype == o.dtype == torch.float32, path
            np.testing.assert_array_equal(t.numpy(), j)

    walk(params, own, jparams)
    attn = layer(params["moe_blocks"], 0)["attn"]
    assert sorted(attn) == ["kv_norm", "q_norm", "w_dkv", "w_dq", "w_kr",
                            "w_uk", "w_uq", "w_uv", "wo"]
    assert "shared" in params["mtp_block"]["moe"]
    assert params["mtp_proj"].shape == (2 * cfg.d_model, cfg.d_model)


# The configs whose MLA and MTP the port refused until this slice: they
# build, serve a latent cache, and give JAX's loss and metrics.
@pytest.mark.parametrize("arch,kw", [
    (ARCH, dict(mtp=False)),
    ("granite-moe-1b-a400m", dict(mtp=True))])
def test_mla_and_mtp_configs_run_and_match_jax(arch, kw, routes):
    import dataclasses
    jcfg = jax_smoke_config(arch).replace(**kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jmodel = jax_get_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert ("mtp_block" in params) == cfg.mtp
    pools = get_model(cfg).init_paged_cache(5, 4, device="cpu")
    assert sorted(pools["moe_blocks"]) == (
        ["c_kv", "k_rope"] if cfg.use_mla else ["k", "v"])
    nb = host_batch(cfg, DataConfig(seed=1, global_batch=2, seq_len=12), 0)
    jloss, jmet = jax.jit(jmodel.loss_fn)(jparams,
                                          jax.tree.map(jnp.asarray, nb))
    with torch.no_grad():
        loss, met = get_model(cfg).loss_fn(
            params, {k: torch.from_numpy(v) for k, v in nb.items()})
    assert sorted(met) == sorted(jmet)
    assert ("mtp_loss" in met) == cfg.mtp
    assert np.isfinite(float(loss))
    if routes.moved() == 0:
        for k in met:
            _close(float(met[k]), float(jmet[k]), 2.0 ** -17)
