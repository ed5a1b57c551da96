"""The port's MoE family against the JAX package, on the CPU.

The granite-moe-1b-a400m smoke config (2 layers, d_model 64, 4 experts top
2, groups of up to 64 tokens), parameters from the JAX ``lm.init`` bridged
exactly; the JAX side runs under ``numerics.use(force=True, interpret=True,
min_dim=0)`` as the serving tests do, the port runs its kernels' plain
versions.

Routing first.  A route is a token's choice of one expert.  Two f32
routers that differ in their last bits can swap a token's K-th and
(K+1)-th expert, and one moved route changes that token's output far
beyond any product tolerance.  So every test records the routes on both
sides (JAX's ``lax.top_k`` through a debug callback, the port's
``layers.moe_route``) and compares them before the outputs:

  * the layer tests feed both sides identical inputs and require the
    expert indices, each route's position within its expert, the ``keep``
    mask and the dispatch tensor to be equal, and the combine tensor to be
    equal to a bf16 rounding of the gate weights;
  * the model tests count the tokens whose expert sets differ and print
    that count; outputs are compared only where it is 0 (the layer tests,
    on identical inputs, decide otherwise).

Tolerances: the layer's output ``2^-8`` of its largest entry (the combine
product rounds the experts' outputs to bf16, and the two sides' f32
expert outputs may round to neighbouring bf16 values), the aux term
``2^-20`` relative; logits and K/V ``2^-13`` of their largest entry as in
``test_torch_serving.py``; the loss ``2^-17`` relative as in
``test_torch_train.py``, each gradient leaf ``2^-8`` of its largest entry:
the dispatch and combine products run the ``bf16`` policy, whose backward
rounds its cotangent to bf16 (JAX's rule, kept), so a last-bit difference
above a MoE layer can move a cotangent entry by one bf16 step (``2^-8``
relative).  JAX against itself, with its parameters perturbed by 1e-7
relative, moves the smoke model's leaves by the same 1e-4 to 3e-4 of their
largest entries.  Greedy tokens equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving.kv_cache import (  # noqa: E402
    write_prompt_pages as jax_write_prompt_pages)
from repro_torch.bridge import params_from_jax, tensor_from_numpy  # noqa
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, host_batch  # noqa: E402
from repro_torch.models import encdec_lm, get_model, layers, lm  # noqa
from repro_torch.models.modules import layer, tree_map  # noqa: E402
from repro_torch.serving import Engine, SamplingParams  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
ARCH = "granite-moe-1b-a400m"
REL = 2.0 ** -13
# the smoke config, and a variant with a dense first layer, so that the
# parameters, caches and K/V carry both stacks
VARIANTS = {"moe": {}, "dense+moe": dict(first_dense_layers=1, d_ff=96)}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def smoke(request):
    kw = VARIANTS[request.param]
    jcfg = jax_smoke_config(ARCH).replace(**kw)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(ARCH).replace(**kw), params


class Routes:
    """Every routing decision of both sides, in call order: JAX's top-k
    indices (G, gs, K) and the port's :func:`layers.moe_route` dicts."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        top_k, route = jax.lax.top_k, layers.moe_route

        def jax_top_k(x, k):
            v, i = top_k(x, k)
            jax.debug.callback(lambda a: self.jax.append(np.asarray(a)), i,
                               ordered=True)
            return v, i

        def port_route(*a):
            r = route(*a)
            self.port.append(r)
            return r

        monkeypatch.setattr(jax.lax, "top_k", jax_top_k)
        monkeypatch.setattr(layers, "moe_route", port_route)

    def moved(self) -> int:
        """Tokens whose expert sets differ between the two sides (printed);
        both sides must have routed the same calls."""
        jax.effects_barrier()
        assert len(self.jax) == len(self.port) > 0
        n = 0
        for j, r in zip(self.jax, self.port):
            t = r["topi"].numpy()
            assert j.shape == t.shape
            n += int((np.sort(j, -1) != np.sort(t, -1)).any(-1).sum())
        tokens = sum(j.shape[0] * j.shape[1] for j in self.jax)
        print(f"routes: {n} of {tokens} tokens moved to another expert set")
        return n

    def clear(self):
        self.jax.clear()
        self.port.clear()


@pytest.fixture
def routes(monkeypatch):
    return Routes(monkeypatch)


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref))


# ---------------------------------------------------------------- layer

@pytest.mark.parametrize("regime", ["as-configured", "dropping"])
def test_moe_layer_matches_jax(smoke, routes, monkeypatch, regime):
    """``layers.moe`` against ``repro.models.layers.moe`` on identical
    inputs: 2 x 40 tokens route in 2 groups of 40.  As configured
    (capacity factor 1.25: 28 slots an expert) no route drops; at 0.5 (12
    slots) routes drop."""
    jcfg, jparams, cfg, params = smoke
    if regime == "dropping":
        jcfg, cfg = (c.replace(capacity_factor=0.5) for c in (jcfg, cfg))
    name = "moe_blocks"
    jp = jax.tree.map(lambda a: a[0], jparams[name])["moe"]
    p = layer(params[name], 0)["moe"]
    x = np.random.default_rng(1).standard_normal((2, 40, 64)).astype(
        np.float32)
    # the dispatch and combine tensors, from the two bf16 products
    seen = {"jax": {}, "port": {}}

    def spy(side, pdot):
        def wrapped(spec, a, b, policy=None):
            if spec in ("gsec,gsd->gecd", "gsec,gecd->gsd"):
                seen[side][spec] = np.asarray(
                    a.float() if side == "port" else a.astype(jnp.float32))
            return pdot(spec, a, b, policy)
        return wrapped

    monkeypatch.setattr(jax_layers, "pdot", spy("jax", jax_layers.pdot))
    monkeypatch.setattr(layers, "pdot", spy("port", layers.pdot))
    # JAX's running count of routes per expert over the (s, k) slot order
    scans, scan = [], jax.lax.associative_scan
    monkeypatch.setattr(jax.lax, "associative_scan", lambda *a, **kw:
                        scans.append(scan(*a, **kw)) or scans[-1])
    with numerics.use(**FORCED):
        jy, jaux = jax_layers.moe(jp, jnp.asarray(x), jcfg)
    y, aux = layers.moe(p, torch.from_numpy(x), cfg)

    assert routes.moved() == 0
    r = routes.port[0]
    G, gs, K = r["topi"].shape
    assert (G, gs, K) == (2, 40, cfg.moe_top_k)
    C = layers.capacity(gs, cfg)
    assert C == r["C"] == (28 if regime == "as-configured" else 12)
    np.testing.assert_array_equal(r["topi"].numpy(), routes.jax[0])
    # every route's position within its expert: JAX's count read at the
    # route's own expert, as its ``pos_t``
    flat = np.eye(cfg.n_experts, dtype=np.float32)[routes.jax[0]].reshape(
        G, gs * K, -1)
    jpos = ((np.asarray(scans[0]) - 1.0) * flat).sum(-1).reshape(G, gs, K)
    pos = r["pos"].numpy()
    np.testing.assert_array_equal(pos, jpos)
    kept = r["keep"].float().numpy().astype(bool)
    np.testing.assert_array_equal(kept, jpos < C)
    assert kept.all() == (regime == "as-configured")
    # and JAX's dispatch tensor: the slot c of a kept route (token s,
    # expert e) is where dispatch[g, s, e, :] is 1
    jd = seen["jax"]["gsec,gsd->gecd"]
    np.testing.assert_array_equal(seen["port"]["gsec,gsd->gecd"], jd)
    gi, si, ki = np.nonzero(kept)
    ei = r["topi"].numpy()[gi, si, ki]
    assert (pos[gi, si, ki] < C).all() and (pos[~kept] >= C).all()
    assert np.all(jd[gi, si, ei, pos[gi, si, ki].astype(int)] == 1)
    assert jd.sum() == kept.sum()
    # combine: the renormalised gate weights in bf16 at the same slots
    jc = seen["jax"]["gsec,gecd->gsd"]
    tc = seen["port"]["gsec,gecd->gsd"]
    np.testing.assert_array_equal(tc != 0, jc != 0)
    assert np.max(np.abs(tc - jc)) <= 2.0 ** -8
    _close(y.numpy(), jy, 2.0 ** -8)
    _close(float(aux), float(jaux), 2.0 ** -20)


def test_moe_route_shapes_follow_jax():
    """Group size: the largest divisor of the token count at most
    ``moe_groups``; capacity a multiple of 4 — the engine's shapes at full
    width."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH)
    assert cfg.moe_groups == 128
    got = [(n, layers.group_size(n, cfg), layers.capacity(
        layers.group_size(n, cfg), cfg)) for n in (1024, 416, 128, 64, 4)]
    assert got == [(1024, 128, 40), (416, 104, 36), (128, 128, 40),
                   (64, 64, 20), (4, 4, 4)]


# ---------------------------------------------------------------- model

def test_prefill_logits_and_kv_match_jax(smoke, routes):
    jcfg, jparams, cfg, params = smoke
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    with numerics.use(**FORCED):
        jlogits, jkv = jax_get_model(jcfg).prefill(jparams,
                                                    jnp.asarray(toks))
    logits, kv = get_model(cfg).prefill(params, torch.from_numpy(toks))
    assert sorted(kv) == sorted(jkv) == sorted(n for n, _, _ in
                                               lm.stacks(cfg))
    if routes.moved() == 0:
        _close(logits.numpy(), jlogits)
        for name in kv:
            for k in ("k", "v"):
                _close(kv[name][k].numpy(), jkv[name][k])


def test_decode_step_paged_logits_match_jax(smoke, routes):
    jcfg, jparams, cfg, params = smoke
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
        pools = jax.tree.map(lambda x: tensor_from_numpy(np.asarray(x)),
                             jpools)
        jax.effects_barrier()
        routes.clear()             # the decode step's routes only
        jlogits, _ = jmodel.decode_step_paged(
            jparams, jpools, jnp.asarray(bt), jnp.asarray(lengths),
            jnp.asarray(nxt, jnp.int32))
    assert sorted(pools) == sorted(n for n, _, _ in lm.stacks(cfg))
    logits = get_model(cfg).decode_step_paged(
        params, pools, torch.from_numpy(bt), torch.from_numpy(lengths),
        torch.from_numpy(nxt))
    if routes.moved() == 0:
        _close(logits.numpy(), jlogits)


def test_engine_greedy_tokens_equal_jax(smoke):
    """Ragged prompts, more requests than slots: admissions that share a
    padded length prefill together on both sides, and their padding takes
    expert capacity the same way."""
    jcfg, jparams, cfg, params = smoke
    lens, kw = [5, 12, 20, 9, 7, 3], dict(max_slots=4, num_pages=33,
                                          page_size=4)
    rng = np.random.default_rng(len(lens))
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lens]
    with numerics.use(**FORCED):
        jeng = JaxEngine(jcfg, jparams, **kw)
        jout = jeng.run(prompts, JaxSamplingParams(max_tokens=6))
    eng = Engine(cfg, params, device="cpu", **kw)
    out = eng.run(prompts, SamplingParams(max_tokens=6))
    assert {r: list(v) for r, v in out.items()} == \
        {r: list(v) for r, v in jout.items()}
    assert eng.stats()["prefills"] == jeng.stats()["prefills"] > 1


def test_loss_and_grads_match_jax_value_and_grad(smoke, routes):
    """``loss_fn`` = lm + 0.01 aux, its metrics and every gradient leaf
    (the experts, the router through the gate weights and the aux term)
    against JAX's ``value_and_grad``; remat on, as configured."""
    jcfg, jparams, cfg, params = smoke
    nb = host_batch(cfg, DataConfig(seed=0, global_batch=2, seq_len=16), 3)
    with numerics.use(**FORCED):
        (jloss, jmet), jgrads = jax.value_and_grad(
            jax_get_model(jcfg).loss_fn, has_aux=True)(
                jparams, jax.tree.map(jnp.asarray, nb))
        jax.effects_barrier()
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    loss, met = get_model(cfg).loss_fn(
        p, {k: torch.from_numpy(v) for k, v in nb.items()})
    loss.backward()
    # the forward's routes; remat routes each layer again in the backward
    n_moe = dict((n, k) for n, k, _ in lm.stacks(cfg))["moe_blocks"]
    routes.jax, routes.port = routes.jax[:n_moe], routes.port[:n_moe]
    assert routes.moved() == 0
    assert float(met["aux_loss"].detach()) > 0
    _close(float(loss), float(jloss), 2.0 ** -17)
    met = {k: float(v.detach()) for k, v in met.items()}
    _close(met["loss"], met["lm_loss"] + 0.01 * met["aux_loss"], 2.0 ** -22)
    assert sorted(met) == sorted(jmet)
    for k in met:
        _close(met[k], float(jmet[k]), 2.0 ** -17)

    def walk(t, j, path=""):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j), path
            for k in t:
                walk(t[k], j[k], f"{path}/{k}")
        else:
            _close(t.grad.numpy(), j, 2.0 ** -8)

    walk(p, jgrads)


# ---------------------------------------------------------- not ported

# MLA and MTP are ported (tests/test_torch_mla.py); models.lm still refuses
# the enc-dec family, which has entries of its own.
@pytest.mark.parametrize("arch,kw,missing", [
    ("seamless-m4t-large-v2", {}, "family 'audio'")])
def test_unported_configs_raise_naming_what_is_missing(arch, kw, missing):
    cfg = ModelConfig(**dataclasses.asdict(jax_smoke_config(arch))).replace(
        **kw)
    for fn in (lambda: lm.init(cfg, 0, device="cpu"),
               lambda: lm.loss_fn({}, {}, cfg),
               lambda: lm.init_paged_cache(cfg, 4, 4, device="cpu")):
        with pytest.raises(NotImplementedError, match=missing):
            fn()
    # the handle is the family's: encdec_lm's for the enc-dec family
    assert get_model(cfg).module is encdec_lm
