"""The port's SSM and hybrid families and the dense-cache loop against the
JAX package, on the CPU.

The mamba2-130m and zamba2-1.2b smoke configs (2 and 5 layers, d_model 64,
SSD heads of 16, state 16, chunks of 16 tokens; zamba2's shared block
after every 2 layers), parameters from the JAX ``init`` bridged exactly.
The JAX side runs under ``numerics.use(force=True, interpret=True,
min_dim=0)`` as the serving tests do; the port runs its kernels' plain
versions.

Tolerances: logits, layer outputs and cache leaves ``2^-13`` of their
largest entry, as in ``test_torch_serving.py`` (the two sides differ by f32
rounding of summation order); the loss ``2^-17`` relative, as in
``test_torch_train.py``.  Greedy tokens equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.serve import (  # noqa: E402
    generate_dense as jax_generate_dense)
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import hybrid_lm as jax_hybrid_lm  # noqa: E402
from repro.models import ssd as jax_ssd  # noqa: E402
from repro_torch.bridge import params_from_jax, tensor_from_numpy  # noqa
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model, hybrid_lm, ssd  # noqa: E402
from repro_torch.models.modules import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
REL = 2.0 ** -13
ARCHS = ["mamba2-130m", "zamba2-1.2b"]


@functools.lru_cache(maxsize=None)
def _smoke(arch):
    """(JAX config, JAX params, port config, bridged params)."""
    jcfg = jax_smoke_config(arch)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(arch), params


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) <= rel * np.max(np.abs(ref))


def _close_tree(tree, jtree, rel=REL):
    """Every leaf of the port's ``tree`` against JAX's, key for key."""
    if isinstance(tree, dict):
        assert sorted(tree) == sorted(jtree)
        for k in tree:
            _close_tree(tree[k], jtree[k], rel)
    else:
        _close(tree.float().numpy(), np.asarray(jtree, np.float32), rel)


def _layer(arch, seed=1):
    """One SSD layer's parameters from the JAX init, both sides."""
    jcfg, _, cfg, _ = _smoke(arch)
    jp = jax_ssd.ssd_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


# ------------------------------------------------------------- SSD layer

@pytest.mark.parametrize("S", [16, 32])
def test_ssd_layer_matches_jax(S):
    """S 16 is one chunk, S 32 two (the carried state enters)."""
    jcfg, jp, cfg, p = _layer("mamba2-130m")
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(
        np.float32)
    with numerics.use(**FORCED):
        ref = jax_ssd.ssd_layer(jp, jnp.asarray(x), jcfg)
    _close(ssd.ssd_layer(p, torch.from_numpy(x), cfg).numpy(), ref)


def test_ssd_layer_rejects_a_ragged_sequence():
    _, _, cfg, p = _layer("mamba2-130m")
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        ssd.ssd_layer(p, torch.zeros(1, 24, cfg.d_model), cfg)


def test_ssd_decode_matches_jax():
    """One step from a random cache: the output and every cache leaf."""
    jcfg, jp, cfg, p = _layer("mamba2-130m")
    rng = np.random.default_rng(3)
    jcache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax_ssd.ssd_init_cache(jcfg, 3))
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    with numerics.use(**FORCED):
        ref, jnew = jax_ssd.ssd_decode(jp, jnp.asarray(x), jcfg, jcache)
    cache = tree_map(tensor_from_numpy, jcache)
    before = tree_map(torch.clone, cache)
    out, new = ssd.ssd_decode(p, torch.from_numpy(x), cfg, cache)
    _close(out.numpy(), ref)
    _close_tree(new, jnew)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                 tree_leaves(before)))


@pytest.mark.parametrize("policy", ["tcec_bf16x6", "fp32"])
def test_ssd_chunked_matches_own_reference(policy):
    """The port's chunked layer against its own sequential recurrence
    (``ssd_reference``), two chunks, at the same 2^-13 of the largest
    entry: the two differ by f32 rounding of the decay products."""
    _, _, cfg, p = _layer("mamba2-130m", seed=2)
    cfg = cfg.replace(policy=policy)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    _close(ssd.ssd_layer(p, x, cfg).numpy(),
           ssd.ssd_reference(p, x, cfg).numpy())


# ------------------------------------------------------------ the models

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_jax(arch):
    jcfg, jparams, cfg, params = _smoke(arch)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32))
    with numerics.use(**FORCED):
        ref = jax_get_model(jcfg).forward_logits(
            jparams, {"tokens": jnp.asarray(toks)})
    out = get_model(cfg).forward_logits(params, torch.from_numpy(toks))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b"])
def test_decode_step_matches_jax(arch):
    """Three steps from an empty dense cache: each step's logits and, after
    the last, every cache leaf (the SSM state and conv windows in f32, the
    K/V in bf16)."""
    jcfg, jparams, cfg, params = _smoke(arch)
    jmodel, model = jax_get_model(jcfg), get_model(cfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 3))
    step = jax.jit(jmodel.decode_step)
    with numerics.use(**FORCED):
        jcache = jmodel.init_cache(2, 5)
        jlogits = []
        for i in range(3):
            lg, jcache = step(jparams, jcache,
                              jnp.asarray(toks[:, i], jnp.int32), i)
            jlogits.append(lg)
    cache = model.init_cache(2, 5, device="cpu")
    for i in range(3):
        logits, out_cache = model.decode_step(
            params, cache, torch.from_numpy(toks[:, i]), i)
        assert out_cache is cache                 # updated in place
        _close(logits.numpy(), jlogits[i])
    _close_tree(cache, jcache)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    jcfg, jparams, cfg, params = _smoke(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    labels = rng.integers(0, cfg.vocab_size, (2, 32))
    labels[0, :5] = -1                            # masked positions
    with numerics.use(**FORCED):
        jloss, jmet = jax_get_model(jcfg).loss_fn(
            jparams, {"tokens": jnp.asarray(toks),
                      "labels": jnp.asarray(labels)})
    loss, met = get_model(cfg).loss_fn(
        params, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)})
    assert sorted(met) == sorted(jmet)
    for k in met:
        _close(float(met[k]), float(jmet[k]), 2.0 ** -17)
    _close(float(loss), float(jloss), 2.0 ** -17)


@pytest.mark.parametrize("n,every", [(5, 2), (38, 6), (6, 6), (4, 6)])
def test_group_sizes_equal_jax(n, every):
    jcfg = jax_smoke_config("zamba2-1.2b").replace(n_layers=n,
                                                   attn_every=every)
    cfg = get_smoke_config("zamba2-1.2b").replace(n_layers=n,
                                                  attn_every=every)
    assert hybrid_lm.group_sizes(cfg) == jax_hybrid_lm.group_sizes(jcfg)
    shared = [i for kind, i in hybrid_lm._order(cfg) if kind == "shared"]
    mamba = [i for kind, i in hybrid_lm._order(cfg) if kind == "mamba"]
    assert shared == list(range(n // every)) and mamba == list(range(n))


# ------------------------------------------------------- generate_dense

@pytest.mark.parametrize("arch", ARCHS + ["qwen3-0.6b"])
def test_generate_dense_greedy_tokens_equal_jax(arch):
    """mamba2 and zamba2 feed the prompt through ``decode_step``; qwen3
    takes the prefill branch (one forward, its K/V placed in the dense
    cache)."""
    jcfg, jparams, cfg, params = _smoke(arch)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 8))
    with numerics.use(**FORCED):
        ref = np.asarray(jax_generate_dense(jcfg, jparams,
                                            jnp.asarray(prompts), 6))
    out = serve.generate_dense(cfg, params, prompts, 6, device="cpu")
    np.testing.assert_array_equal(out, ref)


def test_generate_dense_sampled_draws_are_seeded():
    _, _, cfg, params = _smoke("mamba2-130m")
    prompts = np.arange(8).reshape(2, 4)

    def draw(seed):
        return serve.generate_dense(cfg, params, prompts, 5, greedy=False,
                                    seed=seed, device="cpu")

    a = draw(1)
    assert a.shape == (2, 5) and a.min() >= 0 and a.max() < cfg.vocab_size
    np.testing.assert_array_equal(a, draw(1))
    assert not np.array_equal(a, draw(2))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_falls_back_to_generate_dense(arch, monkeypatch):
    _, _, cfg, params = _smoke(arch)
    calls = []
    dense = serve.generate_dense

    def recorded(*a, **kw):
        calls.append(a[0].name)
        return dense(*a, **kw)

    monkeypatch.setattr(serve, "generate_dense", recorded)
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 5))
    out = serve.generate(cfg, params, prompts, 4, device="cpu")
    assert calls == [cfg.name]
    np.testing.assert_array_equal(
        out, dense(cfg, params, prompts, 4, device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_families_without_paged_decode(arch):
    _, _, cfg, params = _smoke(arch)
    model = get_model(cfg)
    assert model.prefill is None and model.init_paged_cache is None
    assert model.decode_step_paged is None
    with pytest.raises(ValueError, match="generate_dense"):
        Engine(cfg, params, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_dense_loop_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "6", "--gen", "4", "--device", "cpu"])
    assert "generate_dense on cpu: (2, 4)" in capsys.readouterr().out
