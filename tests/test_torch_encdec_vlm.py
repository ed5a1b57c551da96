"""The port's enc-dec (``audio``) and VLM families against the JAX package,
on the CPU.

The seamless-m4t-large-v2 and internvl2-2b smoke configs (2 layers each,
d_model 64, heads of 16; seamless 2 encoder layers and frames of width 32;
internvl2 8 patches of width 32), parameters from the JAX ``init`` bridged
exactly.  The JAX side runs under ``numerics.use(force=True,
interpret=True, min_dim=0)`` as the serving tests do; the port runs its
kernels' plain versions.

Tolerances: logits, the encoder's memory and the self cache's leaves
``2^-13`` of their largest entry, as in ``test_torch_ssm.py`` (the two
sides differ by f32 rounding of summation order); the cross cache, which
both sides round to bf16, within one bf16 step of JAX's entry; the loss
``2^-17`` relative and every gradient leaf ``2^-8`` of its largest entry,
as in ``test_torch_moe.py``; a train step of two microbatches ``2^-13``,
as in ``test_torch_train.py``.  Greedy tokens equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.serve import (  # noqa: E402
    generate_dense as jax_generate_dense)
from repro.launch.step import make_train_step as jax_train_step  # noqa: E402
from repro.models import encdec_lm as jax_encdec  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, host_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import step as tstep  # noqa: E402
from repro_torch.models import encdec_lm, get_model, vlm_lm  # noqa: E402
from repro_torch.models.modules import tree_map  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
REL = 2.0 ** -13
AUDIO, VLM = "seamless-m4t-large-v2", "internvl2-2b"
ARCHS = [AUDIO, VLM]


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
    err = np.max(np.abs(out - ref))
    assert err <= rel * max(np.max(np.abs(ref)), 1e-30), err


def _close_tree(tree, jtree, close):
    """Every leaf of the port's ``tree`` against JAX's, key for key."""
    if isinstance(tree, dict):
        assert sorted(tree) == sorted(jtree)
        for k in tree:
            _close_tree(tree[k], jtree[k], close)
    else:
        close(tree.float().numpy(), np.asarray(jtree, np.float32))


def _one_bf16_step(out, ref):
    """Every entry within one bf16 step (2^-7 of its binade) of JAX's."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    mag = np.abs(ref)
    step = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.where(
        mag > 0, mag, 1.0))) - 7), 0.0)
    assert np.all(np.abs(out - ref) <= step)


def _inputs(cfg, B=2, S=12, T=16, seed=1):
    """Tokens (B, S) and the family's frontend input: frames (B, T,
    frontend_dim) or patches (B, n_frontend_tokens, frontend_dim)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        return {"tokens": toks, "frames": rng.standard_normal(
            (B, T, cfg.frontend_dim)).astype(np.float32)}
    return {"tokens": toks, "patches": rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_configs_equal_jax_field_for_field(arch, which):
    ours = (get_config if which == "full" else get_smoke_config)(arch)
    ref = (jax_config if which == "full" else jax_smoke_config)(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.padded_vocab == ref.padded_vocab


@pytest.mark.parametrize("arch,family,module", [
    (AUDIO, "audio", encdec_lm), (VLM, "vlm", vlm_lm)])
def test_get_model_serves_the_family_without_a_paged_path(arch, family,
                                                          module):
    _, _, cfg, params = _smoke(arch)
    model = get_model(cfg)
    assert cfg.family == family and model.module is module
    assert model.prefill is None and model.init_paged_cache is None
    assert model.decode_step_paged is None
    with pytest.raises(ValueError, match="generate_dense"):
        Engine(cfg, params, device="cpu")


# --------------------------------------------------------------- enc-dec

def test_encode_matches_jax():
    """The encoder: frontend projection, non-causal self-attention."""
    jcfg, jparams, cfg, params = _smoke(AUDIO)
    frames = _inputs(cfg)["frames"]
    with numerics.use(**FORCED):
        ref = jax_encdec.encode(jparams, jnp.asarray(frames), jcfg)
    _close(encdec_lm.encode(params, torch.from_numpy(frames), cfg).numpy(),
           ref)


def test_encoder_is_not_causal_and_cross_attention_has_no_rope():
    """A change to the last frame moves the memory at the first position
    (non-causal), and the cross-attention's output does not depend on the
    decoder position (no RoPE on q or the memory K/V)."""
    _, _, cfg, params = _smoke(AUDIO)
    frames = torch.from_numpy(_inputs(cfg)["frames"])
    moved = frames.clone()
    moved[:, -1] += 1.0
    a = encdec_lm.encode(params, frames, cfg)
    b = encdec_lm.encode(params, moved, cfg)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    p = {k: v[0] for k, v in params["dec_blocks"]["xattn"].items()}
    mk, mv = encdec_lm._mem_kv(p, a, cfg)
    x = torch.randn(2, 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    one = encdec_lm._cross_attention(p, x, mk, mv, cfg)
    many = encdec_lm._cross_attention(p, x.expand(2, 5, cfg.d_model), mk, mv,
                                      cfg)
    for i in range(5):
        _close(many[:, i].numpy(), one[:, 0].numpy())


def _jax_served(jcfg, jparams, frames, prompts, gen, mem_len):
    """JAX's serving path of the enc-dec family: ``prefill_cross``, then
    the prompt through ``decode_step`` and ``gen`` greedy tokens.  Returns
    (every step's logits, tokens, the cache after ``prefill_cross``, the
    final cache)."""
    step = jax.jit(jax_get_model(jcfg).decode_step)
    B, P = prompts.shape
    with numerics.use(**FORCED):
        cache = jax_encdec.init_cache(jcfg, B, P + gen + 1, mem_len=mem_len)
        cache = jax_encdec.prefill_cross(jparams, jnp.asarray(frames), jcfg,
                                         cache)
        filled = cache
        logits, out = [], []
        for i in range(P):
            lg, cache = step(jparams, cache, jnp.asarray(prompts[:, i]), i)
            logits.append(np.asarray(lg))
        for i in range(gen):
            tok = jnp.argmax(logits[-1][:, :jcfg.vocab_size], axis=-1)
            out.append(np.asarray(tok))
            lg, cache = step(jparams, cache, tok.astype(jnp.int32), P + i)
            logits.append(np.asarray(lg))
    return logits, np.stack(out, 1), filled, cache


def _served(cfg, params, frames, prompts, gen, mem_len):
    model = get_model(cfg)
    B, P = prompts.shape
    cache = model.init_cache(B, P + gen + 1, mem_len=mem_len, device="cpu")
    with torch.no_grad():
        assert encdec_lm.prefill_cross(params, torch.from_numpy(frames), cfg,
                                       cache) is cache
        filled = {k: v.clone() for k, v in cache["cross"].items()}
        logits, out = [], []
        for i in range(P):
            lg, out_cache = model.decode_step(
                params, cache, torch.from_numpy(prompts[:, i]), i)
            assert out_cache is cache              # updated in place
            logits.append(lg.numpy())
        for i in range(gen):
            tok = np.argmax(logits[-1][:, :cfg.vocab_size], axis=-1)
            out.append(tok)
            lg, _ = model.decode_step(params, cache, torch.from_numpy(tok),
                                      P + i)
            logits.append(lg.numpy())
    return logits, np.stack(out, 1), filled, cache


def test_prefill_cross_and_decode_step_match_jax():
    """``prefill_cross`` over 16 frames (the cache's ``mem_len``), then a
    6-token prompt and 5 greedy tokens through ``decode_step``: every
    step's logits, the greedy tokens, the cross cache (one bf16 step) and
    the self cache."""
    jcfg, jparams, cfg, params = _smoke(AUDIO)
    inp = _inputs(cfg, S=6, T=16, seed=2)
    frames, prompts = inp["frames"], inp["tokens"]
    jlogits, jtoks, jfilled, jcache = _jax_served(jcfg, jparams, frames,
                                                  prompts, 5, 16)
    logits, toks, filled, cache = _served(cfg, params, frames, prompts, 5, 16)
    assert cache["cross"]["k"].dtype == torch.bfloat16
    _close_tree(filled, jfilled["cross"], _one_bf16_step)
    for lg, jlg in zip(logits, jlogits, strict=True):
        _close(lg, jlg)
    np.testing.assert_array_equal(toks, jtoks)
    _close_tree(cache["self"], jcache["self"], _close)
    assert float(cache["cross"]["k"].float().abs().sum()) > 0


def test_prefill_cross_takes_the_frames_length_as_jax_does():
    """Frames shorter than the cache's ``mem_len``: JAX's cross cache takes
    the frames' length, and so does the port's."""
    jcfg, jparams, cfg, params = _smoke(AUDIO)
    frames = _inputs(cfg, T=8, seed=3)["frames"]
    with numerics.use(**FORCED):
        jcache = jax_encdec.prefill_cross(
            jparams, jnp.asarray(frames), jcfg,
            jax_encdec.init_cache(jcfg, 2, 9))
    cache = encdec_lm.init_cache(cfg, 2, 9, device="cpu")
    assert cache["cross"]["k"].shape[2] == 64          # max(9 // 8, 64)
    with torch.no_grad():
        encdec_lm.prefill_cross(params, torch.from_numpy(frames), cfg, cache)
    assert cache["cross"]["k"].shape == jcache["cross"]["k"].shape
    _close_tree(cache["cross"], jcache["cross"], _one_bf16_step)


# ------------------------------------------------------- both families

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_matches_jax(arch):
    jcfg, jparams, cfg, params = _smoke(arch)
    batch = _inputs(cfg)
    with numerics.use(**FORCED):
        ref = jax_get_model(jcfg).forward_logits(
            jparams, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        out = get_model(cfg).forward_logits(params, _torch(batch))
    S = batch["tokens"].shape[1] + (cfg.n_frontend_tokens
                                    if arch == VLM else 0)
    assert out.shape == (2, S, cfg.padded_vocab)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    """``loss_fn`` with masked labels (the VLM's -1 on the patches, and a
    few more) against ``jax.value_and_grad``, remat on both sides."""
    jcfg, jparams, cfg, params = _smoke(arch)
    batch = _inputs(cfg, seed=4)
    P = cfg.n_frontend_tokens if arch == VLM else 0
    rng = np.random.default_rng(5)
    labels = rng.integers(0, cfg.vocab_size,
                          (2, P + batch["tokens"].shape[1])).astype(np.int32)
    labels[:, :P] = -1
    labels[0, P:P + 3] = -1
    batch["labels"] = labels
    assert jcfg.remat and cfg.remat

    def jloss(p):
        return jax_get_model(jcfg).loss_fn(p, jax.tree.map(jnp.asarray,
                                                           batch))

    with numerics.use(**FORCED):
        (jl, jmet), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, met = get_model(cfg).loss_fn(p, _torch(batch))
    loss.backward()
    _close(float(loss.detach()), float(jl), 2.0 ** -17)
    assert sorted(met) == sorted(jmet)
    for k in met:
        _close(float(met[k].detach()), float(jmet[k]), 2.0 ** -17)
    assert float(met["tokens"]) == float((labels >= 0).sum())

    def walk(t, j, path=""):
        if isinstance(t, dict):
            assert sorted(t) == sorted(j), path
            for k in t:
                walk(t[k], j[k], f"{path}/{k}")
        else:
            assert t.grad is not None, path
            _close(t.grad.numpy(), j, 2.0 ** -8)

    walk(p, jgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_with_microbatches_matches_jax(arch):
    """``host_batch``'s frames or patches flow through ``loss_fn`` and the
    gradient accumulation of a two-microbatch step (AdamW with eps 1, as
    in ``test_torch_train.py``)."""
    jcfg, jparams, cfg, params = _smoke(arch)
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1.0)
    nb = host_batch(cfg, DataConfig(seed=0, global_batch=4, seq_len=16), 1)
    jstate = {"params": jparams, "opt": jax_adamw.init_state(
        jparams, jax_adamw.OptConfig(**opt_kw))}
    with numerics.use(**FORCED):
        jnew, jmet = jax.jit(jax_train_step(
            jcfg, jax_adamw.OptConfig(**opt_kw), 2))(
                jstate, jax.tree.map(jnp.asarray, nb))
    state = params_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    new, met = tstep.make_train_step(cfg, adamw.OptConfig(**opt_kw), 2)(
        state, _torch(nb))
    assert sorted(met) == sorted(jmet)
    for k in met:
        _close(float(met[k]), float(jmet[k]), REL)
    _close_tree(new["params"], jnew["params"], _close)
    logits = tstep.make_prefill_step(cfg)(new["params"], _torch(nb))
    assert logits.shape == (4, nb["labels"].shape[1], cfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_an_empty_cache_matches_jax(arch):
    """Three steps from an empty dense cache (the enc-dec model's cross
    cache all zeros, as ``generate_dense`` leaves it): each step's logits
    and every cache leaf after the last."""
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
    with torch.no_grad():
        for i in range(3):
            logits, out_cache = model.decode_step(
                params, cache, torch.from_numpy(toks[:, i]), i)
            assert out_cache is cache
            _close(logits.numpy(), jlogits[i])
    _close_tree(cache, jcache, _close)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_dense_greedy_tokens_equal_jax(arch):
    """JAX's ``generate_dense`` for these families: the prompt through
    ``decode_step`` one token at a time (text only; the enc-dec decoder
    over a cross cache of zeros)."""
    jcfg, jparams, cfg, params = _smoke(arch)
    prompts = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 8))
    with numerics.use(**FORCED):
        ref = np.asarray(jax_generate_dense(jcfg, jparams,
                                            jnp.asarray(prompts), 6))
    out = serve.generate_dense(cfg, params, prompts, 6, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        serve.generate(cfg, params, prompts, 6, device="cpu"), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_dense_loop_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--batch", "2", "--prompt-len",
                "6", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "note: serving CLI drives the LM/decoder path" in out
    assert "generate_dense on cpu: (2, 4)" in out
