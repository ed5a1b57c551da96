"""Encoder-decoder transformer (the ``audio`` family, seamless-m4t-large-v2).
Counterpart of the JAX package's ``models/encdec_lm.py``, function for
function.  The speech frontend is a STUB: ``batch["frames"]`` carries
precomputed frame embeddings (B, S, frontend_dim); the encoder, the decoder
and the cross-attention are real.

Parameters: ``frontend_proj`` (frontend_dim, D), ``enc_blocks`` (leaves
with a leading layer axis: ``ln1``, ``attn``, ``ln2``, ``mlp``),
``enc_ln_f``, ``embed``, ``dec_blocks`` (``ln1``, ``attn``, ``lnx``,
``xattn``, ``ln2``, ``mlp``), ``ln_f`` and ``unembed`` (untied).

The encoder's self-attention is non-causal and the cross-attention takes
queries of the decoder against keys of the memory (S != T), both through
``layers.sdpa``, so kernel 2 on the card.  The cross-attention applies no
RoPE and no softcap.  The decode cache is ``{"self": {"k", "v"}, "cross":
{"k", "v"}}`` in bf16, leaves (layers, B, T, Hkv, hd): the self cache is
attended in plain bf16 as every dense cache is, the cross cache (filled by
:func:`prefill_cross`) is upcast to f32 and attended through kernel 2
with one query row.  There is no paged decode path: the family is served
by ``launch.serve.generate_dense``.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import pdot
from . import layers as L
from .lm import _grad_needed, _positions, cross_entropy, embed, unembed_logits
from .modules import (dense_init, embed_init, generator, layer, layer_views,
                      stack_init, zeros)


def _enc_layer_init(gen, cfg, device):
    return {"ln1": zeros((cfg.d_model,), device),
            "attn": L.attn_init(gen, cfg, device),
            "ln2": zeros((cfg.d_model,), device),
            "mlp": L.mlp_init(gen, cfg, device=device)}


def _dec_layer_init(gen, cfg, device):
    return {"ln1": zeros((cfg.d_model,), device),
            "attn": L.attn_init(gen, cfg, device),
            "lnx": zeros((cfg.d_model,), device),
            "xattn": L.attn_init(gen, cfg, device),
            "ln2": zeros((cfg.d_model,), device),
            "mlp": L.mlp_init(gen, cfg, device=device)}


def init(cfg, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    D = cfg.d_model
    return {
        "frontend_proj": dense_init(gen, (cfg.frontend_dim, D),
                                    fan_in=cfg.frontend_dim, device=device),
        "enc_blocks": stack_init(lambda: _enc_layer_init(gen, cfg, device),
                                 cfg.n_enc_layers),
        "enc_ln_f": zeros((D,), device),
        "embed": embed_init(gen, (cfg.padded_vocab, D), device),
        "dec_blocks": stack_init(lambda: _dec_layer_init(gen, cfg, device),
                                 cfg.n_layers),
        "ln_f": zeros((D,), device),
        "unembed": dense_init(gen, (D, cfg.padded_vocab), fan_in=D,
                              device=device),
    }


def _cross_attention(p, x, mem_k, mem_v, cfg):
    """Cross-attention: q from the decoder (no RoPE), K/V precomputed from
    the encoder memory (:func:`_mem_kv`).  Through ``layers.sdpa``
    (kernel 2 on the card) with a softcap-free cfg shim, non-causal at
    positions ``arange(S)`` / ``arange(T)``."""
    q = pdot("bsd,dhk->bshk", x, p["wq"], cfg.policy)
    S, T = q.shape[1], mem_k.shape[1]
    shim = SimpleNamespace(mix_policy=cfg.mix_policy, attn_softcap=None)
    o = L.sdpa(q, mem_k, mem_v, shim,
               torch.arange(S, dtype=torch.int32, device=x.device)[None],
               torch.arange(T, dtype=torch.int32, device=x.device)[None],
               causal=False, window=0)
    return pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy)


def _mem_kv(p, mem, cfg):
    k = pdot("bsd,dhk->bshk", mem, p["wk"], cfg.policy)
    v = pdot("bsd,dhk->bshk", mem, p["wv"], cfg.policy)
    return k, v


def _run_layers(body, x, layers, remat, *args):
    """``x = body(layer, x, *args)`` over ``layers``; each call is
    recomputed in the backward when ``remat`` (``jax.checkpoint`` of the
    scan body)."""
    for lp in layers:
        if remat:
            x = checkpoint(body, lp, x, *args, use_reentrant=False)
        else:
            x = body(lp, x, *args)
    return x


def _enc_body(lp, x, cfg, positions):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x1 = x + L.attention(lp["attn"], h, cfg, positions, causal=False)
    h = L.rmsnorm(lp["ln2"], x1, cfg.norm_eps)
    return x1 + L.mlp(lp["mlp"], h, cfg)


def encode(params, frames, cfg):
    """The encoder: frames (B, S, frontend_dim) -> memory (B, S, D)."""
    x = pdot("bsf,fd->bsd", frames.float(), params["frontend_proj"],
             cfg.policy)
    B, S = x.shape[:2]
    layers = layer_views(params["enc_blocks"], cfg.n_enc_layers)
    x = _run_layers(_enc_body, x, layers,
                    cfg.remat and _grad_needed(params), cfg,
                    _positions(B, S, x.device))
    return L.rmsnorm(params["enc_ln_f"], x, cfg.norm_eps)


def _dec_body(lp, x, mem, cfg, positions):
    h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x1 = x + L.attention(lp["attn"], h, cfg, positions, causal=True)
    h = L.rmsnorm(lp["lnx"], x1, cfg.norm_eps)
    mk, mv = _mem_kv(lp["xattn"], mem, cfg)
    x2 = x1 + _cross_attention(lp["xattn"], h, mk, mv, cfg)
    h = L.rmsnorm(lp["ln2"], x2, cfg.norm_eps)
    return x2 + L.mlp(lp["mlp"], h, cfg)


def decode_train(params, tokens, mem, cfg):
    """The decoder over whole sequences: tokens (B, S) against the memory
    (B, T, D) -> (B, S, D) after the final norm."""
    B, S = tokens.shape
    x = embed(params, tokens, cfg)
    layers = layer_views(params["dec_blocks"], cfg.n_layers)
    x = _run_layers(_dec_body, x, layers,
                    cfg.remat and _grad_needed(params), mem, cfg,
                    _positions(B, S, tokens.device))
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def loss_fn(params, batch, cfg):
    """``(loss, metrics)`` of a batch ``{"frames", "tokens", "labels"}``."""
    mem = encode(params, batch["frames"], cfg)
    x = decode_train(params, batch["tokens"], mem, cfg)
    loss, denom = cross_entropy(unembed_logits(params, x, cfg),
                                batch["labels"])
    return loss, {"loss": loss, "lm_loss": loss, "tokens": denom}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               mem_len: int | None = None, device=None):
    """Self K/V of ``max_len`` positions per decoder layer and the cross
    K/V of ``mem_len`` memory positions (default ``max(max_len // 8,
    64)``), zero leaves (layers, batch, T, Hkv, hd)."""
    device = resolve_device(device)
    mem_len = mem_len or max(max_len // 8, 64)

    def kv(T):
        return {k: torch.zeros((cfg.n_layers, batch, T, cfg.n_kv_heads,
                                cfg.head_dim), dtype=dtype, device=device)
                for k in ("k", "v")}

    return {"self": kv(max_len), "cross": kv(mem_len)}


def prefill_cross(params, frames, cfg, cache):
    """Run the encoder once and put each decoder layer's memory K/V into
    the cross cache in bf16.  The cache is updated in place and returned
    (JAX returns a new tree); where the frames' length is not the cache's
    ``mem_len``, the cross leaves are replaced by ones of the frames'
    length, as in JAX."""
    mem = encode(params, frames, cfg)
    n = cfg.n_layers
    kv = [_mem_kv(layer(params["dec_blocks"], i)["xattn"], mem, cfg)
          for i in range(n)]
    cross = cache["cross"]
    for j, name in enumerate(("k", "v")):
        if cross[name].shape[2] == mem.shape[1]:
            for i in range(n):
                cross[name][i] = kv[i][j].to(torch.bfloat16)
        else:
            cross[name] = torch.stack([t[j] for t in kv]).to(torch.bfloat16)
    return cache


def decode_step(params, cfg, cache, tokens, cache_index):
    """One decode step, every row at position ``cache_index``. tokens:
    (B,); returns ``(logits (B, V), cache)``, the self cache updated in
    place."""
    x = embed(params, tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        lp = layer(params["dec_blocks"], i)
        selfc, crossc = layer(cache["self"], i), layer(cache["cross"], i)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        x1 = x + L.attention_decode(lp["attn"], h, cfg, selfc,
                                    cache_index)[0]
        h = L.rmsnorm(lp["lnx"], x1, cfg.norm_eps)
        x2 = x1 + _cross_attention(lp["xattn"], h, crossc["k"].float(),
                                   crossc["v"].float(), cfg)
        h = L.rmsnorm(lp["ln2"], x2, cfg.norm_eps)
        x = x2 + L.mlp(lp["mlp"], h, cfg)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)[:, 0], cache


def forward_logits(params, batch, cfg):
    """Logits of a batch ``{"frames" (B, T, frontend_dim), "tokens" (B,
    S)}`` -> (B, S, V): encode, then the decoder over the whole sequence."""
    mem = encode(params, batch["frames"], cfg)
    x = decode_train(params, batch["tokens"], mem, cfg)
    return unembed_logits(params, x, cfg)
