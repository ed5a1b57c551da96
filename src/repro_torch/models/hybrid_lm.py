"""Zamba2-style hybrid (the ``hybrid`` family, zamba2-1.2b): a Mamba-2
backbone with one *shared* (weight-tied) attention + MLP block applied
after every ``cfg.attn_every`` layers, on concat(hidden, the original
embedding).  Counterpart of the JAX package's ``models/hybrid_lm.py``.

Parameters: ``embed``, ``blocks`` (the Mamba layers, as in ``ssm_lm``),
``shared`` (``w_cat`` (2D, D), ``ln1``, ``attn``, ``ln2``, ``mlp``,
``w_out``), ``ln_f`` and, untied, ``unembed``.  The decode cache is
``{"mamba": ssm_lm's cache, "shared_kv": {"k", "v"}}``, one bf16 KV cache
(n_apps, B, max_len, Hkv, hd) per application of the shared block.  There
is no paged decode path: the family is served by
``launch.serve.generate_dense``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import pdot
from . import layers as L
from . import ssm_lm
from .lm import _positions, cross_entropy, embed, unembed_logits
from .modules import (dense_init, embed_init, generator, layer_views,
                      stack_init, zeros)


def _shared_block_init(gen, cfg, device):
    D = cfg.d_model
    return {
        "w_cat": dense_init(gen, (2 * D, D), fan_in=2 * D, device=device),
        "ln1": zeros((D,), device),
        "attn": L.attn_init(gen, cfg, device),
        "ln2": zeros((D,), device),
        "mlp": L.mlp_init(gen, cfg, device=device),
        "w_out": dense_init(gen, (D, D), fan_in=D, device=device),
    }


def group_sizes(cfg):
    """Layer groups: the shared block is applied after each full group."""
    n, g = cfg.n_layers, cfg.attn_every
    sizes = [g] * (n // g)
    if n % g:
        sizes.append(n % g)
    return sizes, n // g


def _order(cfg):
    """The layer order: ``("mamba", layer)`` for each Mamba layer and
    ``("shared", application)`` after each full group."""
    sizes, n_apps = group_sizes(cfg)
    first = 0
    for gi, gs in enumerate(sizes):
        for i in range(first, first + gs):
            yield "mamba", i
        first += gs
        if gi < n_apps:
            yield "shared", gi


def init(cfg, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    params = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model),
                                  device),
              "blocks": stack_init(
                  lambda: ssm_lm._layer_init(gen, cfg, device), cfg.n_layers),
              "shared": _shared_block_init(gen, cfg, device),
              "ln_f": zeros((cfg.d_model,), device)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       fan_in=cfg.d_model, device=device)
    return params


def _shared(sp, x, emb, cfg, attend):
    """The shared block; ``attend`` maps its normed input to the attention
    output."""
    u = pdot("bsd,de->bse", torch.cat([x, emb], dim=-1), sp["w_cat"],
             cfg.policy)
    u = u + attend(L.rmsnorm(sp["ln1"], u, cfg.norm_eps))
    u = u + L.mlp(sp["mlp"], L.rmsnorm(sp["ln2"], u, cfg.norm_eps), cfg)
    return x + pdot("bsd,de->bse", u, sp["w_out"], cfg.policy)


def _shared_apply(sp, x, emb, cfg, positions):
    return _shared(sp, x, emb, cfg, lambda h: L.attention(
        sp["attn"], h, cfg, positions, causal=True))


def _shared_decode(sp, x, emb, cfg, cache, cache_index):
    """The shared block for one token a row against one application's
    dense KV cache, which is updated in place."""
    return _shared(sp, x, emb, cfg, lambda h: L.attention_decode(
        sp["attn"], h, cfg, cache, cache_index)[0])


def backbone(params, tokens, cfg):
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    x = emb = embed(params, tokens, cfg)
    layers = layer_views(params["blocks"], cfg.n_layers)
    for kind, i in _order(cfg):
        if kind == "mamba":
            x = ssm_lm.mamba_block(layers[i], x, cfg)
        else:
            x = _shared_apply(params["shared"], x, emb, cfg, positions)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def loss_fn(params, batch, cfg):
    """``(loss, metrics)`` of a batch ``{"tokens", "labels"}`` (B, S)."""
    x = backbone(params, batch["tokens"], cfg)
    loss, denom = cross_entropy(unembed_logits(params, x, cfg),
                                batch["labels"])
    return loss, {"loss": loss, "lm_loss": loss, "tokens": denom}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    device = resolve_device(device)
    _, n_apps = group_sizes(cfg)
    shape = (n_apps, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"mamba": ssm_lm.init_cache(cfg, batch, max_len, device=device),
            "shared_kv": {k: torch.zeros(shape, dtype=dtype, device=device)
                          for k in ("k", "v")}}


def decode_step(params, cfg, cache, tokens, cache_index):
    """One decode step at position ``cache_index``. tokens: (B,); returns
    ``(logits (B, V), cache)``, the cache updated in place."""
    x = emb = embed(params, tokens[:, None], cfg)
    n = cfg.n_layers
    layers = layer_views(params["blocks"], n)
    caches = layer_views(cache["mamba"], n)
    kvs = layer_views(cache["shared_kv"], group_sizes(cfg)[1])
    for kind, i in _order(cfg):
        if kind == "mamba":
            x = ssm_lm.mamba_block_decode(layers[i], x, cfg, caches[i])
        else:
            x = _shared_decode(params["shared"], x, emb, cfg, kvs[i],
                               cache_index)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)[:, 0], cache


def forward_logits(params, tokens, cfg):
    """Logits of whole sequences: tokens (B, S) -> (B, S, V)."""
    return unembed_logits(params, backbone(params, tokens, cfg), cfg)
