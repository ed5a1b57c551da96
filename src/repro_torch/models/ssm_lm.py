"""Mamba-2 language model: an SSD backbone, attention-free (the ``ssm``
family, mamba2-130m).  Counterpart of the JAX package's
``models/ssm_lm.py``.

Parameters: ``embed``, ``blocks`` (leaves with a leading layer axis: each
layer's ``ln`` and ``ssd`` tree), ``ln_f`` and, without tied embeddings,
``unembed``.  The decode cache is one :func:`ssd.ssd_init_cache` tree with
a leading layer axis.  There is no paged decode path: the family is
served by ``launch.serve.generate_dense``.
"""
from __future__ import annotations

from repro_torch import resolve_device
from . import layers as L
from . import ssd
from .lm import cross_entropy, embed, unembed_logits
from .modules import (dense_init, embed_init, generator, layer_views,
                      stack_init, tree_map, zeros)


def _layer_init(gen, cfg, device):
    return {"ln": zeros((cfg.d_model,), device),
            "ssd": ssd.ssd_init(gen, cfg, device)}


def init(cfg, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``."""
    device = resolve_device(device)
    gen = generator(seed, device)
    params = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model),
                                  device),
              "blocks": stack_init(lambda: _layer_init(gen, cfg, device),
                                   cfg.n_layers),
              "ln_f": zeros((cfg.d_model,), device)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       fan_in=cfg.d_model, device=device)
    return params


def mamba_block(lp, x, cfg):
    """One pre-norm residual Mamba layer over whole sequences."""
    return x + ssd.ssd_layer(lp["ssd"], L.rmsnorm(lp["ln"], x, cfg.norm_eps),
                             cfg)


def mamba_block_decode(lp, x, cfg, cache):
    """:func:`mamba_block` for one token a row; the layer's new conv
    windows and state are written into ``cache`` in place."""
    o, new = ssd.ssd_decode(lp["ssd"], L.rmsnorm(lp["ln"], x, cfg.norm_eps),
                            cfg, cache)
    for k, v in new.items():
        cache[k].copy_(v)
    return x + o


def backbone(params, tokens, cfg):
    x = embed(params, tokens, cfg)
    for lp in layer_views(params["blocks"], cfg.n_layers):
        x = mamba_block(lp, x, cfg)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def loss_fn(params, batch, cfg):
    """``(loss, metrics)`` of a batch ``{"tokens", "labels"}`` (B, S)."""
    x = backbone(params, batch["tokens"], cfg)
    loss, denom = cross_entropy(unembed_logits(params, x, cfg),
                                batch["labels"])
    return loss, {"loss": loss, "lm_loss": loss, "tokens": denom}


def init_cache(cfg, batch: int, max_len: int, dtype=None, device=None):
    """Every layer's conv windows and SSM state, f32, leaves (n_layers,
    batch, ...).  ``max_len`` and ``dtype`` are unused (the state does not
    grow with the sequence); they keep the families' signature."""
    one = ssd.ssd_init_cache(cfg, batch, resolve_device(device))
    return tree_map(lambda a: a.new_zeros((cfg.n_layers, *a.shape)), one)


def decode_step(params, cfg, cache, tokens, cache_index):
    """One decode step. tokens: (B,); returns ``(logits (B, V), cache)``,
    the cache updated in place."""
    x = embed(params, tokens[:, None], cfg)
    n = cfg.n_layers
    for lp, c in zip(layer_views(params["blocks"], n),
                     layer_views(cache, n)):
        x = mamba_block_decode(lp, x, cfg, c)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)[:, 0], cache


def forward_logits(params, tokens, cfg):
    """Logits of whole sequences: tokens (B, S) -> (B, S, V)."""
    return unembed_logits(params, backbone(params, tokens, cfg), cfg)
