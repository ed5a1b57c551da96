"""Decoder-only LM, dense family (qwen3 / gemma-style blocks).

Parameters are the JAX package's ``lm.init`` tree as nested dicts of
tensors: ``embed``, ``ln_f`` and ``dense_blocks`` whose leaves carry a
leading layer axis.  The layer loop is a Python loop over that axis (the
counterpart of ``lax.scan``) over one ``unbind`` of the stack, so a
training backward stacks the layers' gradients once; under autograd with
``cfg.remat`` it recomputes each block in the backward (``jax.checkpoint``
of ``stack_apply``).  The MoE, MLA and multi-token-prediction variants of the
JAX module are not ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core import pdot
from . import layers as L
from .modules import (dense_init, embed_init, generator, layer, layer_views,
                      stack_init, tree_leaves, zeros)


def _check_dense(cfg):
    if cfg.family != "dense" or cfg.n_experts or cfg.use_mla or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported to PyTorch so far")


# --------------------------------------------------------------- blocks

def block_init(gen, cfg, device=None):
    p = {"ln1": zeros((cfg.d_model,), device),
         "ln2": zeros((cfg.d_model,), device),
         "attn": L.attn_init(gen, cfg, device),
         "mlp": L.mlp_init(gen, cfg, device=device)}
    if cfg.sandwich_norms:
        p["post_ln1"] = zeros((cfg.d_model,), device)
        p["post_ln2"] = zeros((cfg.d_model,), device)
    return p


def _residual_mlp(p, x, a, cfg):
    if cfg.sandwich_norms:
        a = L.rmsnorm(p["post_ln1"], a, cfg.norm_eps)
    x = x + a
    m = L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    if cfg.sandwich_norms:
        m = L.rmsnorm(p["post_ln2"], m, cfg.norm_eps)
    return x + m


def block_prefill(p, x, cfg, positions, window):
    """One block over a whole sequence; also returns the block's K/V."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = L.attention_prefill(p["attn"], h, cfg, positions, window=window)
    return _residual_mlp(p, x, a, cfg), kv


def block_decode_paged(p, x, cfg, pool, block_tables, lengths, window):
    """One block for one decode token per slot, against its page pool."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a = L.attention_decode_paged(p["attn"], h, cfg, pool, block_tables,
                                 lengths, window=window)
    return _residual_mlp(p, x, a, cfg)


def layer_windows(cfg, n_layers: int) -> np.ndarray:
    """Per-layer sliding windows (0 = global) — gemma2's local/global."""
    if cfg.local_global_period and cfg.sliding_window:
        return np.asarray(
            [cfg.sliding_window if i % cfg.local_global_period == 0 else 0
             for i in range(n_layers)], dtype=np.int32)
    if cfg.sliding_window:
        return np.full((n_layers,), cfg.sliding_window, dtype=np.int32)
    return np.zeros((n_layers,), dtype=np.int32)


# ----------------------------------------------------------- top level

def init(cfg, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``."""
    _check_dense(cfg)
    device = resolve_device(device)
    gen = generator(seed, device)
    params = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model),
                                  device),
              "ln_f": zeros((cfg.d_model,), device),
              "dense_blocks": stack_init(
                  lambda: block_init(gen, cfg, device), cfg.n_layers)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       fan_in=cfg.d_model, device=device)
    return params


def embed(params, tokens, cfg):
    x = params["embed"][tokens.long()]
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x.float()


def unembed_logits(params, x, cfg):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = pdot("bsd,dv->bsv", x, w, cfg.logits_policy or cfg.policy)
    return L.softcap(logits, cfg.final_softcap)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _grad_needed(params) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))


def _block_out(p, x, cfg, positions, window):
    return block_prefill(p, x, cfg, positions, window)[0]


def backbone(params, tokens, cfg, positions, kv_out=None):
    """Embed, run every block, final norm -> (B, S, d_model).  Each block's
    K/V is appended to ``kv_out`` when a list is given.  The layers come
    from one ``unbind`` of the stack; when autograd needs the parameters'
    gradient and ``cfg.remat`` is set, each block is recomputed in the
    backward (K/V are then not kept)."""
    x = embed(params, tokens, cfg)
    windows = layer_windows(cfg, cfg.n_layers)
    remat = cfg.remat and kv_out is None and _grad_needed(params)
    for p, w in zip(layer_views(params["dense_blocks"], cfg.n_layers),
                    windows):
        if remat:
            x = checkpoint(_block_out, p, x, cfg, positions, int(w),
                           use_reentrant=False)
            continue
        x, kv = block_prefill(p, x, cfg, positions, int(w))
        if kv_out is not None:
            kv_out.append(kv)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def forward(params, tokens, cfg):
    """Logits of whole sequences: tokens (B, S) -> (B, S, V)."""
    _check_dense(cfg)
    B, S = tokens.shape
    x = backbone(params, tokens, cfg, _positions(B, S, tokens.device))
    return unembed_logits(params, x, cfg)


def cross_entropy(logits, labels, z_loss_w: float = 1e-4):
    """Masked CE with z-loss; labels < 0 are ignored.  Returns ``(loss,
    tokens counted)``.  The label's logit is gathered, where JAX sums
    against a one-hot: the same value, without a (B, S, V) one-hot."""
    mask = (labels >= 0).float()
    lbl = labels.clamp_min(0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lbl[..., None])[..., 0]
    nll = (logz - ll) * mask
    zl = z_loss_w * logz.square() * mask
    denom = mask.sum().clamp_min(1.0)
    return (nll + zl).sum() / denom, denom


def loss_fn(params, batch, cfg):
    """``(loss, metrics)`` of a batch ``{"tokens", "labels"}`` (B, S):
    metrics ``lm_loss``, ``aux_loss`` (0 in the dense family), ``tokens``
    and ``loss``."""
    _check_dense(cfg)
    logits = forward(params, batch["tokens"], cfg)
    loss, denom = cross_entropy(logits, batch["labels"])
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"lm_loss": loss, "aux_loss": aux, "tokens": denom,
                  "loss": loss}


def prefill(params, cfg, tokens, positions=None):
    """Sequence-level prefill: logits (B, P, V) and every layer's K/V.

    tokens: (B, P) (right-padded prompts; causal masking keeps padded tails
    from influencing earlier positions).  ``kv`` mirrors the cache tree:
    ``{"dense_blocks": {"k": (n_layers, B, P, Hkv, hd), "v": ...}}``.
    """
    _check_dense(cfg)
    B, P = tokens.shape
    if positions is None:
        positions = _positions(B, P, tokens.device)
    kvs: list = []
    x = backbone(params, tokens, cfg, positions, kvs)
    return unembed_logits(params, x, cfg), {"dense_blocks": {
        name: torch.stack([kv[name] for kv in kvs]) for name in ("k", "v")}}


def init_paged_cache(cfg, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device=None):
    """The paged KV cache: ``{"dense_blocks": {"k", "v"}}`` with leaves
    (n_layers, num_pages, page_size, Hkv, hd) shared by all slots.  Page 0
    is the engine's scrap page — inactive slots write into it."""
    _check_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"dense_blocks": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}}


def decode_step_paged(params, cfg, pools, block_tables, lengths, tokens):
    """One decode step against the paged cache with per-slot lengths.

    tokens: (B,) — one token per slot; block_tables: (B, maxp) i32; lengths:
    (B,) i32 tokens already cached per slot (the current token's position).
    Writes each slot's new K/V into ``pools`` in place and returns the
    logits (B, V)."""
    x = embed(params, tokens[:, None], cfg)
    windows = layer_windows(cfg, cfg.n_layers)
    stacked = pools["dense_blocks"]
    for i in range(cfg.n_layers):
        x = block_decode_paged(layer(params["dense_blocks"], i), x, cfg,
                               layer(stacked, i), block_tables, lengths,
                               int(windows[i]))
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)[:, 0]


__all__ = ["init", "embed", "unembed_logits", "backbone", "prefill",
           "forward", "cross_entropy", "loss_fn", "init_paged_cache",
           "decode_step_paged", "layer_windows", "block_init", "block_prefill",
           "block_decode_paged"]
