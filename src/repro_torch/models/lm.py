"""Decoder-only LM: the dense family (qwen3-0.6b; qwen2.5-14b with its QKV
bias; gemma-2b and gemma2-9b: GeGLU, scaled embeddings, sandwich norms,
local/global windows, the attention and final softcaps, head_dim 256) and
the MoE family (granite-style: GShard top-k experts in place of the MLP;
deepseek-v3-671b: dense first layers, a shared expert, MLA attention from
``models.mla`` and the multi-token-prediction head).

Parameters are the JAX package's ``lm.init`` tree as nested dicts of
tensors: ``embed``, ``ln_f``, ``dense_blocks`` for the first
``cfg.first_dense_layers`` layers (every layer in the dense family) and
``moe_blocks`` for the rest, whose leaves carry a leading layer axis.  The
layer loop is a Python loop over that axis (the counterpart of
``lax.scan``) over one ``unbind`` of each stack, so a training backward
stacks the layers' gradients once; under autograd with ``cfg.remat`` it
recomputes each block in the backward (``jax.checkpoint`` of
``stack_apply``).  Two caches serve decoding: the engine's paged pools
(:func:`init_paged_cache`, :func:`decode_step_paged`, kernel 3) and the
dense cache of ``launch.serve.generate_dense`` (:func:`init_cache`,
:func:`decode_step`, attended in plain bf16 as JAX does); both are updated
in place.  With MLA both caches hold the latent ``{"c_kv", "k_rope"}``
entries in place of ``{"k", "v"}``.  The VLM family (``models.vlm_lm``)
reuses the parameters, the block stack (:func:`apply_blocks`), the
unembedding and the dense-cache decode of this module; the enc-dec family
(``models.encdec_lm``) has entries of its own, and this module refuses it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import pdot
from repro_torch.parallel import ctx
from . import layers as L
from . import mla as M
from .modules import (checkpointed, dense_init, embed_init, generator, layer,
                      layer_views, stack_init, tree_leaves, zeros)


def _check_ported(cfg):
    if cfg.family not in ("dense", "moe", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not served by "
            "models.lm")


def stacks(cfg) -> list[tuple[str, int, bool]]:
    """``(tree key, layers, moe)`` of each layer stack, in layer order:
    ``dense_blocks`` for the first ``first_dense_layers`` layers (all of
    them without experts), ``moe_blocks`` for the rest."""
    n_moe = (cfg.n_layers - cfg.first_dense_layers) if cfg.n_experts else 0
    n_dense = cfg.n_layers - n_moe
    return [(name, n, moe) for name, n, moe in (
        ("dense_blocks", n_dense, False), ("moe_blocks", n_moe, True)) if n]


# --------------------------------------------------------------- blocks

def block_init(gen, cfg, device=None, *, moe: bool = False):
    p = {"ln1": zeros((cfg.d_model,), device),
         "ln2": zeros((cfg.d_model,), device),
         "attn": (M.mla_init if cfg.use_mla else L.attn_init)(gen, cfg,
                                                              device)}
    if moe:
        p["moe"] = L.moe_init(gen, cfg, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg, device=device)
    if cfg.sandwich_norms:
        p["post_ln1"] = zeros((cfg.d_model,), device)
        p["post_ln2"] = zeros((cfg.d_model,), device)
    return p


def _residual_ffn(p, x, a, cfg, moe):
    """The block after attention: ``(x + ffn, aux)``; ``aux`` is the MoE
    layer's load-balancing term, None in a dense block."""
    if cfg.sandwich_norms:
        a = L.rmsnorm(p["post_ln1"], a, cfg.norm_eps)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if moe:
        m, aux = L.moe(p["moe"], h, cfg)
    else:
        m, aux = L.mlp(p["mlp"], h, cfg), None
    if cfg.sandwich_norms:
        m = L.rmsnorm(p["post_ln2"], m, cfg.norm_eps)
    return x + m, aux


def block_prefill(p, x, cfg, positions, window, *, moe: bool = False):
    """One block over a whole sequence: ``(x, aux, kv)`` with the block's
    K/V (MLA: its latent entries)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        a, kv = M.mla_attention_prefill(p["attn"], h, cfg, positions)
    else:
        a, kv = L.attention_prefill(p["attn"], h, cfg, positions,
                                    window=window)
    x, aux = _residual_ffn(p, x, a, cfg, moe)
    return x, aux, kv


def block_decode(p, x, cfg, cache, cache_index, window, *, moe: bool = False):
    """One block for one decode token a row at position ``cache_index``,
    against its dense K/V cache (written in place)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        a, _ = M.mla_decode(p["attn"], h, cfg, cache, cache_index)
    else:
        a, _ = L.attention_decode(p["attn"], h, cfg, cache, cache_index,
                                  window=window)
    return _residual_ffn(p, x, a, cfg, moe)[0]


def block_decode_paged(p, x, cfg, pool, block_tables, lengths, window, *,
                       moe: bool = False):
    """One block for one decode token per slot, against its page pool."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        a = M.mla_decode_paged(p["attn"], h, cfg, pool, block_tables,
                               lengths)
    else:
        a = L.attention_decode_paged(p["attn"], h, cfg, pool, block_tables,
                                     lengths, window=window)
    return _residual_ffn(p, x, a, cfg, moe)[0]


def block_chunk(p, x, cfg, cache, start, window, *, moe: bool = False):
    """:func:`block_prefill` for one chunk of a prompt, reading and
    extending the layer's dense scratch cache (chunked prefill)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        a, _ = M.mla_attention_chunk(p["attn"], h, cfg, cache, start)
    else:
        a, _ = L.attention_chunk(p["attn"], h, cfg, cache, start,
                                 window=window)
    return _residual_ffn(p, x, a, cfg, moe)[0]


def layer_windows(cfg, n_layers: int) -> np.ndarray:
    """Per-layer sliding windows (0 = global) — gemma2's local/global."""
    if cfg.local_global_period and cfg.sliding_window:
        return np.asarray(
            [cfg.sliding_window if i % cfg.local_global_period == 0 else 0
             for i in range(n_layers)], dtype=np.int32)
    if cfg.sliding_window:
        return np.full((n_layers,), cfg.sliding_window, dtype=np.int32)
    return np.zeros((n_layers,), dtype=np.int32)


def _stack_layers(cfg, views_of):
    """``(name, moe, layer index in its stack, layer tree, window)`` of
    every layer in order; ``views_of(name, n)`` gives a stack's layers."""
    windows = layer_windows(cfg, cfg.n_layers)
    first = 0
    for name, n, moe in stacks(cfg):
        for i, p in enumerate(views_of(name, n)):
            yield name, moe, i, p, int(windows[first + i])
        first += n


# ----------------------------------------------------------- top level

def init(cfg, seed: int = 0, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``.
    Each layer stack's leaves are drawn straight into their slots
    (``modules.stack_init``), so the peak is the weights: deepseek-v3-671b
    cut to 4 layers (60 GB in f32, one MoE layer 46 GB) initializes on an
    80 GB card.  With ``cfg.mtp``, the multi-token-prediction head:
    ``mtp_block`` (a MoE block when the config has experts) and
    ``mtp_proj`` (2 d_model, d_model)."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = generator(seed, device)
    params = {"embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model),
                                  device),
              "ln_f": zeros((cfg.d_model,), device)}
    for name, n, moe in stacks(cfg):
        params[name] = stack_init(
            lambda: block_init(gen, cfg, device, moe=moe), n)
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                       fan_in=cfg.d_model, device=device)
    if cfg.mtp:
        params["mtp_block"] = block_init(gen, cfg, device,
                                         moe=bool(cfg.n_experts))
        params["mtp_proj"] = dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                        fan_in=2 * cfg.d_model, device=device)
    return params


def _gather_rows(table, tokens):
    """``table[tokens]`` for a DTensor table that no rank splits: the rows
    are gathered from the local (whole) table by the same indexing as
    without a mesh, so the gradient sums repeated tokens in the same
    order.  The rows take the tokens' layout; the table's gradient is a
    partial sum over the mesh dims that split the tokens (the data axes),
    which the train step reduces once."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if ctx.is_dtensor(tokens):
        idx, placements = tokens.to_local(), tuple(tokens.placements)
    else:
        idx, placements = tokens, (Replicate(),) * mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate() for p in placements]
    rows = table.to_local(grad_placements=grad)[idx.long()]
    shape = tuple(tokens.shape) + tuple(table.shape[1:])
    return DTensor.from_local(rows, mesh, placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def embed(params, tokens, cfg):
    """The token rows of the table, f32, batch on the data axes under a
    mesh (JAX :250-255).  A table split over ranks (vocab on ``model``) is
    gathered through ``F.embedding``, which DTensor shards (indexing it has
    no rule); a whole one through :func:`_gather_rows`."""
    table = params["embed"]
    if not ctx.is_dtensor(table):
        x = table[tokens.long()]
    elif any(p.is_shard() for p in table.placements):
        x = F.embedding(tokens.long(), table)
    else:
        x = _gather_rows(table, tokens)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return ctx.constrain(x.float(), ctx.dp_axes(), None, None)


def unembed_logits(params, x, cfg):
    """Logits, vocab on ``model`` under a mesh (JAX :258-263)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = pdot("bsd,dv->bsv", x, w, cfg.logits_policy or cfg.policy)
    logits = ctx.constrain(logits, ctx.dp_axes(), None, "model")
    return L.softcap(logits, cfg.final_softcap)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _grad_needed(params) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))


def _block_out(p, x, cfg, positions, window, moe):
    return block_prefill(p, x, cfg, positions, window, moe=moe)[:2]


def apply_blocks(params, x, cfg, positions, kv_out=None):
    """Run every block of every stack over ``x`` (B, S, d_model), each at
    its layer's window (JAX's ``stack_apply`` over each stack in turn) ->
    ``(x, aux)``, before the final norm; ``aux`` sums the MoE layers'
    load-balancing terms (None without MoE layers).  Each block's K/V is
    appended to ``kv_out[stack name]`` when a dict is given.  The layers
    come from one ``unbind`` of each stack; when autograd needs the
    parameters' gradient and ``cfg.remat`` is set, each block is recomputed
    in the backward (K/V are then not kept)."""
    remat = cfg.remat and kv_out is None and _grad_needed(params)
    aux = None
    for name, moe, _, p, w in _stack_layers(
            cfg, lambda name, n: layer_views(params[name], n)):
        if remat:
            x, a = checkpointed(_block_out, p, x, cfg, positions, w, moe)
        else:
            x, a, kv = block_prefill(p, x, cfg, positions, w, moe=moe)
            if kv_out is not None:
                kv_out.setdefault(name, []).append(kv)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def backbone(params, tokens, cfg, positions, kv_out=None):
    """Embed, :func:`apply_blocks`, final norm -> ``(x (B, S, d_model),
    aux)``."""
    x, aux = apply_blocks(params, embed(params, tokens, cfg), cfg, positions,
                          kv_out)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps), aux


def forward_logits(params, tokens, cfg):
    """Logits of whole sequences: tokens (B, S) -> (B, S, V)."""
    _check_ported(cfg)
    B, S = tokens.shape
    x, _ = backbone(params, tokens, cfg, _positions(B, S, tokens.device))
    return unembed_logits(params, x, cfg)


def cross_entropy(logits, labels, z_loss_w: float = 1e-4):
    """Masked CE with z-loss; labels < 0 are ignored.  Returns ``(loss,
    tokens counted)``.  The label's logit is gathered, where JAX sums
    against a one-hot: the same value, without a (B, S, V) one-hot.
    Under a mesh whose ``model`` axis splits the vocab (JAX :294-307 keeps
    it split and constrains its one-hot there) the log-normalizer and the
    label's logit come from each rank's shard
    (``parallel.ctx.logz_and_pick``: reductions over ``model``), so no
    rank holds the whole vocab; with the vocab whole the code is the
    unsharded one."""
    mask = (labels >= 0).float()
    lbl = labels.clamp_min(0).long()
    logits = logits.float()
    if ctx.vocab_split(logits) is not None:
        logz, ll = ctx.logz_and_pick(logits, lbl)
    else:
        logits = ctx.constrain(logits, ctx.dp_axes(), None, None)
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, lbl[..., None])[..., 0]
    nll = (logz - ll) * mask
    zl = z_loss_w * logz.square() * mask
    denom = mask.sum().clamp_min(1.0)
    return (nll + zl).sum() / denom, denom


def loss_fn(params, batch, cfg):
    """``(loss, metrics)`` of a batch ``{"tokens", "labels"}`` (B, S):
    metrics ``lm_loss``, ``aux_loss`` (the MoE layers' summed
    load-balancing term; 0 in the dense family), ``tokens`` and ``loss``
    (``lm_loss + 0.01 aux_loss`` with experts).  With ``cfg.mtp``,
    DeepSeek-V3's multi-token prediction (one extra depth predicting t + 2):
    ``mtp_loss`` is the CE of ``mtp_block`` over ``mtp_proj`` of the final
    hidden state at t beside the embedding of token t + 1, against
    ``labels[:, 1:]``, and ``loss`` adds ``0.3 mtp_loss``.  The head's own
    MoE aux term is dropped, as in JAX."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, aux = backbone(params, tokens, cfg, _positions(B, S, tokens.device))
    logits = unembed_logits(params, x, cfg)
    loss, denom = cross_entropy(logits, batch["labels"])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    metrics = {"lm_loss": loss, "aux_loss": aux, "tokens": denom}
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    if cfg.mtp:
        h = torch.cat([x[:, :-1], embed(params, tokens, cfg)[:, 1:]], dim=-1)
        h = pdot("bsd,de->bse", h, params["mtp_proj"], cfg.policy)
        h = block_prefill(params["mtp_block"], h, cfg,
                          _positions(B, S - 1, tokens.device), 0,
                          moe=bool(cfg.n_experts))[0]
        mtp_loss, _ = cross_entropy(unembed_logits(params, h, cfg),
                                    batch["labels"][:, 1:])
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


def prefill(params, cfg, tokens, positions=None):
    """Sequence-level prefill: logits (B, P, V) and every layer's K/V.

    tokens: (B, P) (right-padded prompts; causal masking keeps padded tails
    from influencing earlier positions, though in the MoE layers they take
    expert capacity).  ``kv`` mirrors the cache tree: ``{stack: {"k":
    (layers, B, P, Hkv, hd), "v": ...}}`` for each of :func:`stacks`
    (MLA: ``{"c_kv": (layers, B, P, kvr), "k_rope": (layers, B, P, dr)}``).
    """
    _check_ported(cfg)
    B, P = tokens.shape
    if positions is None:
        positions = _positions(B, P, tokens.device)
    kvs: dict = {}
    x, _ = backbone(params, tokens, cfg, positions, kvs)
    return unembed_logits(params, x, cfg), {
        name: {k: torch.stack([kv[k] for kv in per_layer])
               for k in per_layer[0]} for name, per_layer in kvs.items()}


def prefill_chunk(params, cfg, cache, tokens, start: int):
    """One chunk of a chunked prefill: every layer's dense scratch ``cache``
    (an :func:`init_cache` tree, f32 for exact parity, leaves (layers, B,
    T, ...)) takes the K/V of ``tokens`` (B, C) at positions ``start ..
    start + C`` in place, and the chunk's logits (B, C, V) are returned.
    Running every chunk matches the monolithic :func:`prefill` row for row
    (the serving engine's chunked-prefill contract; in the MoE layers the
    routing groups are the chunk's, as in JAX)."""
    _check_ported(cfg)
    x = embed(params, tokens, cfg)
    for name, moe, i, p, w in _stack_layers(
            cfg, lambda name, n: (layer(params[name], j) for j in range(n))):
        x = block_chunk(p, x, cfg, layer(cache[name], i), start, w, moe=moe)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)


def _kv_cache(cfg, rows, dtype, device):
    """``{stack: {"k", "v"}}`` for each of :func:`stacks`, zero leaves
    (layers, *rows, Hkv, hd); with MLA ``{stack: {"c_kv", "k_rope"}}``,
    leaves (layers, *rows, kvr) and (layers, *rows, dr)."""
    _check_ported(cfg)
    device = resolve_device(device)
    if cfg.use_mla:
        one = M.mla_init_cache(cfg, *rows, dtype, device="meta")
    else:
        one = {k: torch.empty((*rows, cfg.n_kv_heads, cfg.head_dim),
                              device="meta") for k in ("k", "v")}
    return {name: {k: torch.zeros((n, *t.shape), dtype=dtype, device=device)
                   for k, t in one.items()} for name, n, _ in stacks(cfg)}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """The dense KV cache of ``launch.serve.generate_dense`` (and, in f32,
    a chunked prefill's scratch): leaves (layers, batch, max_len, Hkv, hd),
    or MLA's latent leaves."""
    return _kv_cache(cfg, (batch, max_len), dtype, device)


def init_paged_cache(cfg, num_pages: int, page_size: int,
                     dtype=torch.bfloat16, device=None):
    """The paged KV cache: leaves (layers, num_pages, page_size, Hkv, hd),
    or MLA's latent leaves, shared by all slots.  Page 0 is the engine's
    scrap page — inactive slots write into it."""
    return _kv_cache(cfg, (num_pages, page_size), dtype, device)


def decode_step_paged(params, cfg, pools, block_tables, lengths, tokens):
    """One decode step against the paged cache with per-slot lengths.

    tokens: (B,) — one token per slot; block_tables: (B, maxp) i32; lengths:
    (B,) i32 tokens already cached per slot (the current token's position).
    Writes each slot's new K/V into ``pools`` in place and returns the
    logits (B, V).  In the MoE layers every slot, active or not, is routed
    as one token of a group of B."""
    x = embed(params, tokens[:, None], cfg)
    for name, moe, i, p, w in _stack_layers(
            cfg, lambda name, n: (layer(params[name], j) for j in range(n))):
        x = block_decode_paged(p, x, cfg, layer(pools[name], i),
                               block_tables, lengths, w, moe=moe)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)[:, 0]


def decode_step(params, cfg, cache, tokens, cache_index):
    """One decode step against the dense cache, every row at position
    ``cache_index``. tokens: (B,); returns ``(logits (B, V), cache)``, the
    cache updated in place."""
    x = embed(params, tokens[:, None], cfg)
    for name, moe, i, p, w in _stack_layers(
            cfg, lambda name, n: (layer(params[name], j) for j in range(n))):
        x = block_decode(p, x, cfg, layer(cache[name], i), cache_index, w,
                         moe=moe)
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)[:, 0], cache


__all__ = ["init", "embed", "unembed_logits", "apply_blocks", "backbone",
           "prefill", "prefill_chunk", "forward_logits", "cross_entropy",
           "loss_fn", "init_cache", "init_paged_cache", "decode_step",
           "decode_step_paged", "layer_windows", "stacks", "block_init",
           "block_prefill", "block_decode", "block_decode_paged",
           "block_chunk"]
