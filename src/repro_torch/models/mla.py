"""Multi-head Latent Attention (DeepSeek-V2/V3): low-rank Q and KV
compression, decoupled RoPE keys, and the compressed-cache decode (the
"absorb" formulation): the cache holds only ``(c_kv, k_rope)`` a token.
The port of ``repro/models/mla.py``, function for function.

Every projection is a policy product (kernel 1 on the card).  The prefill
decompresses K and V and attends through :func:`layers.sdpa` (kernel 2, a
qk head dim of nope + rope = 192 beside a v head dim of 128 at full
width).  Decode attends in the latent space: ``W_uk`` is absorbed into the
query and ``W_uv`` applied after the attend, both batched over heads, and
kernel 1 reads their per-head views of the weights where they lie.  The
latent attend itself is three plain ``bf16`` products over the dense cache
or a gather of the slot's pages, as in JAX (kernel 3 takes the standard
K/V layout, not this contraction).  Both caches are written in place.
Chunked prefill (:func:`mla_attention_chunk`) takes the decompressed attend
of the prefill, not the absorbed decode.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import pdot
from repro_torch.parallel import ctx
from .layers import NEG_INF, rmsnorm, rope, sdpa
from .modules import dense_init, zeros


def mla_init(gen, cfg, device=None):
    D, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "w_dq": dense_init(gen, (D, qr), fan_in=D, device=device),
        "q_norm": zeros((qr,), device),
        "w_uq": dense_init(gen, (qr, H, dn + dr), fan_in=qr, device=device),
        "w_dkv": dense_init(gen, (D, kvr), fan_in=D, device=device),
        "kv_norm": zeros((kvr,), device),
        "w_uk": dense_init(gen, (kvr, H, dn), fan_in=kvr, device=device),
        "w_uv": dense_init(gen, (kvr, H, dv), fan_in=kvr, device=device),
        "w_kr": dense_init(gen, (D, dr), fan_in=D, device=device),
        "wo": dense_init(gen, (H, dv, D), fan_in=H * dv, device=device),
    }


def _q_proj(p, x, cfg, positions):
    dn = cfg.qk_nope_dim
    cq = rmsnorm(p["q_norm"], pdot("bsd,dr->bsr", x, p["w_dq"], cfg.policy),
                 cfg.norm_eps)
    q = pdot("bsr,rhk->bshk", cq, p["w_uq"], cfg.policy)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _kv_compress(p, x, cfg, positions):
    c_kv = rmsnorm(p["kv_norm"],
                   pdot("bsd,dr->bsr", x, p["w_dkv"], cfg.policy),
                   cfg.norm_eps)
    k_rope = pdot("bsd,dk->bsk", x, p["w_kr"], cfg.policy)
    k_rope = rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_attention(p, x, cfg, positions):
    """Prefill / train path: decompress K and V, attend (kernel 2)."""
    return mla_attention_prefill(p, x, cfg, positions)[0]


def mla_attention_prefill(p, x, cfg, positions):
    """:func:`mla_attention` that also returns the latent cache entries
    ``{"c_kv": (B, S, kvr), "k_rope": (B, S, dr)}`` it computed."""
    B, S, _ = x.shape
    H, dr = cfg.n_heads, cfg.qk_rope_dim
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    c_kv, k_rope = _kv_compress(p, x, cfg, positions)
    k_nope = pdot("bsr,rhk->bshk", c_kv, p["w_uk"], cfg.policy)
    v = pdot("bsr,rhk->bshk", c_kv, p["w_uv"], cfg.policy)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, dr)],
                  dim=-1)
    o = sdpa(q, k, v, cfg, positions, positions, causal=True)
    out = pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy)
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def mla_attention_chunk(p, x, cfg, cache, start: int):
    """One prefill chunk against a dense latent scratch cache.

    x: (B, C, D) at positions ``start .. start + C``; cache: the
    :func:`mla_init_cache` leaves (B, T, kvr) / (B, T, dr) holding earlier
    chunks' entries, into which the chunk's are written (in place).  It
    takes the decompressed attend of :func:`mla_attention_prefill` (kernel
    2 at qk 192 beside v 128 at full width), not the absorbed decode, so
    with an f32 scratch the chunk's rows are the monolithic prefill's.
    Returns ``(out, cache)``."""
    B, C = x.shape[:2]
    H, dr = cfg.n_heads, cfg.qk_rope_dim
    positions = (start + torch.arange(C, dtype=torch.int32, device=x.device)
                 )[None].expand(B, C)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    c_kv_t, k_rope_t = _kv_compress(p, x, cfg, positions)
    cache["c_kv"][:, start:start + C] = c_kv_t.to(cache["c_kv"].dtype)
    cache["k_rope"][:, start:start + C] = k_rope_t.to(cache["k_rope"].dtype)
    ck, kr = cache["c_kv"], cache["k_rope"]
    T = ck.shape[1]
    k_nope = pdot("bsr,rhk->bshk", ck, p["w_uk"], cfg.policy)
    v = pdot("bsr,rhk->bshk", ck, p["w_uv"], cfg.policy)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, T, H, dr)], dim=-1)
    k_pos = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(
        B, T)
    o = sdpa(q, k, v, cfg, positions, k_pos, causal=True)
    return pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy), cache


def mla_init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
    """One layer's dense latent cache: ``c_kv`` (batch, max_len, kvr) and
    ``k_rope`` (batch, max_len, dr)."""
    return {
        "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                              device=device),
    }


def _mla_attend(p, q_c, q_rope, ck, kr, cfg, cur_pos):
    """The absorbed-space attend over a dense-layout latent cache view.

    q_c: (B, 1, H, kvr); q_rope: (B, 1, H, dr); ck / kr: (B, T, kvr) / (B,
    T, dr), the dense cache or a page gather; ``cur_pos``: the current
    token's position, an int (dense decode) or a (B,) tensor (the engine's
    slots).  The cache products are plain ``bf16`` products, as in JAX: no
    f32 copy of the cache."""
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    s_c = pdot("bshr,btr->bhst", q_c, ck, "bf16")
    s_r = pdot("bshk,btk->bhst", q_rope, kr, "bf16")
    s = (s_c + s_r) / math.sqrt(dn + dr)
    T = ck.shape[1]
    if torch.is_tensor(cur_pos):
        cur = cur_pos.reshape(-1, 1)
    else:
        cur = torch.full((1, 1), int(cur_pos), dtype=torch.int32,
                         device=ck.device)
    valid = torch.arange(T, device=ck.device)[None] <= cur     # (B or 1, T)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    pr = torch.softmax(s.float(), dim=-1)
    ctx = pdot("bhst,btr->bshr", pr, ck, "bf16")
    o = pdot("bshr,rhk->bshk", ctx, p["w_uv"], cfg.policy)     # (B,1,H,dv)
    return pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy)


def mla_decode(p, x, cfg, cache, cache_index: int):
    """Absorbed decode against a dense latent cache, every row at position
    ``cache_index``: the token's ``(c_kv, k_rope)`` is written into
    ``cache`` in place (JAX returns an updated copy).  Returns ``(out,
    cache)``."""
    B = x.shape[0]
    positions = torch.full((B, 1), cache_index, dtype=torch.int32,
                           device=x.device)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    c_kv_t, k_rope_t = _kv_compress(p, x, cfg, positions)
    cache["c_kv"][:, cache_index] = c_kv_t[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, cache_index] = k_rope_t[:, 0].to(
        cache["k_rope"].dtype)
    # absorb W_uk into the query: q_c = q_nope . W_uk, the compressed space
    q_c = pdot("bshk,rhk->bshr", q_nope, p["w_uk"], cfg.policy)
    out = _mla_attend(p, q_c, q_rope, cache["c_kv"], cache["k_rope"], cfg,
                      cache_index)
    return out, cache


def _write_token(dst, page, off, new):
    """``dst[page, off] = new`` in place, for a pool leaf (NP, ps, r) that
    a mesh may split (``serving.engine._pool_spec`` puts the page-offset
    dim on ``model``): each rank writes the rows whose offset it holds,
    and sends the others to its slot (0, 0), the scrap page's, so that
    every shape stays static and the decode graph captures the write."""
    if not ctx.is_dtensor(dst):
        dst[page, off] = new.to(dst.dtype)
        return
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local = dst.to_local()
    shape, start = compute_local_shape_and_global_offset(
        dst.shape, dst.device_mesh, dst.placements)
    mine = ((page >= start[0]) & (page < start[0] + shape[0])
            & (off >= start[1]) & (off < start[1] + shape[1]))
    zero = torch.zeros_like(page)
    new = ctx.full(new)[:, start[2]:start[2] + shape[2]]
    local[torch.where(mine, page - start[0], zero),
          torch.where(mine, off - start[1], zero)] = new.to(dst.dtype)


def mla_decode_paged(p, x, cfg, pool, block_tables, lengths):
    """Absorbed decode against the paged latent cache (serving engine).

    pool: ``{"c_kv": (NP, ps, kvr), "k_rope": (NP, ps, dr)}`` shared by all
    slots; block_tables: (B, maxp) i32; lengths: (B,) i32 tokens already
    cached (the current token's position).  The token's entries are written
    into its page in place; the attend reads a gather of every slot's
    ``maxp`` pages, so each shape is static and the engine's decode graph
    captures the step.  Returns the output (B, 1, d_model)."""
    B = x.shape[0]
    positions = lengths[:, None].to(torch.int32)
    q_nope, q_rope = _q_proj(p, x, cfg, positions)
    c_kv_t, k_rope_t = _kv_compress(p, x, cfg, positions)
    ps = pool["c_kv"].shape[1]
    maxp = block_tables.shape[1]
    rows = torch.arange(B, device=x.device)
    page = block_tables[rows, (lengths // ps).long()].long()
    off = (lengths % ps).long()
    _write_token(pool["c_kv"], page, off, c_kv_t[:, 0])
    _write_token(pool["k_rope"], page, off, k_rope_t[:, 0])
    q_c = pdot("bshk,rhk->bshr", q_nope, p["w_uk"], cfg.policy)
    bt = block_tables.long()
    ckg = pool["c_kv"][bt].reshape(B, maxp * ps, pool["c_kv"].shape[-1])
    krg = pool["k_rope"][bt].reshape(B, maxp * ps, pool["k_rope"].shape[-1])
    return _mla_attend(p, q_c, q_rope, ckg, krg, cfg, lengths)
