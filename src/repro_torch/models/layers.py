"""Shared neural layers of the model families.  Every contraction
routes through ``repro_torch.core.pdot``, so the paper's error-corrected
GEMM is a config knob for the whole model; attention routes to kernel 2
(prefill) and kernel 3 (paged decode) through ``kernels.dispatch``.  Kernel
2 has no backward of its own: under autograd :func:`sdpa` wraps it in
:class:`_FusedSDPA`, whose backward recomputes the pdot composition
(:func:`blocked_attention` from 8192 positions, :func:`mha` below) and
differentiates that (JAX's ``_fused_sdpa``).

Layouts follow the JAX package: activations (B, S, H, hd), projection
weights (D, H, hd) and (H, hd, D).  Two details that are easy to get
wrong: RMSNorm scales by ``1 + scale`` (the scale parameters start at
zero), and RoPE rotates the two *halves* of head_dim, not interleaved
pairs.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.nn.functional as F

from repro_torch import numerics
from repro_torch.core import get_policy, pdot
from repro_torch.kernels import dispatch
from repro_torch.kernels.tcec_matmul import EPILOGUE_ACTIVATIONS
from repro_torch.parallel import ctx
from .modules import dense_init, zeros

NEG_INF = -2.0e38


# ------------------------------------------------------------------ norms

def rmsnorm(scale, x, eps=1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())


# ------------------------------------------------------------------- rope

def rope(x, positions, theta: float):
    """Rotary embedding on the two halves of head_dim.
    x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq               # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


# ------------------------------------------------------------- attention

def attn_init(gen, cfg, device=None):
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (D, H, hd), fan_in=D, device=device),
        "wk": dense_init(gen, (D, Hkv, hd), fan_in=D, device=device),
        "wv": dense_init(gen, (D, Hkv, hd), fan_in=D, device=device),
        "wo": dense_init(gen, (H, hd, D), fan_in=H * hd, device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((H, hd), device)
        p["bk"] = zeros((Hkv, hd), device)
        p["bv"] = zeros((Hkv, hd), device)
    if cfg.qk_norm:
        p["q_norm"] = zeros((hd,), device)
        p["k_norm"] = zeros((hd,), device)
    return p


def _project_qkv(p, x, cfg, positions):
    pol = cfg.policy
    q = pdot("bsd,dhk->bshk", x, p["wq"], pol)
    k = pdot("bsd,dhk->bshk", x, p["wk"], pol)
    v = pdot("bsd,dhk->bshk", x, p["wv"], pol)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask_bias(q_pos, k_pos, causal: bool, window: int):
    """Additive mask from position vectors (window 0 = unlimited)."""
    d = q_pos[:, None] - k_pos[None, :]
    ok = (d >= 0) if causal else torch.ones_like(d, dtype=torch.bool)
    if window > 0:
        ok = ok & (d < window)
    return torch.where(ok, 0.0, NEG_INF).float()


def mha(q, k, v, cfg, q_pos, k_pos, causal=True, window=0):
    """Materialized-scores attention through pdot — the composition path
    for policies the fused kernel does not take.  GQA by head grouping.
    Under a mesh the q sequence and the scores' query rows shard on
    ``model`` (context parallelism; JAX ``layers.py`` :101-116)."""
    B, S, H, hd = q.shape
    Hkv, hdv = k.shape[2], v.shape[3]
    qg = ctx.reshape(q, (B, S, Hkv, H // Hkv, hd))
    qg = ctx.constrain(qg, ctx.dp_axes(), "model", None, None, None)
    scores = pdot("bqhrd,bkhd->bhrqk", qg, k, cfg.mix_policy)
    scores = ctx.constrain(scores, ctx.dp_axes(), None, None, "model", None)
    scores = softcap(scores / math.sqrt(hd), cfg.attn_softcap)
    scores = scores + _mask_bias(q_pos[0], k_pos[0], causal, window)
    probs = torch.softmax(scores.float(), dim=-1)
    out = pdot("bhrqk,bkhd->bqhrd", probs, v, cfg.mix_policy)
    out = ctx.constrain(out, ctx.dp_axes(), None, None, "model", None)
    return ctx.reshape(out, (B, S, H, hdv))


def blocked_attention(q, k, v, cfg, q_pos, k_pos, causal=True, window=0,
                      q_chunk=2048, k_chunk=2048):
    """Flash-style attention through pdot: O(S chunk) memory, an online
    softmax over KV chunks (JAX's ``blocked_attention``, chunk for chunk).

    A KV chunk whose every position lies strictly in the causal future of
    the whole q chunk (``min(k_pos) > max(q_pos)``) carries only masked
    scores, so it is skipped.  The rule reads the positions, so it is right
    for any nondecreasing positions; the chunks' minima and maxima come to
    the host together, one transfer a call, not one a chunk.  ``meta``
    positions (the dry run's trace) cannot be read: every chunk pair is
    then taken, as JAX's traced loop takes them.  Under a mesh each q
    chunk and its scores shard as in :func:`mha` (JAX :146-158)."""
    B, S, H, hd = q.shape
    T, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    rep = H // Hkv
    nq, nk = S // q_chunk, T // k_chunk
    if S % q_chunk or T % k_chunk:
        raise ValueError(f"blocked attention needs S {S} and T {T} to be "
                         f"multiples of the chunks {q_chunk}, {k_chunk}")
    qg = ctx.reshape(q, (B, nq, q_chunk, Hkv, rep, hd))
    kg = ctx.reshape(k, (B, nk, k_chunk, Hkv, hd))
    vg = ctx.reshape(v, (B, nk, k_chunk, Hkv, hdv))
    qp = q_pos[0].reshape(nq, q_chunk)
    kp = k_pos[0].reshape(nk, k_chunk)
    live = [[True] * nk for _ in range(nq)]
    if causal and qp.device.type != "meta":
        live = (kp.amin(1)[None, :] <= qp.amax(1)[:, None]).tolist()
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi]                             # (B, qc, Hkv, rep, hd)
        qblk = ctx.constrain(qblk, ctx.dp_axes(), "model", None, None, None)
        m = torch.full((B, Hkv, rep, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, Hkv, rep, q_chunk), device=q.device)
        acc = torch.zeros((B, Hkv, rep, q_chunk, hdv), device=q.device)
        for ki in range(nk):
            if not live[qi][ki]:
                continue
            s = pdot("bqhrd,bkhd->bhrqk", qblk, kg[:, ki],
                     cfg.mix_policy) * scale
            s = ctx.constrain(s, ctx.dp_axes(), None, None, "model", None)
            s = softcap(s, cfg.attn_softcap)
            s = s + _mask_bias(qp[qi], kp[ki], causal, window)
            m_new = torch.maximum(m, s.max(dim=-1).values)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = pdot("bhrqk,bkhd->bhrqd", p, vg[:, ki], cfg.mix_policy)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,Hkv,rep,qc,hdv)
        outs.append(out.permute(0, 3, 1, 2, 4))           # (B,qc,Hkv,rep,hdv)
    return ctx.reshape(torch.stack(outs, 1), (B, S, H, hdv))


ATTN_BLOCK_THRESHOLD = 8192


def _sdpa_composition(q, k, v, cfg, q_pos, k_pos, causal, window):
    """The pdot composition: :func:`blocked_attention` for long sequences
    whose S and T divide into its chunks, :func:`mha` else."""
    if (q.shape[1] >= ATTN_BLOCK_THRESHOLD
            and q.shape[1] % 2048 == 0 and k.shape[1] % 2048 == 0):
        return blocked_attention(q, k, v, cfg, q_pos, k_pos, causal, window)
    return mha(q, k, v, cfg, q_pos, k_pos, causal, window)


class _FusedSDPA(torch.autograd.Function):
    """Kernel 2 forward; the backward recomputes attention through the pdot
    composition :func:`_sdpa_composition` on the saved q, k, v and
    differentiates it.  The composition's pdots carry
    ``core.policy._PolicyDot``, so the gradient GEMMs run kernel 1 under the
    same policy, under the forward's numerics config."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, policy, softcap, causal, window):
        ctx.save_for_backward(q, k, v, q_pos, k_pos)
        ctx.cfg = SimpleNamespace(mix_policy=policy, attn_softcap=softcap)
        ctx.causal, ctx.window = causal, window
        ctx.numerics = numerics.active()
        return dispatch.attention(q, k, v, policy=policy, q_pos=q_pos,
                                  k_pos=k_pos, causal=causal, window=window,
                                  softcap=softcap)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, q_pos, k_pos = ctx.saved_tensors
        with torch.enable_grad(), numerics.use(ctx.numerics):
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = _sdpa_composition(*qkv, ctx.cfg, q_pos, k_pos, ctx.causal,
                                    ctx.window)
            dq, dk, dv = torch.autograd.grad(out, qkv, g.float())
        return dq, dk, dv, None, None, None, None, None, None


def sdpa(q, k, v, cfg, q_pos, k_pos, causal=True, window=0):
    """Scaled-dot-product attention router: kernel 2 where the numerics
    config allows (through :class:`_FusedSDPA` when autograd needs a
    gradient), the pdot composition otherwise."""
    if (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        if dispatch.attention_eligible(q, k, v, policy=cfg.mix_policy):
            return _FusedSDPA.apply(q, k, v, q_pos, k_pos, cfg.mix_policy,
                                    cfg.attn_softcap, causal, window)
        out = None
    else:
        out = dispatch.attention(q, k, v, policy=cfg.mix_policy, q_pos=q_pos,
                                 k_pos=k_pos, causal=causal, window=window,
                                 softcap=cfg.attn_softcap)
    if out is not None:
        return out
    return _sdpa_composition(q, k, v, cfg, q_pos, k_pos, causal, window)


def attention_prefill(p, x, cfg, positions, window=0, causal=True):
    """Full attention layer that also returns the K/V it computed, so a
    sequence-level prefill fills the cache in one forward."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = sdpa(q, k, v, cfg, positions, positions, causal, window)
    out = pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy)
    return out, {"k": k, "v": v}


def attention_chunk(p, x, cfg, cache, start: int, window=0):
    """One prefill chunk against a dense scratch cache (chunked prefill).

    x: (B, C, d_model), the chunk's tokens at positions ``start .. start +
    C``; cache: ``{"k", "v"}`` leaves (B, T, Hkv, d) holding every earlier
    chunk's K/V (and, after a prefix-cache hit, the shared pages').  The
    chunk's K/V is written in at ``start`` (in place), then the chunk
    attends over all of ``[0, T)`` through :func:`sdpa` (kernel 2 with S =
    C and the real positions): the causal mask hides the positions from
    ``start + C`` on, so with an f32 scratch each row is the monolithic
    prefill's row.  Returns ``(out, cache)``."""
    B, C = x.shape[:2]
    positions = (start + torch.arange(C, dtype=torch.int32, device=x.device)
                 )[None].expand(B, C)
    q, k, v = _project_qkv(p, x, cfg, positions)
    # the per-request scratch is whole on every rank under a mesh
    cache["k"][:, start:start + C] = ctx.full(k).to(cache["k"].dtype)
    cache["v"][:, start:start + C] = ctx.full(v).to(cache["v"].dtype)
    T = cache["k"].shape[1]
    k_pos = torch.arange(T, dtype=torch.int32, device=x.device)[None].expand(
        B, T)
    o = sdpa(q, cache["k"], cache["v"], cfg, positions, k_pos, True, window)
    return pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy), cache


def attention(p, x, cfg, positions, causal=True, window=0):
    """Full attention layer: qkv -> sdpa (kernel 2 on the card) -> out
    projection."""
    return attention_prefill(p, x, cfg, positions, window, causal)[0]


def _decode_attend(q, ck, cv, cfg, cur_pos, window=0):
    """One-token attention over a dense cache view in plain bf16: the dense
    cache's decode, and the paged decode for policies kernel 3 does not
    take (over the gathered pages).
    q: (B, 1, H, hd); ck/cv: (B, T, Hkv, d); cur_pos: (B,)."""
    B, T, Hkv = ck.shape[0], ck.shape[1], ck.shape[2]
    H, hd = q.shape[2], q.shape[3]
    qg = ctx.reshape(q, (B, 1, Hkv, H // Hkv, hd))
    s = pdot("bqhrd,bkhd->bhrqk", qg, ck, "bf16")
    s = softcap(s / math.sqrt(hd), cfg.attn_softcap)
    d = cur_pos.reshape(-1, 1).long() - torch.arange(T, device=q.device)[None]
    ok = d >= 0
    if window > 0:
        ok = ok & (d < window)
    s = torch.where(ok[:, None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s.float(), dim=-1)
    o = pdot("bhrqk,bkhd->bqhrd", pr, cv, "bf16")
    return ctx.reshape(o, (B, 1, H, cv.shape[3]))


def attention_decode(p, x, cfg, cache, cache_index: int, window=0):
    """One-token decode against a dense (B, T, Hkv, hd) KV cache
    (``launch.serve.generate_dense``).

    x: (B, 1, d_model), every row at position ``cache_index``.  The token's
    K/V is written into ``cache`` in place (JAX returns an updated copy) and
    the step attends over the whole cache in plain bf16, as JAX does; this
    is not kernel 3, which takes a paged cache.  Returns ``(out, cache)``.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), cache_index, dtype=torch.int32,
                           device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache["k"][:, cache_index] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, cache_index] = v[:, 0].to(cache["v"].dtype)
    o = _decode_attend(q, cache["k"], cache["v"], cfg, positions[:, 0],
                       window)
    return pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy), cache


def attention_decode_paged(p, x, cfg, pool, block_tables, lengths, window=0):
    """One-token decode against a paged KV cache (serving engine).

    x: (B, 1, d_model), one token per slot; pool: ``{"k": (NP, ps, Hkv, hd),
    "v": (NP, ps, Hkv, hdv)}`` shared by all slots; block_tables: (B, maxp)
    i32; lengths: (B,) i32 tokens already cached per slot.  The new token's
    K/V is written into its page in place (the pool is the dominant serving
    allocation; JAX rebinds a donated buffer, PyTorch updates it), then
    kernel 3 attends over the pages.
    """
    B = x.shape[0]
    positions = lengths[:, None].to(torch.int32)
    q, k, v = _project_qkv(p, x, cfg, positions)
    ps = pool["k"].shape[1]
    rows = torch.arange(B, device=x.device)
    page = block_tables[rows, (lengths // ps).long()].long()
    off = (lengths % ps).long()
    for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
        dst = pool[name]
        local = dst.to_local() if ctx.is_dtensor(dst) else dst
        local[page, off] = ctx.local_like(new, dst).to(dst.dtype)
    o = dispatch.attention_decode(q[:, 0], pool["k"], pool["v"], block_tables,
                                  lengths + 1, policy=cfg.mix_policy,
                                  window=window, softcap=cfg.attn_softcap)
    if o is not None:
        o = o[:, None].float()                              # (B, 1, H, hdv)
    else:
        Hkv, hd = pool["k"].shape[2], pool["k"].shape[3]
        maxp = block_tables.shape[1]
        bt = block_tables.long()
        kg = ctx.reshape(pool["k"][bt], (B, maxp * ps, Hkv, hd))
        vg = ctx.reshape(pool["v"][bt], (B, maxp * ps, Hkv,
                                         pool["v"].shape[3]))
        o = _decode_attend(q, kg, vg, cfg, lengths, window)
    return pdot("bshk,hkd->bsd", o, p["wo"], cfg.policy)


# ------------------------------------------------------------------- MLP

def mlp_init(gen, cfg, d_ff=None, device=None):
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (D, F_), fan_in=D, device=device),
        "w_up": dense_init(gen, (D, F_), fan_in=D, device=device),
        "w_down": dense_init(gen, (F_, D), fan_in=F_, device=device),
    }


def _act(x, kind: str):
    # jax.nn.gelu is the tanh approximation by default
    return F.gelu(x, approximate="tanh") if kind == "gelu" else F.silu(x)


# ------------------------------------------------- fused linear epilogue
#
# Under the numerics config's ``fuse_epilogue``, act(x @ W + b) is one
# kernel 1 launch: the bias add and the activation are its epilogue, so the
# pre-activation never reaches device memory.  The backward recomputes the
# pre-activation under the same policy and routes dx and dW through pdot,
# as the JAX package's ``_fused_linear_bwd`` does.

def _epilogue_act(z, activation):
    """The activations kernel 1's epilogue takes, from its own table (the
    fused and unfused paths share it; ``_act``'s anything-but-gelu-is-silu
    default would not be safe here)."""
    return EPILOGUE_ACTIVATIONS[activation](z)


def _linear_unfused(x, w, b, activation, policy):
    z = pdot("bsd,df->bsf", x, w, policy)
    if b is not None:
        z = z + b
    return _epilogue_act(z, activation)


def _fused_linear_fwd(x, w, b, activation, policy, cfg):
    pol = get_policy(policy)
    B, S, D = x.shape
    F_ = w.shape[-1]
    if (dispatch.epilogue_eligible(pol, cfg, x.device)
            and min(B * S, D, F_) >= cfg.min_dim):
        out = dispatch.fused_matmul(x.reshape(B * S, D), w, pol, b,
                                    activation, cfg)
        return out.reshape(B, S, F_)
    return _linear_unfused(x, w, b, activation, policy)


class _FusedLinear(torch.autograd.Function):
    """:func:`fused_linear` with the JAX package's backward: the
    pre-activation recomputed under the same policy, the activation's
    derivative taken there, dx and dW through pdot; all under the forward's
    numerics config."""

    @staticmethod
    def forward(ctx, x, w, b, activation, policy):
        ctx.numerics = numerics.active()
        ctx.save_for_backward(x, w, b)
        ctx.activation, ctx.policy = activation, policy
        return _fused_linear_fwd(x, w, b, activation, policy, ctx.numerics)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        policy = ctx.policy
        with numerics.use(ctx.numerics):
            dz = dy
            if ctx.activation:
                z = _linear_unfused(x, w, b, None, policy).detach()
                with torch.enable_grad():
                    z.requires_grad_()
                    dz, = torch.autograd.grad(
                        _epilogue_act(z, ctx.activation), z, dy)
            dx = pdot("bsf,df->bsd", dz, w, policy).to(x.dtype)
            dw = pdot("bsd,bsf->df", x, dz, policy).to(w.dtype)
        db = dz.sum(dim=(0, 1)).to(b.dtype) if b is not None else None
        return dx, dw, db, None, None


def fused_linear(x, w, b, activation, policy):
    """act(x @ w + b) with the bias and activation in kernel 1's epilogue
    when the numerics config allows it (``fuse_epilogue``, a kernel policy,
    ``min(B S, D, F) >= min_dim``); the pdot path otherwise.

    x: (B, S, D); w: (D, F); b: (F,) or None; activation: a key of
    ``tcec_matmul.EPILOGUE_ACTIVATIONS``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return _FusedLinear.apply(x, w, b, activation, policy)
    return _fused_linear_fwd(x, w, b, activation, policy, numerics.active())


def mlp(p, x, cfg):
    """The gated MLP.  Under ``fuse_epilogue`` the gate's activation runs
    in kernel 1's epilogue and the up projection is fused without one."""
    if numerics.active().fuse_epilogue:
        g = fused_linear(x, p["w_gate"], None, cfg.activation, cfg.policy)
        u = fused_linear(x, p["w_up"], None, None, cfg.policy)
        return pdot("bsf,fd->bsd", g * u, p["w_down"], cfg.policy)
    g = pdot("bsd,df->bsf", x, p["w_gate"], cfg.policy)
    u = pdot("bsd,df->bsf", x, p["w_up"], cfg.policy)
    h = _act(g, cfg.activation) * u
    return pdot("bsf,fd->bsd", h, p["w_down"], cfg.policy)


# ------------------------------------------------------------------- MoE

def moe_init(gen, cfg, device=None):
    D, E, F_ = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, (D, E), fan_in=D, device=device),
        "w_gate": dense_init(gen, (E, D, F_), fan_in=D, device=device),
        "w_up": dense_init(gen, (E, D, F_), fan_in=D, device=device),
        "w_down": dense_init(gen, (E, F_, D), fan_in=F_, device=device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, cfg,
                               d_ff=cfg.moe_d_ff * cfg.n_shared_experts,
                               device=device)
    return p


def group_size(n_tokens: int, cfg) -> int:
    """The routing group: the largest divisor of ``n_tokens`` that is at
    most ``cfg.moe_groups``."""
    gs = min(cfg.moe_groups, n_tokens)
    while n_tokens % gs:
        gs -= 1
    return gs


def capacity(gs: int, cfg) -> int:
    """Slots an expert has in a group of ``gs`` tokens (a multiple of 4)."""
    return int(math.ceil(gs * cfg.moe_top_k / cfg.n_experts
                         * cfg.capacity_factor / 4) * 4)


def moe_route(p, xg, cfg):
    """GShard top-k routing with capacity over token groups ``xg`` (G, gs,
    D).  Returns a dict: ``gates`` (G, gs, E) f32, ``topv`` (renormalised)
    and ``topi`` (G, gs, K), ``onehot`` (G, gs, K, E) f32, ``pos`` (G, gs,
    K): each route's position within its expert, counted over the (s, k)
    slot order, ``keep`` (G, gs, K) bf16 (0 past capacity) and the
    capacity ``C``.

    Every shape is static and nothing reads the device (the decode graph
    captures this).  The top-k is a stable descending sort, so ties keep
    the lower expert first, as ``jax.lax.top_k`` does.  The running count
    is an f32 ``cumsum`` of ones, exact at these sizes (JAX: an
    ``associative_scan``)."""
    G, gs, _ = xg.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    logits = pdot("gsd,de->gse", xg, p["router"], "fp32")
    gates = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]
    topv = topv / topv.sum(dim=-1, keepdim=True)
    C = capacity(gs, cfg)
    experts = torch.arange(E, device=xg.device)
    onehot = (topi[..., None] == experts).float()          # (G, gs, K, E)
    flat = ctx.reshape(onehot, (G, gs * K, E))
    pos = torch.cumsum(flat, dim=1)
    pos = ctx.reshape(((pos - 1.0) * flat).sum(-1), (G, gs, K))
    return {"gates": gates, "topv": topv, "topi": topi, "onehot": onehot,
            "pos": pos, "keep": (pos < C).to(torch.bfloat16), "C": C}


def moe(p, x, cfg):
    """GShard-style top-k MoE with capacity and one-hot dispatch products
    (the JAX package's formulation, shape for shape).  Returns ``(y,
    aux)``: the output (B, S, D) and the GShard load-balancing term.

    Tokens are routed in groups (:func:`group_size`); a route past its
    expert's capacity is dropped.  Dispatch and combine are (G, gs, E, C)
    bf16 tensors built by a loop over the K routes; the dispatch and
    combine products run the ``bf16`` policy, the expert products
    ``gecd,edf->gecf`` and ``gecf,efd->gecd`` ``cfg.policy`` (kernel 1 as
    a batch of E products).  Every expert computes all of its C slots of
    every group, used or not."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    N = B * S
    gs = group_size(N, cfg)
    G = N // gs
    xg = ctx.reshape(x, (G, gs, D))
    r = moe_route(p, xg, cfg)
    C = r["C"]
    posc = r["pos"].clamp(0, C - 1).long()
    oh_c = (posc[..., None] == torch.arange(C, device=x.device)).to(
        torch.bfloat16)                                     # (G, gs, K, C)
    oh_e = r["onehot"].to(torch.bfloat16)
    keep, topv = r["keep"], r["topv"].to(torch.bfloat16)
    # K-unrolled outer products: only (G, gs, E, C) accumulators live
    disp = torch.zeros((G, gs, E, C), dtype=torch.bfloat16, device=x.device)
    combine = torch.zeros_like(disp)
    for k in range(K):
        t = (oh_e[:, :, k, :, None] * oh_c[:, :, k, None, :]
             * keep[:, :, k, None, None])
        disp = disp + t
        combine = combine + t * topv[:, :, k, None, None]

    xe = pdot("gsec,gsd->gecd", disp, xg.to(torch.bfloat16), "bf16")
    hg = pdot("gecd,edf->gecf", xe, p["w_gate"], cfg.policy)
    hu = pdot("gecd,edf->gecf", xe, p["w_up"], cfg.policy)
    he = _act(hg, cfg.activation) * hu
    ye = pdot("gecf,efd->gecd", he, p["w_down"], cfg.policy)
    y = pdot("gsec,gecd->gsd", combine, ye.to(torch.bfloat16), "bf16")
    y = ctx.reshape(y, (B, S, D))

    if cfg.n_shared_experts:
        y = y + mlp(p["shared"], x, cfg)
    # load-balancing auxiliary (GShard aux loss), returned for training
    me = r["gates"].mean(dim=(0, 1))
    ce = r["onehot"].sum(2).mean(dim=(0, 1))
    return y, (me * ce).sum() * E
