"""Mamba-2 SSD (state-space duality) layer: the chunked matmul formulation.

Counterpart of the JAX package's ``models/ssd.py`` (Dao & Gu,
arXiv:2405.21060).  The selective-SSM recurrence is recast as chunk-local
products plus a small inter-chunk state scan.  Each chunk runs four
products through ``pdot`` under ``cfg.mix_policy`` (kernel 1 on the card,
batched over batch, group and head), and the projections run under
``cfg.policy``.

The chunk loop is a Python loop (JAX: ``lax.scan``), so one (B, G, rep,
Q, Q) gate block is live at a time, and every head-group expansion is a
reshape H = G x rep, never a materialized repeat.  The input projection
is five separate weights (z, x, B, C, dt), as in the JAX tree.

``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` is:
``F.softplus`` turns linear above its threshold of 20.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import pdot
from repro_torch.parallel import ctx
from .layers import rmsnorm
from .modules import dense_init, zeros


def ssd_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim


def ssd_init(gen, cfg, device=None):
    D = cfg.d_model
    d_inner, H = ssd_dims(cfg)
    GN = cfg.ssm_groups * cfg.ssm_state
    K = cfg.ssm_conv

    def dense(shape, fan_in):
        return dense_init(gen, shape, fan_in=fan_in, device=device)

    return {
        "wz": dense((D, d_inner), D),
        "wx": dense((D, d_inner), D),
        "wb": dense((D, GN), D),
        "wc": dense((D, GN), D),
        "wdt": dense((D, H), D),
        "conv_x": dense((K, d_inner), K),
        "conv_b": dense((K, GN), K),
        "conv_c": dense((K, GN), K),
        "conv_bias_x": zeros((d_inner,), device),
        "conv_bias_b": zeros((GN,), device),
        "conv_bias_c": zeros((GN,), device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D_skip": torch.ones(H, device=device),
        # softplus^-1 of 1e-2
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 1e-2,
                                                    device=device))),
        "norm": zeros((d_inner,), device),
        "w_out": dense((d_inner, D), d_inner),
    }


def _softplus(x):
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x, w, b):
    """Depthwise causal conv, width K: y_t = sum_k x_{t-K+1+k} * w_k; under
    a mesh on each rank's channel and batch shards
    (``parallel.ctx.per_channel``)."""
    return ctx.per_channel(_causal_conv_local, x, w, b)


def _causal_conv_local(x, w, b):
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, k:k + S] * w[k] for k in range(K))
    return F.silu(y + b)


def _project(p, x, cfg):
    return tuple(pdot("bsd,de->bse", x, p[w], cfg.policy)
                 for w in ("wz", "wx", "wb", "wc", "wdt"))


def ssd_layer(p, x, cfg):
    """Train/prefill path. x: (B, S, D) -> (B, S, D); S must be a multiple
    of the chunk ``min(cfg.ssm_chunk, S)``."""
    B, S, _ = x.shape
    d_inner, H = ssd_dims(cfg)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    rep = H // G
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {Q}")
    nc = S // Q
    pol = cfg.mix_policy

    z, xs, Bm, Cm, dt = _project(p, x, cfg)
    xs = _causal_conv(xs, p["conv_x"], p["conv_bias_x"])
    Bm = _causal_conv(Bm, p["conv_b"], p["conv_bias_b"])
    Cm = _causal_conv(Cm, p["conv_c"], p["conv_bias_c"])

    A = -torch.exp(p["A_log"].float())                          # (H,) < 0
    dts = _softplus(dt.float() + p["dt_bias"])                  # (B, S, H)
    xbar = ctx.reshape(xs, (B, S, H, P)) * dts[..., None]
    cum = ctx.along(lambda t: torch.cumsum(t, dim=2),
                    ctx.reshape(dts * A, (B, nc, Q, G, rep)), 2)

    Bc = ctx.reshape(Bm, (B, nc, Q, G, N))
    Cc = ctx.reshape(Cm, (B, nc, Q, G, N))
    Xc = ctx.reshape(xbar, (B, nc, Q, G, rep, P))
    tri = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()

    state = x.new_zeros((B, G, rep, N, P), dtype=torch.float32)
    ys = []
    for c in range(nc):
        bc, cc, xb, lc = Bc[:, c], Cc[:, c], Xc[:, c], cum[:, c]
        # intra-chunk: per-group scores, per-head decay gates
        sg = pdot("bign,bjgn->bgij", cc, bc, pol)               # (B,G,Q,Q)
        dgate = lc.permute(0, 2, 3, 1)                          # (B,G,r,Q)
        decay = torch.exp(torch.clamp(
            dgate[..., :, None] - dgate[..., None, :], -60.0, 0.0))
        gate = torch.where(tri, decay, 0.0)                     # (B,G,r,Q,Q)
        y_intra = pdot("bgrij,bjgrp->bigrp", sg[:, :, None] * gate, xb, pol)
        # inter-chunk: contribution of the carried state
        y_inter = pdot("bqgn,bgrnp->bqgrp", cc, state, pol) \
            * torch.exp(lc)[..., None]
        # new state: decayed old + sum_j B_j (x) (xbar_j * tail_j)
        tail = torch.exp(lc[:, -1:] - lc)                       # (B,Q,G,r)
        cstate = pdot("bqgn,bqgrp->bgrnp", bc, xb * tail[..., None], pol)
        state = state * torch.exp(lc[:, -1])[..., None, None] + cstate
        ys.append(y_intra + y_inter)
    y = ctx.reshape(torch.stack(ys, 1), (B, S, H, P))
    y = y + ctx.reshape(xs, (B, S, H, P)) * p["D_skip"][None, None, :, None]
    y = ctx.reshape(y, (B, S, d_inner)) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return pdot("bse,ed->bsd", y, p["w_out"], cfg.policy)


def ssd_init_cache(cfg, batch: int, device=None):
    """One layer's decode cache: the conv windows and the SSM state, f32."""
    d_inner, H = ssd_dims(cfg)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    K = cfg.ssm_conv - 1
    shapes = {"conv_x": (batch, K, d_inner), "conv_b": (batch, K, G * N),
              "conv_c": (batch, K, G * N), "state": (batch, G, H // G, N, P)}
    return {k: torch.zeros(s, dtype=torch.float32, device=device)
            for k, s in shapes.items()}


def _conv_step(cache, xt, w, b):
    """One causal-conv step against a rolling window cache. xt: (B, 1, C)."""
    window = torch.cat([cache, xt], dim=1)                      # (B, K, C)
    out = (window * w[None]).sum(dim=1) + b
    return F.silu(out)[:, None, :], window[:, 1:]


def ssd_decode(p, x, cfg, cache):
    """Single-token recurrent step. x: (B, 1, D) -> ``(out (B, 1, D), new
    cache)``; the cache given is not written.  The state product is a
    plain f32 ``einsum``, as in JAX (TF32 stays off)."""
    B = x.shape[0]
    d_inner, H = ssd_dims(cfg)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    rep = H // G

    z, xs, Bm, Cm, dt = _project(p, x, cfg)
    xs, ncx = _conv_step(cache["conv_x"], xs, p["conv_x"], p["conv_bias_x"])
    Bm, ncb = _conv_step(cache["conv_b"], Bm, p["conv_b"], p["conv_bias_b"])
    Cm, ncc = _conv_step(cache["conv_c"], Cm, p["conv_c"], p["conv_bias_c"])

    A = -torch.exp(p["A_log"].float())
    dts = _softplus(dt[:, 0].float() + p["dt_bias"])            # (B, H)
    dA = ctx.reshape(torch.exp(dts * A), (B, G, rep))
    xh = ctx.reshape(xs[:, 0], (B, G, rep, P)) \
        * ctx.reshape(dts, (B, G, rep))[..., None]
    Bh = ctx.reshape(Bm[:, 0], (B, G, N))
    Ch = ctx.reshape(Cm[:, 0], (B, G, N))
    state = cache["state"] * dA[..., None, None] + \
        Bh[:, :, None, :, None] * xh[:, :, :, None, :]
    y = torch.einsum("bgn,bgrnp->bgrp", Ch, state)
    y = y + ctx.reshape(xs[:, 0], (B, G, rep, P)) \
        * ctx.reshape(p["D_skip"], (G, rep))[None, :, :, None]
    y = ctx.reshape(y, (B, 1, d_inner)) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    out = pdot("bse,ed->bsd", y, p["w_out"], cfg.policy)
    return out, {"conv_x": ncx, "conv_b": ncb, "conv_c": ncc, "state": state}


def ssd_reference(p, x, cfg):
    """Naive sequential recurrence: the oracle for the chunked path."""
    cache = ssd_init_cache(cfg, x.shape[0], x.device)
    outs = []
    for t in range(x.shape[1]):
        o, cache = ssd_decode(p, x[:, t:t + 1], cfg, cache)
        outs.append(o)
    return torch.cat(outs, dim=1)
