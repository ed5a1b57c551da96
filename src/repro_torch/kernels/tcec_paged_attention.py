"""Kernel 3: TCEC paged decode attention.

Counterpart of ``repro/kernels/tcec_paged_attention.py::_paged_kernel``.
The CUDA kernel (``csrc/tcec_paged_attention.cu``) runs one block per
(slot, kv head), reads the slot's block-table row and gathers its bf16
pages by index, one page per online-softmax step.  The f32 query and
probabilities are split into bf16 terms, so the decode attend keeps the
precision a plain bf16 product would drop.  Masking is a select: stale,
possibly non-finite data in recycled pages never reaches a sum.  Rows with
``length <= 0`` return zeros.

:func:`tcec_paged_attention` is the public entry (launch on CUDA, plain
version on CPU); :func:`tcec_paged_attention_plain` is the same function in
plain PyTorch, page for page.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.policy import get_policy
from . import _build
from .tcec_attention import NEG_INF, _product, _terms
from .tcec_matmul import check_policy, fold

MAX_REP = 8
MAX_PAGE = 64
HDMAX = 128

launches = 0
# q, k_pages, v_pages, block_tables, lengths, out; B, Hkv, rep, hd, hdv, ps,
# maxp, window; softcap, sm_denom; n_splits, scale_bits; stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def _plain_core(qt, k_pages, v_pages, block_tables, lengths, pol, window,
                softcap, sm_denom):
    """The kernel's arithmetic: qt (B, Hkv, rep, hd) f32, pages (NP, ps, Hkv,
    hd[v]), block_tables (B, maxp), lengths (B,) incl. the current token."""
    B, Hkv, rep, hd = qt.shape
    ps, hdv = k_pages.shape[1], v_pages.shape[3]
    maxp = block_tables.shape[1]
    dev = qt.device
    sq = _terms(qt, pol)
    lengths = lengths.to(torch.int64)
    cur = lengths - 1
    single = maxp == 1
    m = torch.full((B, Hkv, rep, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, rep, 1), device=dev)
    accs = [torch.zeros((B, Hkv, rep, hdv), device=dev) for _ in pol.groups]
    for pg in range(maxp):
        col0 = pg * ps
        run = lengths > col0
        if window > 0:
            run = run & (cur - (col0 + ps - 1) < window)
        if not bool(run.any()):
            continue
        pos = col0 + torch.arange(ps, device=dev)
        ok = pos[None] <= cur[:, None]                         # (B, ps)
        if window > 0:
            ok = ok & (cur[:, None] - pos[None] < window)
        pages = block_tables[:, pg].to(torch.int64)
        sel = ok[:, :, None, None]
        # select, not bias: stale entries of a recycled page never enter
        kb = torch.where(sel, k_pages[pages].float(), 0.0)      # (B,ps,Hkv,hd)
        vb = torch.where(sel, v_pages[pages].float(), 0.0)
        sk = _terms(kb.permute(0, 2, 3, 1), pol)                # (B,Hkv,hd,ps)
        s = fold(_product(sq, sk, pol), pol.scale_bits) / sm_denom
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(ok[:, None, None, :], s, NEG_INF)       # (B,Hkv,rep,ps)
        if single:
            p = torch.exp(s - s.amax(-1, keepdim=True))
            p = p / p.sum(-1, keepdim=True)
            alpha, m_new, l_new = None, m, l
        else:
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l_new = alpha * l + p.sum(-1, keepdim=True)
        parts = _product(_terms(p, pol), _terms(vb.permute(0, 2, 1, 3), pol),
                         pol)
        r4 = run[:, None, None, None]
        for gi, part in enumerate(parts):
            new = accs[gi] + part if alpha is None else accs[gi] * alpha + part
            accs[gi] = torch.where(r4, new, accs[gi])
        m = torch.where(r4, m_new, m)
        l = torch.where(r4, l_new, l)
    out = fold(accs, pol.scale_bits)
    if not single:
        out = out / torch.clamp_min(l, 1e-30)
    return out


def _launch(qt, k_pages, v_pages, block_tables, lengths, pol, window,
            softcap, sm_denom):
    global launches
    B, Hkv, rep, hd = qt.shape
    NP, ps, Hkv2, hd2 = k_pages.shape
    hdv = v_pages.shape[3]
    maxp = block_tables.shape[1]
    if (rep > MAX_REP or ps > MAX_PAGE or hd > HDMAX or hdv > HDMAX
            or Hkv2 != Hkv or hd2 != hd or v_pages.shape[:3] != (NP, ps, Hkv)):
        raise ValueError(f"CUDA paged attention takes rep <= {MAX_REP}, page "
                         f"size <= {MAX_PAGE}, head dims <= {HDMAX}; got "
                         f"q {tuple(qt.shape)}, pages {tuple(k_pages.shape)}")
    if k_pages.dtype != torch.bfloat16 or v_pages.dtype != torch.bfloat16:
        raise TypeError("CUDA paged attention takes bf16 page pools")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if block_tables.shape[0] != B or lengths.shape != (B,):
        raise ValueError("block_tables / lengths do not match the slots")
    for t in (qt, k_pages, v_pages, block_tables, lengths):
        if t.device != qt.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous on one CUDA device")
    out = torch.empty((B, Hkv, rep, hdv), dtype=torch.float32,
                      device=qt.device)
    if out.numel() == 0:
        return out
    fn = _build.entry("tcec_paged_attention", _ARGTYPES)
    status = fn(_build.ptr(qt), _build.ptr(k_pages), _build.ptr(v_pages),
                _build.ptr(block_tables), _build.ptr(lengths),
                _build.ptr(out), B, Hkv, rep, hd, hdv, ps, maxp, int(window),
                float(softcap or 0.0), float(sm_denom), pol.n_splits,
                pol.scale_bits, _build.stream(qt))
    _build.check("tcec_paged_attention", status)
    launches += 1
    return out


def _run(core, q, k_pages, v_pages, block_tables, lengths, policy, window,
         softcap):
    pol = get_policy(policy)
    check_policy(pol)
    B, H, hd = q.shape
    Hkv = k_pages.shape[2]
    if Hkv == 0 or H % Hkv or k_pages.shape[3] != hd:
        raise ValueError(f"bad paged shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    qt = q.float().reshape(B, Hkv, H // Hkv, hd).contiguous()
    window = int(0 if window is None else window)
    softcap = float(softcap) if softcap else None
    out = core(qt, k_pages, v_pages, block_tables, lengths, pol, window,
               softcap, float(math.sqrt(hd)))
    return out.reshape(B, H, v_pages.shape[3])


def tcec_paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                         policy: str = "tcec_bf16x6", window=0,
                         softcap: float | None = None):
    """Fused paged decode attention on model-layout operands.

    q: (B, H, hd) — one query token per slot; k_pages/v_pages: (NP, ps,
    Hkv, hd[v]) bf16 page pools; block_tables: (B, maxp) i32; lengths: (B,)
    i32 valid tokens including the current one (whose K/V is already in its
    page).  Returns (B, H, hdv) f32.  A CUDA tensor launches the kernel; a
    CPU tensor runs the plain version.
    """
    if q.is_cuda:
        core = _launch
    elif q.device.type == "cpu":
        core = _plain_core
    else:
        raise ValueError(f"no TCEC paged attention for device {q.device}")
    return _run(core, q, k_pages, v_pages, block_tables, lengths, policy,
                window, softcap)


def tcec_paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                               policy: str = "tcec_bf16x6", window=0,
                               softcap: float | None = None):
    """Kernel 3's function in plain PyTorch, on any device."""
    return _run(_plain_core, q, k_pages, v_pages, block_tables, lengths,
                policy, window, softcap)
