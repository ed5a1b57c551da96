"""Kernel 3: TCEC paged decode attention.

Counterpart of ``repro/kernels/tcec_paged_attention.py::_paged_kernel``.
The CUDA kernel (``csrc/tcec_paged_attention.cu``) splits each slot's
block table into chunks of ``C`` pages (:func:`chunk_pages`) and runs one
block per (chunk, kv head, slot): the block gathers its chunk's pages by
index and computes the chunk's softmax partial (row max ``m``, sum ``l``
and one accumulator per scale group).  A second pass combines the
partials of each (slot, kv head) in chunk order; with one chunk the first
pass writes the output itself.  The f32 query and probabilities are split
into bf16 terms, so the decode attend keeps the precision a plain bf16
product would drop.  The pools are bf16 or f32 (the prefix cache's
bitwise contract runs on f32 pools), one instantiation each: f32 pages are
split into bf16 terms like the query as they land, and every kept term
product is formed (with bf16 pages only the (i, 0) ones are non-zero).
Masking is a select: stale, possibly non-finite data in recycled pages
never reaches a sum.  Rows with ``length <= 0`` return zeros.  Head dims
up to 256 (the gemmas) and GQA ratios up to 8 (MQA at 8 query heads) are
taken; above them the wrapper raises (:func:`kernel_limits`).

:func:`tcec_paged_attention` is the public entry (launch on CUDA, plain
version on CPU); :func:`tcec_paged_attention_plain` is the same function in
plain PyTorch, chunk for chunk.  ``launches`` counts calls of the entry
that launched the kernel (one a call, whether or not the second pass runs),
``f32_launches`` those of them on f32 pools; the autotuner's measurements
go through :func:`enqueue`, which counts nothing here.  :func:`takes_chunk` is the C entry's shared-memory rule for
a C, computed from the same layout (``csrc/tcec_paged_attention.cu::
Layout``), so that the autotuner launches no C the entry would refuse.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.policy import get_policy
from . import _build, meta
from .tcec_attention import NEG_INF, _product, _terms
from .tcec_matmul import check_policy, fold

MAX_REP = 8
MAX_PAGE = 64
HDMAX = 256
KV_BUDGET = 32 * 1024   # bytes of K and V (as pooled) a chunk gathers
CHUNK_TOKENS = 128      # most tokens a chunk's scores and terms are kept for
SMS = 132               # H100 SXM streaming multiprocessors
SMEM_MAX = 232448       # bytes of shared memory a block may use (the C's)

launches = 0
f32_launches = 0
POOL_DTYPES = (torch.bfloat16, torch.float32)
# q, k_pages, v_pages, block_tables, lengths, out, workspace; B, Hkv, rep,
# hd, hdv, ps, maxp, C, window; softcap, sm_denom; n_splits, scale_bits,
# page_bytes; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def kernel_limits(q, k_pages, v_pages) -> str | None:
    """The CUDA kernel's limit these decode-layout operands break (q (B,
    H, hd), pools (NP, ps, Hkv, hd[v])), named, or None: rep ``H / Hkv``
    <= ``MAX_REP``, pages of <= ``MAX_PAGE`` tokens, head dims <= ``HDMAX``
    and bf16 or f32 pools of one dtype.  ``kernels.dispatch`` checks them
    in its rule walk before a launch; the plain version takes any."""
    H, hd = q.shape[1], q.shape[2]
    ps, Hkv, hdv = k_pages.shape[1], k_pages.shape[2], v_pages.shape[3]
    if Hkv and H // Hkv > MAX_REP:
        return f"rep {H // Hkv} > {MAX_REP} query heads a kv head"
    if ps > MAX_PAGE:
        return f"page size {ps} > {MAX_PAGE} tokens"
    if max(hd, hdv) > HDMAX:
        return f"head dims {hd}/{hdv} > {HDMAX}"
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in POOL_DTYPES:
        return (f"pools {k_pages.dtype}/{v_pages.dtype}: bf16 or f32 pools "
                "of one dtype")
    return None


def chunk_pages(B: int, Hkv: int, maxp: int, ps: int, hd: int = HDMAX,
                hdv: int = HDMAX, elem: int = 2) -> int:
    """Pages per chunk of a slot's block table: as many as fit
    ``KV_BUDGET`` bytes of K and V as the pool holds them (``elem`` bytes
    an element: 2 for bf16 pools, 4 for f32) and ``CHUNK_TOKENS`` tokens,
    fewer while the table's chunks would give the card fewer than two
    blocks an SM.  At qwen3-0.6b's decode (4 slots, 8 kv heads, 40 pages
    of 16, hd 128) that is 4 pages of bf16: 64 tokens, 32 KB a block, 320
    blocks, or 2 pages of f32 (640 blocks); at hd 256 it is at most 2
    pages of bf16 (gemma2-9b: 8 kv heads) and 1 of f32, and 1 for
    gemma-2b's single kv head at 4 slots (160 blocks)."""
    c = min(maxp, KV_BUDGET // (elem * ps * (hd + hdv)), CHUNK_TOKENS // ps)
    c = max(1, c)
    while c > 1 and B * Hkv * -(-maxp // c) < 2 * SMS:
        c -= 1
    return c


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def smem_bytes(C: int, ps: int, rep: int, hd: int, hdv: int,
               n_splits: int, k_terms: int = 1) -> int:
    """Dynamic shared memory of a first-pass block at C pages a chunk: the
    C source's ``Layout(C, ps, rep, hd, hdv, ns, kt).total``.  ``k_terms``
    is the bf16 rows a K or V element takes there: 1 for bf16 pools,
    ``n_splits`` for f32 pools (their terms)."""
    TP = _round_up(C * ps, 16)
    hd16, hdv16 = _round_up(hd, 16), _round_up(hdv, 16)
    NQ, MP = _round_up(rep * n_splits, 8), _round_up(rep * n_splits, 16)
    kstride, vstride, pstride = hd16 * 2 + 16, hdv16 * 2 + 16, TP * 2 + 16
    vs = max(k_terms * TP * kstride, MP * hdv16 * 4)
    qb = vs + k_terms * TP * vstride
    sg = qb + NQ * kstride
    ss = sg + TP * NQ * 4
    pa = ss + rep * TP * 4
    rows = pa + MP * pstride
    return rows + TP * 4


def takes_chunk(C: int, maxp: int, ps: int, rep: int, hd: int, hdv: int,
                n_splits: int, k_terms: int = 1) -> bool:
    """Whether the C entry takes C pages a chunk: C within the block table,
    the first pass's block and the combine's ``2 chunks rep`` floats within
    ``SMEM_MAX`` (else it returns ``cudaErrorInvalidValue``)."""
    nch = -(-maxp // C) if maxp > 0 else 1
    return (1 <= C <= max(maxp, 1)
            and smem_bytes(C, ps, rep, hd, hdv, n_splits, k_terms)
            <= SMEM_MAX
            and (nch == 1 or 2 * nch * rep * 4 <= SMEM_MAX))


def live_chunks(lengths, maxp: int, ps: int, C: int, window: int = 0):
    """(B, chunks) bool: chunks holding at least one valid token, the ones
    that get a block of their own and a partial in the second pass."""
    lengths = torch.as_tensor(lengths).to(torch.int64)
    nch = max(1, -(-maxp // C))
    c = torch.arange(nch, device=lengths.device)
    col0 = c * C * ps
    last = torch.clamp_max((c + 1) * C, maxp) * ps - 1
    live = (col0[None] < lengths[:, None]) & (last >= col0)[None]
    if window > 0:
        live = live & ((lengths - 1)[:, None] - last[None] < window)
    return live


def _plain_core(qt, k_pages, v_pages, block_tables, lengths, pol, window,
                softcap, sm_denom, C):
    """The kernel's arithmetic: qt (B, Hkv, rep, hd) f32, pages (NP, ps, Hkv,
    hd[v]), block_tables (B, maxp), lengths (B,) incl. the current token;
    chunks of C pages, each a softmax partial, combined in chunk order."""
    B, Hkv, rep, hd = qt.shape
    ps, hdv = k_pages.shape[1], v_pages.shape[3]
    maxp = block_tables.shape[1]
    dev = qt.device
    sq = _terms(qt, pol)
    lengths = lengths.to(torch.int64)
    cur = lengths - 1
    single = maxp == 1
    live = live_chunks(lengths, maxp, ps, C, window)
    parts = []                               # (chunk, m, l, accs)
    for c in range(live.shape[1]):
        if not bool(live[:, c].any()):
            continue
        pg0 = c * C
        npg = min(C, maxp - pg0)
        pos = pg0 * ps + torch.arange(npg * ps, device=dev)
        ok = pos[None] <= cur[:, None]                          # (B, T)
        if window > 0:
            ok = ok & (cur[:, None] - pos[None] < window)
        pages = block_tables[:, pg0:pg0 + npg].to(torch.int64)
        sel = ok[:, :, None, None]
        # select, not bias: stale entries of a recycled page never enter
        kb = torch.where(sel, k_pages[pages].flatten(1, 2).float(), 0.0)
        vb = torch.where(sel, v_pages[pages].flatten(1, 2).float(), 0.0)
        sk = _terms(kb.permute(0, 2, 3, 1), pol)                # (B,Hkv,hd,T)
        s = fold(_product(sq, sk, pol), pol.scale_bits) / sm_denom
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(ok[:, None, None, :], s, NEG_INF)       # (B,Hkv,rep,T)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        if single:
            p = p / l
        accs = _product(_terms(p, pol), _terms(vb.permute(0, 2, 1, 3), pol),
                        pol)
        parts.append((c, m, l, accs))
    if live.shape[1] == 1:                   # one chunk: no second pass
        if not parts:
            return torch.zeros((B, Hkv, rep, hdv), device=dev)
        _, _, l, accs = parts[0]
        out = fold(accs, pol.scale_bits)
        if not single:
            out = out / torch.clamp_min(l, 1e-30)
    else:                                    # the second pass
        M = torch.full((B, Hkv, rep, 1), NEG_INF, device=dev)
        for c, m, _, _ in parts:
            M = torch.where(live[:, c, None, None, None],
                            torch.maximum(M, m), M)
        l = torch.zeros((B, Hkv, rep, 1), device=dev)
        accs = [torch.zeros((B, Hkv, rep, hdv), device=dev)
                for _ in pol.groups]
        for c, m, lj, accj in parts:
            r4 = live[:, c, None, None, None]
            w = torch.exp(torch.where(r4, m - M, 0.0))
            l = torch.where(r4, l + w * lj, l)
            accs = [torch.where(r4, a + w * aj, a)
                    for a, aj in zip(accs, accj)]
        out = fold(accs, pol.scale_bits) / torch.clamp_min(l, 1e-30)
    return torch.where(live.any(1)[:, None, None, None], out, 0.0)


def _launch(qt, k_pages, v_pages, block_tables, lengths, pol, window,
            softcap, sm_denom, C):
    global launches, f32_launches
    out = _enqueue(qt, k_pages, v_pages, block_tables, lengths, pol, window,
                   softcap, sm_denom, C)
    launches += 1
    if k_pages.dtype == torch.float32:
        f32_launches += 1
    return out


def _enqueue(qt, k_pages, v_pages, block_tables, lengths, pol, window,
             softcap, sm_denom, C):
    B, Hkv, rep, hd = qt.shape
    NP, ps, Hkv2, hd2 = k_pages.shape
    hdv = v_pages.shape[3]
    maxp = block_tables.shape[1]
    if (rep > MAX_REP or ps > MAX_PAGE or hd > HDMAX or hdv > HDMAX
            or Hkv2 != Hkv or hd2 != hd or v_pages.shape[:3] != (NP, ps, Hkv)):
        raise ValueError(f"CUDA paged attention takes rep <= {MAX_REP}, page "
                         f"size <= {MAX_PAGE}, head dims <= {HDMAX}; got "
                         f"q {tuple(qt.shape)}, pages {tuple(k_pages.shape)}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in POOL_DTYPES:
        raise TypeError("CUDA paged attention takes bf16 or f32 page pools "
                        f"of one dtype; got {k_pages.dtype}/{v_pages.dtype}")
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
    nch = max(1, -(-maxp // C))
    work = None
    if nch > 1:   # per chunk: m and l (rep each), then rep x hdv per group
        work = torch.empty(B * Hkv * nch * rep * (2 + pol.n_splits * hdv),
                           dtype=torch.float32, device=qt.device)
    fn = _build.entry("tcec_paged_attention", _ARGTYPES)
    status = fn(_build.ptr(qt), _build.ptr(k_pages), _build.ptr(v_pages),
                _build.ptr(block_tables), _build.ptr(lengths),
                _build.ptr(out), None if work is None else _build.ptr(work),
                B, Hkv, rep, hd, hdv, ps, maxp, C, int(window),
                float(softcap or 0.0), float(sm_denom), pol.n_splits,
                pol.scale_bits, k_pages.element_size(), _build.stream(qt))
    _build.check("tcec_paged_attention", status)
    return out


def _meta_core(qt, k_pages, v_pages, block_tables, lengths, pol, window,
               softcap, sm_denom, C):
    """The ``meta`` route (``kernels/meta.py``): an empty (B, Hkv, rep,
    hdv) f32 result and one record.  FLOPs are the gather-and-attend
    composition's: kept terms x 2 B H T (hd + hdv) with T = maxp x ps, every
    page of the tables; bytes read the tables' pages once."""
    B, Hkv, rep, hd = qt.shape
    ps, hdv = k_pages.shape[1], v_pages.shape[3]
    maxp = block_tables.shape[1]
    T = maxp * ps
    out = qt.new_empty((B, Hkv, rep, hdv), dtype=torch.float32)
    terms = len(pol.keep)
    pages = B * T * Hkv * (hd + hdv) * k_pages.element_size()
    meta.record(meta.KernelRecord(
        "tcec_paged_attention", (tuple(qt.shape), tuple(k_pages.shape),
                                 tuple(block_tables.shape)),
        pol.name, terms, float(terms) * 2 * B * Hkv * rep * T * (hd + hdv),
        float(pages + meta.nbytes(qt, block_tables, lengths, out))))
    return out


def _run(core, q, k_pages, v_pages, block_tables, lengths, policy, window,
         softcap, pages_per_chunk):
    pol = get_policy(policy)
    check_policy(pol)
    B, H, hd = q.shape
    Hkv, hdv = k_pages.shape[2], v_pages.shape[3]
    if Hkv == 0 or H % Hkv or k_pages.shape[3] != hd:
        raise ValueError(f"bad paged shapes q {tuple(q.shape)}, "
                         f"pages {tuple(k_pages.shape)}")
    maxp = block_tables.shape[1]
    if pages_per_chunk is None:
        C = chunk_pages(B, Hkv, maxp, k_pages.shape[1], hd, hdv,
                        k_pages.element_size())
    else:
        C = max(1, min(int(pages_per_chunk), maxp))
    qt = q.float().reshape(B, Hkv, H // Hkv, hd).contiguous()
    if meta.is_meta(qt):
        core = _meta_core
    window = int(0 if window is None else window)
    softcap = float(softcap) if softcap else None
    out = core(qt, k_pages, v_pages, block_tables, lengths, pol, window,
               softcap, float(math.sqrt(hd)), C)
    return out.reshape(B, H, hdv)


def enqueue(q, k_pages, v_pages, block_tables, lengths, *,
            policy: str = "tcec_bf16x6", window=0,
            softcap: float | None = None, pages_per_chunk: int | None = None):
    """:func:`tcec_paged_attention` on CUDA operands, uncounted (the
    autotuner's measurements)."""
    return _run(_enqueue, q, k_pages, v_pages, block_tables, lengths, policy,
                window, softcap, pages_per_chunk)


def tcec_paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                         policy: str = "tcec_bf16x6", window=0,
                         softcap: float | None = None,
                         pages_per_chunk: int | None = None):
    """Fused paged decode attention on model-layout operands.

    q: (B, H, hd) — one query token per slot; k_pages/v_pages: (NP, ps,
    Hkv, hd[v]) page pools (bf16 or f32 on the card); block_tables: (B, maxp) i32; lengths: (B,)
    i32 valid tokens including the current one (whose K/V is already in its
    page).  ``pages_per_chunk`` overrides :func:`chunk_pages` (clamped to
    1..maxp).  Returns (B, H, hdv) f32.  A CUDA tensor launches the kernel;
    a CPU tensor runs the plain version; a ``meta`` tensor takes the dry
    run's record (``kernels/meta.py``).
    """
    if q.is_cuda:
        core = _launch
    elif q.device.type in ("cpu", "meta"):
        core = _plain_core
    else:
        raise ValueError(f"no TCEC paged attention for device {q.device}")
    return _run(core, q, k_pages, v_pages, block_tables, lengths, policy,
                window, softcap, pages_per_chunk)


def tcec_paged_attention_plain(q, k_pages, v_pages, block_tables, lengths, *,
                               policy: str = "tcec_bf16x6", window=0,
                               softcap: float | None = None,
                               pages_per_chunk: int | None = None):
    """Kernel 3's function in plain PyTorch, on any device (``meta``
    operands take the record instead, as in
    :func:`tcec_paged_attention`)."""
    return _run(_plain_core, q, k_pages, v_pages, block_tables, lengths,
                policy, window, softcap, pages_per_chunk)
