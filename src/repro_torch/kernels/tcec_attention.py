"""Kernel 2: TCEC flash attention for prefill.

Counterpart of ``repro/kernels/tcec_attention.py::_attn_kernel``.  The CUDA
kernel (``csrc/tcec_attention.cu``) takes the operands in the model's
layout, runs one block per (batch, kv head, 128 output columns, 64 query
rows), walks the K/V tiles itself, and computes QK^T and P·V with Hopper
``wgmma`` from bf16 term products with per-scale-group f32 accumulators in
registers, the additive ``NEG_INF`` mask, and the online softmax; the
``(S, T)`` scores never reach device memory.  Head dims are padded to 128
(qwen3, granite, zamba2, seamless, internvl2, qwen2.5-14b: tiles of 64
keys, 32 at x10) or to 256 (gemma-2b, gemma2-9b: 32 keys, 16 at x10, and
a block for each 128-wide half of the output columns); above 256 the
wrapper raises.  Any GQA ratio up to 64 query heads a kv head is taken
(64 query rows a block hold ``rep x floor(64 / rep)`` of them).

:func:`tcec_attention` is the public entry on model-layout operands: it
launches the kernel on a CUDA tensor or runs the plain version on a CPU
tensor.  :func:`tcec_attention_plain` is the same function in plain
PyTorch, tile for tile: the same key tiles (:func:`key_tile`, which the
wrapper checks against the kernel's), the same online softmax and the
same normalize-first branch when there is a single K/V tile.

``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.policy import get_policy
from . import _build, meta
from .tcec_matmul import check_policy, fold, split_tile

# The additive mask bias of models.layers (finite, so fully-masked rows give
# garbage instead of NaN, like the composition path).
NEG_INF = -2.0e38
ROWS = 64        # query rows per CUDA block (rep * positions, padded)
HDMAX = 256      # largest head_dim the CUDA kernel takes

launches = 0
_fn = None       # the C entry point, once its key tiles are checked
# q, k, v, q_pos, k_pos, out; B, Hkv, rep, S, T, hd, hdv, causal, window;
# softcap, sm_denom; n_splits, scale_bits; stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
    ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def key_tile(n_splits: int, head_dim: int) -> int:
    """Keys per K/V tile for ``n_splits`` terms at ``head_dim`` (the larger
    of hd and hdv, padded to 128 or 256): 64, 32 at x10, at 128; half that
    at 256.  Above ``HDMAX`` the kernel and its plain version refuse."""
    if head_dim > HDMAX:
        raise ValueError(f"TCEC attention takes head dims <= {HDMAX}; got "
                         f"{head_dim}")
    base = 64 if head_dim <= 128 else 32
    return base // 2 if n_splits == 4 else base


def _positions(p, n: int, device) -> torch.Tensor:
    if p is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    p = torch.as_tensor(p, device=device)
    if p.ndim == 2:                          # batch-uniform, like the models
        p = p[0]
    return p.to(torch.int32).contiguous()


def _check_shapes(q, k, v):
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != hd
            or Hkv == 0 or H % Hkv):
        raise ValueError(f"bad attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _group_heads(q, k, v):
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qt = q.float().reshape(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)
    return (qt.contiguous(), k.float().permute(0, 2, 1, 3).contiguous(),
            v.float().permute(0, 2, 1, 3).contiguous())


def _ungroup_heads(out):
    B, Hkv, rep, S, hdv = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * rep, hdv)


def _terms(x, pol):
    return [t.float() for t in split_tile(x, pol.n_splits, pol.scale_bits)]


def _product(a_terms, b_terms, pol):
    """Per-scale-group sums of the kept term products (unfolded)."""
    parts: dict[int, torch.Tensor] = {}
    for (i, j) in pol.keep:
        t = torch.matmul(a_terms[i], b_terms[j])
        g = i + j
        parts[g] = t if g not in parts else parts[g] + t
    return [parts[g] for g in pol.groups]


def _plain_core(qt, kt, vt, qp, kp, pol, causal, window, softcap, sm_denom):
    """The kernel's arithmetic, with the kv heads as a batch axis:
    q (B, Hkv, rep, S, hd), k (B, Hkv, T, hd), v (B, Hkv, T, hdv)."""
    B, Hkv, rep, S, hd = qt.shape
    T, hdv = kt.shape[2], vt.shape[3]
    sq = _terms(qt, pol)
    bkv = key_tile(pol.n_splits, max(hd, hdv))
    nkb = -(-T // bkv)
    single = nkb == 1
    m = torch.full((B, Hkv, rep, S, 1), NEG_INF, device=qt.device)
    l = torch.zeros((B, Hkv, rep, S, 1), device=qt.device)
    accs = [torch.zeros((B, Hkv, rep, S, hdv), device=qt.device)
            for _ in pol.groups]
    for kb in range(nkb):
        sl = slice(kb * bkv, min(T, (kb + 1) * bkv))
        sk = _terms(kt[:, :, None, sl].transpose(-1, -2), pol)
        s = fold(_product(sq, sk, pol), pol.scale_bits) / sm_denom
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        d = qp[:, None] - kp[None, sl]
        ok = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
        if window > 0:
            ok = ok & (d < window)
        s = s + torch.where(ok, 0.0, NEG_INF)
        if single:
            # the softmax completes here: normalize P before P.V
            p = torch.exp(s - s.amax(-1, keepdim=True))
            p = p / p.sum(-1, keepdim=True)
            alpha = None
        else:
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_next)
            p = torch.exp(s - m_next)
            l = alpha * l + p.sum(-1, keepdim=True)
            m = m_next
        parts = _product(_terms(p, pol), _terms(vt[:, :, None, sl], pol), pol)
        for gi, part in enumerate(parts):
            accs[gi] = accs[gi] + part if alpha is None \
                else accs[gi] * alpha + part
    out = fold(accs, pol.scale_bits)
    if not single:
        out = out / torch.clamp_min(l, 1e-30)
    return out


def _entry():
    global _fn
    if _fn is None:
        tile = _build.library("tcec_attention").tcec_attention_key_tile
        tile.argtypes, tile.restype = [ctypes.c_int] * 2, ctypes.c_int
        pairs = [(ns, hd) for ns in (2, 3, 4) for hd in (128, 256)]
        got = {p: tile(*p) for p in pairs}
        want = {p: key_tile(*p) for p in pairs}
        if got != want or tile(3, HDMAX + 4) != 0:
            raise RuntimeError(f"the CUDA kernel's key tiles {got} are not "
                               f"the plain version's {want}")
        _fn = _build.entry("tcec_attention", _ARGTYPES)
    return _fn


def _launch(q, k, v, qp, kp, pol, causal, window, softcap, sm_denom):
    """The CUDA kernel on contiguous f32 model-layout operands:
    q (B, S, H, hd), k (B, T, Hkv, hd), v (B, T, Hkv, hdv)."""
    global launches
    B, S, H, hd = q.shape
    T, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    rep = H // Hkv
    if rep > ROWS or hd > HDMAX or hdv > HDMAX or hd % 4 or hdv % 4:
        raise ValueError(f"CUDA attention takes rep <= {ROWS} and head dims "
                         f"<= {HDMAX} that are multiples of 4; got "
                         f"rep={rep}, hd={hd}, hdv={hdv}")
    for t in (q, k, v, qp, kp):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous on one CUDA device")
    if any(t.dtype != torch.float32 or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("CUDA attention needs f32 q, k, v on 16-byte "
                         "boundaries")
    out = torch.empty((B, S, H, hdv), dtype=torch.float32, device=q.device)
    if out.numel() == 0 or T == 0:
        return out.zero_()
    status = _entry()(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(qp),
        _build.ptr(kp), _build.ptr(out), B, Hkv, rep, S, T, hd, hdv,
        int(causal), int(window), float(softcap or 0.0), float(sm_denom),
        pol.n_splits, pol.scale_bits, _build.stream(q))
    _build.check("tcec_attention", status)
    launches += 1
    return out


def _meta_call(q, k, v, pol):
    """The ``meta`` route (``kernels/meta.py``): an empty (B, S, H, hdv)
    f32 result and one record.  FLOPs are the composition's: kept terms x
    (2 B H S T hd for QK^T + 2 B H S T hdv for P.V), every (query, key)
    pair, masked or not, as JAX's ``mha`` / ``blocked_attention`` lower."""
    B, S, H, hd = q.shape
    T, hdv = k.shape[1], v.shape[3]
    out = q.new_empty((B, S, H, hdv), dtype=torch.float32)
    terms = len(pol.keep)
    f32 = 4 * (q.numel() + k.numel() + v.numel() + out.numel())
    meta.record(meta.KernelRecord(
        "tcec_attention", (tuple(q.shape), tuple(k.shape), tuple(v.shape)),
        pol.name, terms, float(terms) * 2 * B * H * S * T * (hd + hdv),
        float(f32 + 4 * (S + T))))
    return out


def _run(plain, q, k, v, q_pos, k_pos, policy, causal, window, softcap):
    pol = get_policy(policy)
    check_policy(pol)
    _check_shapes(q, k, v)
    if meta.is_meta(q):
        return _meta_call(q, k, v, pol)
    qp = _positions(q_pos, q.shape[1], q.device)
    kp = _positions(k_pos, k.shape[1], q.device)
    args = (pol, bool(causal), int(0 if window is None else window),
            float(softcap) if softcap else None, float(math.sqrt(q.shape[-1])))
    if plain:
        return _ungroup_heads(_plain_core(*_group_heads(q, k, v), qp, kp,
                                          *args))
    return _launch(q.float().contiguous(), k.float().contiguous(),
                   v.float().contiguous(), qp, kp, *args)


def tcec_attention(q, k, v, q_pos=None, k_pos=None, *,
                   policy: str = "tcec_bf16x6", causal: bool = True,
                   window=0, softcap: float | None = None):
    """Fused TCEC attention on model-layout operands.

    q: (B, S, H, hd); k: (B, T, Hkv, hd); v: (B, T, Hkv, hdv); GQA via
    ``H = rep * Hkv``.  ``q_pos``/``k_pos`` are (S,)/(T,) position vectors
    or batch-uniform (B, S)/(B, T) ones (default ``arange``); ``window`` 0 is
    unlimited.  Returns (B, S, H, hdv) f32.  A CUDA tensor launches the
    kernel; a CPU tensor runs :func:`tcec_attention_plain`'s arithmetic; a
    ``meta`` tensor takes the dry run's record (``kernels/meta.py``).
    """
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no TCEC attention for device {q.device}")
    return _run(not q.is_cuda, q, k, v, q_pos, k_pos, policy, causal, window,
                softcap)


def tcec_attention_plain(q, k, v, q_pos=None, k_pos=None, *,
                         policy: str = "tcec_bf16x6", causal: bool = True,
                         window=0, softcap: float | None = None):
    """Kernel 2's function in plain PyTorch, on any device (``meta``
    operands take the record instead, as in :func:`tcec_attention`)."""
    return _run(True, q, k, v, q_pos, k_pos, policy, causal, window, softcap)
