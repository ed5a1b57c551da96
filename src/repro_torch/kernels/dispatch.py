"""Kernel dispatch: routes framework contractions and attention calls to the
three TCEC kernels.

The decision follows the tensor's device and the policy:

  1. the policy is one the kernels take (:func:`tcec_matmul.takes_policy`:
     bf16 split policies on the triangular schedule, x3 / x6 / x10); plain,
     upcast (fp16 / fp8) and other bf16 schedules stay on the term
     expansion or the pdot composition, and compensated policies (x9)
     decline the kernel as JAX's do: their TwoSum K loop
     (``core.policy._compensated_dot``) runs in plain PyTorch on any
     device;
  2. the call goes to the kernel's public wrapper, which launches the CUDA
     kernel for a CUDA tensor and runs the plain PyTorch version for a CPU
     tensor.  There is no fallback: a kernel that fails to build or launch
     raises.

:func:`use_plain` is the one explicit scope that sends every eligible call
to the kernels' plain PyTorch versions instead, on any device (the
counterpart of the JAX package's ``numerics.use(enabled=False)``); it exists
to compare the kernel path with the plain path on the card, and nothing on
the main path enters it.  The scope is process-wide, not per thread:
autograd runs a CUDA backward on a worker thread of its own, and the
backward's products, the attention recompute and the remat recompute must
be plain too.

Routing difference from the JAX package: JAX's ``_canonicalize`` declines
contractions with more than one free dim per operand, so on the TPU every
model projection (``pdot("bsd,dhk->bshk")``) and the unembed fall back to
the XLA term expansion — JAX avoids reshapes there for GSPMD's sake.  This
port has no GSPMD, so :func:`_canonicalize` collapses the free dims by
reshape and those products run on kernel 1.  The function computed is the
same.  ``tuning``, ``guard`` and ``shmap`` are not ported yet.
"""
from __future__ import annotations

import contextlib
import math
import threading

from repro_torch.core.policy import PrecisionPolicy, get_policy
from . import ops
from .tcec_attention import tcec_attention, tcec_attention_plain
from .tcec_matmul import b_layout, takes_policy, tcec_matmul_plain
from .tcec_paged_attention import (tcec_paged_attention,
                                   tcec_paged_attention_plain)

_lock = threading.Lock()
_plain_depth = 0


@contextlib.contextmanager
def use_plain():
    """Run every dispatched kernel call as its plain PyTorch version, on
    every thread of the process, until the scope exits."""
    global _plain_depth
    with _lock:
        _plain_depth += 1
    try:
        yield
    finally:
        with _lock:
            _plain_depth -= 1


def plain_active() -> bool:
    return _plain_depth > 0


def eligible_policy(policy: PrecisionPolicy) -> bool:
    """Rule 1: the policies the kernels take, by the wrappers' own rule.
    The JAX kernels also take other bf16 schedules; these kernels are
    specialised to the triangular ones."""
    return takes_policy(policy)


def _canonicalize(a, b, dims):
    """Map a ``dot_general`` spec onto the kernel's ``(B?, M, K) @ (B?, K, N)``
    layout by transposing and collapsing the batch, free and contracted dims.

    Returns ``(a3, b3, out_shape)``; ``out_shape`` restores the
    ``(batch..., lhs free..., rhs free...)`` layout of ``dot_general``.  ``b``
    stays a view wherever its rows or its columns are contiguous, since the
    kernel reads such a B in place (``tcec_matmul.b_layout``): the tied
    unembedding's transposed table, and MLA's per-head views of ``w_uk``
    and ``w_uv`` at decode (batch stride k, row stride h k).
    """
    (ca, cb), (ba, bb) = dims
    am = [d for d in range(a.ndim) if d not in ca and d not in ba]
    bn = [d for d in range(b.ndim) if d not in cb and d not in bb]
    at = a.float().permute(list(ba) + am + list(ca))
    bt = b.float().permute(list(bb) + list(cb) + bn)
    nb, nm, nk = len(ba), len(am), len(ca)
    bsh = at.shape[:nb]
    msh, ksh = at.shape[nb:nb + nm], at.shape[nb + nm:]
    nsh = bt.shape[nb + nk:]
    M, K, N = math.prod(msh), math.prod(ksh), math.prod(nsh)
    if nb:
        at = at.reshape(math.prod(bsh), M, K)
        bt = bt.reshape(math.prod(bsh), K, N)
    else:
        at = at.reshape(M, K)
        bt = bt.reshape(K, N)
    at = at.contiguous()
    if b_layout(bt) is None:
        bt = bt.contiguous()
    return at, bt, tuple(bsh) + tuple(msh) + tuple(nsh)


def maybe_dispatch(a, b, policy: PrecisionPolicy, dims):
    """Kernel 1 for an eligible split-policy contraction, else None (the
    caller keeps the term expansion).  Called from ``core.policy._dot_impl``
    for every split-policy contraction."""
    if not eligible_policy(policy):
        return None
    at, bt, out_shape = _canonicalize(a, b, dims)
    if plain_active():
        out = tcec_matmul_plain(at, bt, policy)
    else:
        out = ops.tcec_matmul(at, bt, policy=policy.name)
    return out.reshape(out_shape)


def attention(q, k, v, *, policy, q_pos=None, k_pos=None, causal: bool = True,
              window=0, softcap: float | None = None):
    """Kernel 2 for a model attention call (q (B, S, H, hd), k/v (B, T, Hkv,
    hd[v])), or None when the policy is not eligible — the caller then
    takes the pdot composition."""
    pol = get_policy(policy)
    if not eligible_policy(pol):
        return None
    fn = tcec_attention_plain if plain_active() else tcec_attention
    return fn(q, k, v, q_pos, k_pos, policy=pol.name, causal=causal,
              window=window, softcap=softcap)


def attention_decode(q, k_pages, v_pages, block_tables, lengths, *, policy,
                     window=0, softcap: float | None = None):
    """Kernel 3 for one decode step against the paged cache (q (B, H, hd),
    pools (NP, ps, Hkv, hd[v]), lengths including the current token), or
    None when the policy is not eligible — the caller then gathers the
    pages and attends densely."""
    pol = get_policy(policy)
    if not eligible_policy(pol):
        return None
    fn = tcec_paged_attention_plain if plain_active() else tcec_paged_attention
    return fn(q, k_pages, v_pages, block_tables, lengths, policy=pol.name,
              window=window, softcap=softcap)
