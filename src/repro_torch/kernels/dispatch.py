"""Kernel dispatch: routes framework contractions and attention calls to the
three TCEC kernels.

Configuration comes from :mod:`repro_torch.numerics`: every decision
function takes the frozen ``NumericsConfig`` as ``cfg`` (None means
``numerics.active()``).  The rule walks return the JAX package's slugs:

  1. ``hatch-disabled``: ``enabled`` is off (or the kernel's own hatch:
     ``flash_attention``, ``paged_attention``, ``fuse_epilogue``);
  2. ``plain-policy`` / ``policy-ineligible``: the policy is not one the
     kernels take (:func:`tcec_matmul.takes_policy`: bf16 split policies on
     the triangular schedule, x3 / x6 / x10).  Plain policies are one f32
     product, upcast (fp16 / fp8) and other bf16 schedules take the term
     expansion or the pdot composition, and compensated policies (x9) run
     their TwoSum K loop (``core.policy._compensated_dot``) in plain
     PyTorch on any device;
  3. ``shape-unsupported``: attention operands that are not the model
     layout;
  4. ``below-min-dim``: a dimension below ``min_dim`` (0 by default);
  5. ``fused``: the call goes to the kernel's public wrapper, which
     launches the CUDA kernel for a CUDA tensor and runs the plain PyTorch
     version for a CPU tensor.  There is no fallback: a kernel that fails to
     build or launch raises.

A declined contraction takes ``core.policy``'s term expansion, declined
attention the pdot composition, declined paged decode the gather and a
dense bf16 attend: no kernel launches.  ``interpret=True`` (thread-scoped)
and :func:`use_plain` (process-wide) send every eligible call to the
kernels' plain versions instead, on any device; ``use_plain`` exists to
compare the kernel path with the plain path on the card, and is
process-wide because autograd runs a CUDA backward on a worker thread of
its own (the port's ``autograd.Function``s carry the forward's config
into the backward for the same reason).

Routing differences from the JAX package: JAX's ``_canonicalize`` declines
contractions with more than one free dim per operand (for GSPMD's sake);
this port has no GSPMD, so :func:`_canonicalize` collapses the free dims
by reshape and every model projection and the unembed run on kernel 1.
The port has no "off-backend" rule (``force`` changes nothing), no mesh
rule (``shard_map`` is item 16), no VMEM rule and no explain table (item
15): the slug is returned, not recorded.  Kernel 1 takes the autotuner's
tile (:func:`tuned_block`, a path); kernel 3 its C.
"""
from __future__ import annotations

import contextlib
import math
import threading

from repro_torch import numerics
from repro_torch.core.policy import PrecisionPolicy, get_policy
from . import ops, tuning
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


def _cfg(cfg) -> numerics.NumericsConfig:
    return cfg if cfg is not None else numerics.active()


def _plain(cfg) -> bool:
    """Whether an eligible call runs the kernel's plain version."""
    return _plain_depth > 0 or bool(cfg.interpret)


def _policy_rule(policy: PrecisionPolicy) -> str:
    """Rule-2 decline slug: plain policies vs the others."""
    return "plain-policy" if policy.is_plain() else "policy-ineligible"


def eligible_policy(policy: PrecisionPolicy) -> bool:
    """Rule 2: the policies the kernels take, by the wrappers' own rule.
    The JAX kernels also take other bf16 schedules; these kernels are
    specialised to the triangular ones."""
    return takes_policy(policy)


def _collapsed(a, b, dims):
    """``(batch, M, N, K)`` of a ``dot_general`` spec once its batch,
    free and contracted dims are collapsed (no copy)."""
    (ca, cb), (ba, bb) = dims
    sa = a.shape
    batch = math.prod(sa[d] for d in ba)
    M = math.prod(sa[d] for d in range(a.ndim) if d not in ca and d not in ba)
    K = math.prod(sa[d] for d in ca)
    N = math.prod(b.shape[d] for d in range(b.ndim)
                  if d not in cb and d not in bb)
    return batch, M, N, K


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


def _decide(a, b, policy: PrecisionPolicy, dims, cfg):
    """The rule walk: ``(collapsed (batch, M, N, K) | None, rule slug)``;
    the slug names the declining rule or is ``"fused"``."""
    if not cfg.enabled:
        return None, "hatch-disabled"
    if not eligible_policy(policy):
        return None, _policy_rule(policy)
    shape = _collapsed(a, b, dims)
    if min(shape[1:]) < cfg.min_dim:
        return None, "below-min-dim"
    return shape, "fused"


def decide(a, b, policy: PrecisionPolicy, dims, cfg=None):
    """The GEMM dispatch decision: the collapsed ``(batch, M, N, K)`` when
    the contraction goes to kernel 1, else None (the term expansion)."""
    shape, _ = _decide(a, b, policy, dims, _cfg(cfg))
    return shape


def tuned_block(M: int, N: int, K: int, policy_name: str, batch: int = 1,
                cfg=None, operands=None) -> tuple[int, int, int]:
    """The config's ``block`` if set, else the autotuner's (measured on
    ``operands`` where it measures, or the rule by M)."""
    cfg = _cfg(cfg)
    if cfg.block is not None:
        return cfg.block
    return tuning.get_block(M, N, K, policy_name, batch=batch, cfg=cfg,
                            operands=operands)


def _kernel_matmul(at, bt, policy_name, cfg, bias=None, activation=None):
    """Kernel 1 on canonical operands: the plain version under
    ``interpret`` / :func:`use_plain`, else the wrapper with the tuned tile
    (a CPU operand runs the plain version there)."""
    if _plain(cfg):
        return tcec_matmul_plain(at, bt, policy_name, bias, activation)
    block = None
    if at.is_cuda:
        batch = at.shape[0] if at.ndim == 3 else 1
        block = tuned_block(at.shape[-2], bt.shape[-1], at.shape[-1],
                            policy_name, batch, cfg, operands=(at, bt))
    return ops.tcec_matmul(at, bt, policy_name, bias, activation,
                           block=block)


def maybe_dispatch(a, b, policy: PrecisionPolicy, dims, cfg=None):
    """Kernel 1 for an eligible split-policy contraction, else None (the
    caller keeps the term expansion).  Called from ``core.policy._dot_impl``
    for every split-policy contraction, forward and backward."""
    cfg = _cfg(cfg)
    shape, _ = _decide(a, b, policy, dims, cfg)
    if shape is None:
        return None
    at, bt, out_shape = _canonicalize(a, b, dims)
    return _kernel_matmul(at, bt, policy.name, cfg).reshape(out_shape)


def fused_matmul(x2, w, policy: PrecisionPolicy, bias=None, activation=None,
                 cfg=None):
    """Kernel 1 with its epilogue ``act(x2 @ w + bias)`` for
    ``models.layers.fused_linear`` (``x2`` (M, D), ``w`` (D, F)); the caller
    has checked :func:`epilogue_eligible`."""
    return _kernel_matmul(x2.float().contiguous(), w.float(), policy.name,
                          _cfg(cfg), bias, activation)


# ------------------------------------------------- attention dispatch

def _attention_reason(q, k, v, pol, cfg) -> str:
    """The attention rule walk: ``"fused"`` when eligible, else the
    declining rule's slug."""
    if not cfg.enabled or not cfg.flash_attention:
        return "hatch-disabled"
    if not eligible_policy(pol):
        return _policy_rule(pol)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        return "shape-unsupported"
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0] != B or v.shape[:3] != k.shape[:3] or k.shape[3] != hd
            or Hkv == 0 or H % Hkv):
        return "shape-unsupported"
    if min(S, T) < cfg.min_dim:
        return "below-min-dim"
    return "fused"


def attention_eligible(q, k, v, *, policy, cfg=None) -> bool:
    """Whether kernel 2 takes these operands under the config: a split
    bf16 policy on the triangular schedule; model-layout 4-D shapes with
    ``H % Hkv == 0``; ``min(S, T) >= min_dim``; both hatches open."""
    return _attention_reason(q, k, v, get_policy(policy), _cfg(cfg)) \
        == "fused"


def attention(q, k, v, *, policy, q_pos=None, k_pos=None, causal: bool = True,
              window=0, softcap: float | None = None, cfg=None):
    """Kernel 2 for a model attention call (q (B, S, H, hd), k/v (B, T, Hkv,
    hd[v])), or None when it declines: the caller then takes the pdot
    composition.  The config's ``attn_block`` must be the one tile of the
    instantiation the head dims pick (``tuning.attn_candidate_blocks``)."""
    cfg = _cfg(cfg)
    pol = get_policy(policy)
    if _attention_reason(q, k, v, pol, cfg) != "fused":
        return None
    B, S, H, hd = q.shape
    T, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if cfg.attn_block is not None:
        tile = tuning.attn_heuristic_block(S, T, H // Hkv, hd, hdv, pol.name)
        if tuple(cfg.attn_block) != tile:
            raise ValueError(f"kernel 2 has one tile at head dims {hd}/{hdv}"
                             f" under {pol.name}: {tile}; got "
                             f"attn_block={cfg.attn_block}")
    fn = tcec_attention_plain if _plain(cfg) else tcec_attention
    return fn(q, k, v, q_pos, k_pos, policy=pol.name, causal=causal,
              window=window, softcap=softcap)


# -------------------------------------------- paged decode-attention

def _paged_reason(q, k_pages, v_pages, pol, cfg) -> str:
    """The paged decode-attention rule walk: ``"fused"`` when eligible,
    else the declining rule's slug."""
    if not cfg.enabled or not cfg.paged_attention:
        return "hatch-disabled"
    if not eligible_policy(pol):
        return _policy_rule(pol)
    if q.ndim != 3 or k_pages.ndim != 4 or v_pages.ndim != 4:
        return "shape-unsupported"
    B, H, hd = q.shape
    NP, ps, Hkv, hd2 = k_pages.shape
    if (hd2 != hd or v_pages.shape[:3] != k_pages.shape[:3]
            or Hkv == 0 or H % Hkv):
        return "shape-unsupported"
    return "fused"


def attention_decode_eligible(q, k_pages, v_pages, *, policy,
                              cfg=None) -> bool:
    """Whether kernel 3 takes these decode-layout operands (q (B, H, hd),
    pools (NP, ps, Hkv, hd[v])) under the config.  No ``min_dim`` rule, as
    in JAX."""
    return _paged_reason(q, k_pages, v_pages, get_policy(policy),
                         _cfg(cfg)) == "fused"


def attention_decode(q, k_pages, v_pages, block_tables, lengths, *, policy,
                     window=0, softcap: float | None = None, cfg=None):
    """Kernel 3 for one decode step against the paged cache (q (B, H, hd),
    pools (NP, ps, Hkv, hd[v]), lengths including the current token), or
    None when it declines: the caller then gathers the pages and attends
    densely.  C is the config's ``paged_block``, else the autotuner's on
    the card (``chunk_pages`` where it does not measure, and for the plain
    version)."""
    cfg = _cfg(cfg)
    pol = get_policy(policy)
    if _paged_reason(q, k_pages, v_pages, pol, cfg) != "fused":
        return None
    C = cfg.paged_block
    if _plain(cfg):
        fn = tcec_paged_attention_plain
    else:
        fn = tcec_paged_attention
        if C is None and q.is_cuda:
            B, H, hd = q.shape
            _, ps, Hkv, _ = k_pages.shape
            C = tuning.get_paged_block(B, Hkv, H // Hkv,
                                       block_tables.shape[1], ps, hd,
                                       v_pages.shape[3], pol.name, cfg=cfg,
                                       device=q.device)
    return fn(q, k_pages, v_pages, block_tables, lengths, policy=pol.name,
              window=window, softcap=softcap, pages_per_chunk=C)


# ------------------------------------------------- epilogue-fusion hook

def epilogue_eligible(policy: PrecisionPolicy, cfg=None) -> bool:
    """Whether ``models.layers.fused_linear`` may fold its bias and
    activation into kernel 1's epilogue under the config: ``enabled`` and
    ``fuse_epilogue`` on, and a policy the kernel takes."""
    return _epilogue_reason(policy, _cfg(cfg)) == "fused"


def _epilogue_reason(policy: PrecisionPolicy, cfg) -> str:
    if not cfg.enabled or not cfg.fuse_epilogue:
        return "hatch-disabled"
    if not eligible_policy(policy):
        return _policy_rule(policy)
    return "fused"
