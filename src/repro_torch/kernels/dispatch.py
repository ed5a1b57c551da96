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
     layout; and paged decode operands beyond kernel 3's limits on a
     device other than the CPU (:func:`tcec_paged_attention.kernel_limits`:
     rep, page size, head dims, pool dtype), which **raises** in the walk,
     naming the limit, before any launch and outside the breaker: the
     kernel cannot take them, and no plain path stands in;
  4. ``below-min-dim``: a dimension below ``min_dim`` (0 by default);
  5. ``fused``: the call goes to the kernel's public wrapper, which
     launches the CUDA kernel for a CUDA tensor and runs the plain PyTorch
     version for a CPU tensor.  There is no fallback: a kernel that fails to
     build or launch raises;
  6. ``mesh-declined`` (JAX's ``_mesh_plan_or_decline``): under a mesh
     installed by ``parallel.ctx.use_mesh``, a call with a plan from
     ``kernels/shmap.py`` goes to that module's wrapper, which runs the
     kernel per shard (rule 5 on the local shards).  With ``shard_map``
     off, with no plan for the shapes, or with ``"model"`` among the
     context's batch axes (``dp_over_model``), the call declines.  The
     epilogue hook declines under any mesh.

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
The port has no "off-backend" rule (``force`` changes nothing) and no
VMEM rule.  Kernel 1 takes the
autotuner's tile (:func:`tuned_block`, a path); kernel 3 its C.

Every rule walk records its slug in ``obs.explain``: declines where they
are decided, acceptances inside :func:`_guarded`, which launches.  The
calls that ``interpret`` / :func:`use_plain` send to a plain version record
``fused`` too: the route is the kernel's.  The port runs this on every
eager call; a CUDA graph replay runs no Python, so the engine's decode
graph records (and consults the breaker) only while it is captured.

:func:`_guarded` wraps the three launch sites (kernel 1 at fault site
``kernel.matmul``, kernel 2 at ``kernel.attention``, kernel 3 at
``kernel.paged``).  Under ``guard=True`` it runs the circuit breaker of
``kernels/guard.py``: a failure is counted and re-raised
(``kernel-failure``), an open breaker raises ``KernelQuarantined`` without
launching (``breaker-open``).  Unlike JAX's, it never returns None for the
caller to take the plain path instead.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from repro_torch import faults, numerics
from repro_torch.core.policy import PrecisionPolicy, get_policy
from repro_torch.obs.explain import record as _explain
from . import guard, ops, tuning
from .tcec_attention import tcec_attention, tcec_attention_plain
from .tcec_matmul import b_layout, takes_policy, tcec_matmul_plain
from .tcec_paged_attention import (kernel_limits, tcec_paged_attention,
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


def _guarded(kernel: str, ident: tuple, device, cfg, thunk, site: str):
    """Run a kernel launch ``thunk`` behind the circuit breaker.

    ``ident`` is ``(policy, *shape bucket)``, as in JAX; ``site`` is the
    ``faults`` injection point, poked before the launch.  With ``guard``
    off the fault (or the kernel's error) propagates and the breaker is not
    consulted.  With it on, the key ``(device type, kernel, *ident)`` is
    gated by ``guard.allow``: a closed (or half-open) breaker launches, and
    a failure is counted (``guard.failure``) and re-raised; an open one
    raises ``KernelQuarantined`` without launching.  Every outcome lands in
    the explain table.  There is no fallback: nothing here returns None.
    """
    dev = getattr(device, "type", device)
    pol, bucket = str(ident[0]), tuple(ident[1:])
    if not cfg.guard:
        faults.raise_if(site)
        out = thunk()
        _explain(dev, kernel, pol, bucket, "fused")
        return out
    key = guard.make_key(kernel, ident, dev)
    if not guard.allow(key):
        _explain(dev, kernel, pol, bucket, "breaker-open")
        raise guard.quarantined(key)
    try:
        faults.raise_if(site)
        out = thunk()
    except Exception as exc:       # counted, then re-raised: no fallback
        guard.failure(key, exc)
        _explain(dev, kernel, pol, bucket, "kernel-failure")
        raise
    guard.success(key)
    _explain(dev, kernel, pol, bucket, "fused")
    return out


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
    # DTensors through ctx.reshape: a dim sharded behind the first of a
    # flattened group is made whole there, not carried as a strided shard
    from repro_torch.parallel.ctx import reshape
    if nb:
        at = reshape(at, (math.prod(bsh), M, K))
        bt = reshape(bt, (math.prod(bsh), K, N))
    else:
        at = reshape(at, (M, K))
        bt = reshape(bt, (K, N))
    at = at.contiguous()
    if b_layout(bt) is None:
        bt = bt.contiguous()
    return at, bt, tuple(bsh) + tuple(msh) + tuple(nsh)


def _mesh_plan_or_decline(shapes_plan, cfg):
    """Rule 6: ``(mesh, plan)``; ``(None, None)`` when no mesh is
    installed, the string ``"decline"`` for the plan when a mesh is
    installed but ``shard_map`` is off, the context runs DP over the model
    axis (the plans would put ``model`` on N/K/M instead), or
    ``shapes_plan(mesh)`` has no plan."""
    from repro_torch.parallel import ctx
    mesh = ctx.current_mesh()
    if mesh is None:
        return None, None
    if not cfg.shard_map or "model" in ctx.dp_axes():
        return mesh, "decline"
    plan = shapes_plan(mesh)
    return mesh, (plan if plan is not None else "decline")


def _canonical_shapes(shape, dims):
    """The canonical operand shapes of a collapsed ``(batch, M, N, K)``."""
    batch, M, N, K = shape
    if dims[1][0]:
        return (batch, M, K), (batch, K, N)
    return (M, K), (K, N)


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
    from . import shmap
    _, plan = _mesh_plan_or_decline(
        lambda mesh: shmap.matmul_plan(*_canonical_shapes(shape, dims),
                                       mesh), cfg)
    if plan == "decline":
        return None, "mesh-declined"
    return shape, "fused"


def decide(a, b, policy: PrecisionPolicy, dims, cfg=None):
    """The GEMM dispatch decision: the collapsed ``(batch, M, N, K)`` when
    the contraction goes to kernel 1, else None (the term expansion)."""
    shape, _ = _decide(a, b, policy, dims, _cfg(cfg))
    return shape


def tuned_block(M: int, N: int, K: int, policy_name: str, batch: int = 1,
                cfg=None, operands=None,
                namespace: str | None = None) -> tuple[int, int, int]:
    """The config's ``block`` if set, else the autotuner's (measured on
    ``operands`` where it measures, or the rule by M), keyed under
    ``namespace`` (``"shmap"`` for a shard's local shape)."""
    cfg = _cfg(cfg)
    if cfg.block is not None:
        return cfg.block
    return tuning.get_block(M, N, K, policy_name, batch=batch, cfg=cfg,
                            namespace=namespace, operands=operands)


def _matmul_local(at, bt, policy_name, cfg, bias=None, activation=None,
                  namespace=None, block=None):
    """Kernel 1 on canonical local operands, unguarded: the plain version
    under ``interpret`` / :func:`use_plain`, else the wrapper with
    ``block``, or else the tuned tile (a CPU operand runs the plain version
    there).  The sharded wrapper runs this on each shard."""
    if b_layout(bt) is None:
        bt = bt.contiguous()
    if _plain(cfg):
        return tcec_matmul_plain(at, bt, policy_name, bias, activation)
    if block is None and at.is_cuda:
        batch = at.shape[0] if at.ndim == 3 else 1
        M, K, N = at.shape[-2], at.shape[-1], bt.shape[-1]
        block = tuned_block(M, N, K, policy_name, batch, cfg,
                            operands=(at, bt), namespace=namespace)
    return ops.tcec_matmul(at, bt, policy_name, bias, activation,
                           block=block)


def _kernel_matmul(at, bt, policy_name, cfg, bias=None, activation=None):
    """Kernel 1 on canonical operands, guarded at ``kernel.matmul``."""
    batch = at.shape[0] if at.ndim == 3 else 1
    M, K, N = at.shape[-2], at.shape[-1], bt.shape[-1]
    ident = (policy_name,) + tuning.shape_bucket(batch, M, N, K)
    return _guarded("matmul", ident, at.device, cfg,
                    lambda: _matmul_local(at, bt, policy_name, cfg, bias,
                                          activation),
                    "kernel.matmul")


def maybe_dispatch(a, b, policy: PrecisionPolicy, dims, cfg=None):
    """Kernel 1 for an eligible split-policy contraction, else None (the
    caller keeps the term expansion).  Called from ``core.policy._dot_impl``
    for every split-policy contraction, forward and backward.  Under a mesh
    the call runs per shard through ``shmap.sharded_matmul`` (rule 6)."""
    cfg = _cfg(cfg)
    shape, rule = _decide(a, b, policy, dims, cfg)
    if shape is None:
        _explain(a.device.type, "matmul", policy.name,
                 (tuple(a.shape), tuple(b.shape)), rule)
        return None
    at, bt, out_shape = _canonicalize(a, b, dims)
    from . import shmap
    mesh, plan = _mesh_plan_or_decline(
        lambda m: shmap.matmul_plan(at.shape, bt.shape, m), cfg)
    if mesh is None:
        return _kernel_matmul(at, bt, policy.name, cfg).reshape(out_shape)
    from repro_torch.parallel import ctx
    ident = (policy.name,) + tuning.shape_bucket(*shape)
    return ctx.reshape(_guarded(
        "matmul", ident, at.device, cfg,
        lambda: shmap.sharded_matmul(at, bt, policy=policy.name, mesh=mesh,
                                     cfg=cfg, plan=plan),
        "kernel.matmul"), out_shape)


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
    from . import shmap
    _, plan = _mesh_plan_or_decline(
        lambda mesh: shmap.attention_plan(q.shape, k.shape, mesh), cfg)
    if plan == "decline":
        return "mesh-declined"
    return "fused"


def attention_eligible(q, k, v, *, policy, cfg=None) -> bool:
    """Whether kernel 2 takes these operands under the config: a split
    bf16 policy on the triangular schedule; model-layout 4-D shapes with
    ``H % Hkv == 0``; ``min(S, T) >= min_dim``; both hatches open.  A
    decline is recorded here; an acceptance where the kernel launches."""
    pol = get_policy(policy)
    reason = _attention_reason(q, k, v, pol, _cfg(cfg))
    if reason != "fused":
        _explain(q.device.type, "attention", pol.name,
                 (tuple(q.shape), tuple(k.shape)), reason)
        return False
    return True


def attention(q, k, v, *, policy, q_pos=None, k_pos=None, causal: bool = True,
              window=0, softcap: float | None = None, cfg=None):
    """Kernel 2 for a model attention call (q (B, S, H, hd), k/v (B, T, Hkv,
    hd[v])), or None when it declines: the caller then takes the pdot
    composition.  The config's ``attn_block`` must be the one tile of the
    instantiation the head dims pick (``tuning.attn_candidate_blocks``)."""
    cfg = _cfg(cfg)
    pol = get_policy(policy)
    if not attention_eligible(q, k, v, policy=pol, cfg=cfg):
        return None
    B, S, H, hd = q.shape
    T, Hkv, hdv = k.shape[1], k.shape[2], v.shape[3]
    if cfg.attn_block is not None:
        tile = tuning.attn_heuristic_block(S, T, H // Hkv, hd, hdv, pol.name)
        if tuple(cfg.attn_block) != tile:
            raise ValueError(f"kernel 2 has one tile at head dims {hd}/{hdv}"
                             f" under {pol.name}: {tile}; got "
                             f"attn_block={cfg.attn_block}")
    ident = (pol.name, B, Hkv, H // Hkv, tuning._round_up(S, 128),
             tuning._round_up(T, 128))
    from . import shmap
    mesh, plan = _mesh_plan_or_decline(
        lambda m: shmap.attention_plan(q.shape, k.shape, m), cfg)
    if mesh is not None:
        run = (lambda: shmap.sharded_attention(
            q, k, v, q_pos, k_pos, policy=pol.name, causal=causal,
            window=window, softcap=softcap, mesh=mesh, cfg=cfg, plan=plan))
    else:
        run = (lambda: _attention_local(q, k, v, q_pos, k_pos, pol.name,
                                        causal, window, softcap, cfg))
    return _guarded("attention", ident, q.device, cfg, run,
                    "kernel.attention")


def _attention_local(q, k, v, q_pos, k_pos, policy_name, causal, window,
                     softcap, cfg):
    """Kernel 2 on local operands, unguarded (the plain version under
    ``interpret`` / :func:`use_plain`)."""
    fn = tcec_attention_plain if _plain(cfg) else tcec_attention
    return fn(q, k, v, q_pos, k_pos, policy=policy_name, causal=causal,
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
    from . import shmap
    _, plan = _mesh_plan_or_decline(
        lambda mesh: shmap.paged_plan(q.shape, k_pages.shape, mesh), cfg)
    if plan == "decline":
        return "mesh-declined"
    return "fused"


def attention_decode_eligible(q, k_pages, v_pages, *, policy,
                              cfg=None) -> bool:
    """Whether kernel 3 takes these decode-layout operands (q (B, H, hd),
    pools (NP, ps, Hkv, hd[v])) under the config.  No ``min_dim`` rule, as
    in JAX.  A decline is recorded here; an acceptance where the kernel
    launches."""
    pol = get_policy(policy)
    reason = _paged_reason(q, k_pages, v_pages, pol, _cfg(cfg))
    if reason != "fused":
        _explain(q.device.type, "paged_attention", pol.name,
                 (tuple(q.shape), tuple(k_pages.shape)), reason)
        return False
    return True


def attention_decode(q, k_pages, v_pages, block_tables, lengths, *, policy,
                     window=0, softcap: float | None = None, cfg=None):
    """Kernel 3 for one decode step against the paged cache (q (B, H, hd),
    pools (NP, ps, Hkv, hd[v]), lengths including the current token), or
    None when it declines: the caller then gathers the pages and attends
    densely.  C is the config's ``paged_block``, else the autotuner's on
    the card for bf16 pools (``chunk_pages`` where it does not measure, for
    f32 pools, and for the plain version).  Operands beyond the kernel's
    limits raise ``ValueError`` here (slug ``shape-unsupported``) when the
    kernel would run them, off the CPU; the breaker never sees them."""
    cfg = _cfg(cfg)
    pol = get_policy(policy)
    if not attention_decode_eligible(q, k_pages, v_pages, policy=pol,
                                     cfg=cfg):
        return None
    B, H, hd = q.shape
    _, ps, Hkv, _ = k_pages.shape
    maxp = block_tables.shape[1]
    if q.device.type != "cpu" and not _plain(cfg):
        limit = kernel_limits(q, k_pages, v_pages)
        if limit is not None:
            _explain(q.device.type, "paged_attention", pol.name,
                     (tuple(q.shape), tuple(k_pages.shape)),
                     "shape-unsupported")
            raise ValueError(f"kernel 3 does not take these operands: "
                             f"{limit}")

    ident = (pol.name, B, Hkv, H // Hkv, maxp, ps)
    from . import shmap
    mesh, plan = _mesh_plan_or_decline(
        lambda m: shmap.paged_plan(q.shape, k_pages.shape, m), cfg)
    if mesh is not None:
        run = (lambda: shmap.sharded_paged_attention(
            q, k_pages, v_pages, block_tables, lengths, policy=pol.name,
            window=window, softcap=softcap, mesh=mesh, cfg=cfg, plan=plan))
    else:
        run = (lambda: _paged_local(q, k_pages, v_pages, block_tables,
                                    lengths, pol.name, window, softcap, cfg))
    return _guarded("paged_attention", ident, q.device, cfg, run,
                    "kernel.paged")


def _paged_local(q, k_pages, v_pages, block_tables, lengths, policy_name,
                 window, softcap, cfg, namespace=None, pages_per_chunk=None):
    """Kernel 3 on local operands, unguarded: C is ``pages_per_chunk``,
    else the config's ``paged_block``, else the tuner's for bf16 pools on
    the card (keyed under ``namespace``), else :func:`chunk_pages`'s
    inside the wrapper."""
    C = cfg.paged_block if pages_per_chunk is None else pages_per_chunk
    if _plain(cfg):
        fn = tcec_paged_attention_plain
    else:
        fn = tcec_paged_attention
        if C is None and q.is_cuda and k_pages.dtype == torch.bfloat16:
            B, H, hd = q.shape
            _, ps, Hkv, _ = k_pages.shape
            C = tuning.get_paged_block(B, Hkv, H // Hkv,
                                       block_tables.shape[1], ps, hd,
                                       v_pages.shape[3], policy_name,
                                       cfg=cfg, namespace=namespace,
                                       device=q.device)
    return fn(q, k_pages, v_pages, block_tables, lengths,
              policy=policy_name, window=window, softcap=softcap,
              pages_per_chunk=C)


# ------------------------------------------------- epilogue-fusion hook

def epilogue_eligible(policy: PrecisionPolicy, cfg=None,
                      device="cuda") -> bool:
    """Whether ``models.layers.fused_linear`` may fold its bias and
    activation into kernel 1's epilogue under the config: ``enabled`` and
    ``fuse_epilogue`` on, a policy the kernel takes, and no mesh installed
    (``mesh-declined``: the unfused products then run per shard).  Records every
    decision (shape-independent: the bucket is empty) under ``device``,
    the caller's operand device; the product underneath records its own
    matmul decision."""
    rule = _epilogue_reason(policy, _cfg(cfg))
    _explain(getattr(device, "type", device), "epilogue", policy.name, (),
             rule)
    return rule == "fused"


def _epilogue_reason(policy: PrecisionPolicy, cfg) -> str:
    if not cfg.enabled or not cfg.fuse_epilogue:
        return "hatch-disabled"
    if not eligible_policy(policy):
        return _policy_rule(policy)
    from repro_torch.parallel import ctx
    if ctx.current_mesh() is not None:
        return "mesh-declined"
    return "fused"
