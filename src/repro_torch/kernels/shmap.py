"""Sharded TCEC: the three kernels run per shard under a mesh (the JAX
package's ``kernels/shmap.py`` :74-502, over ``torch.distributed``).

JAX wraps each kernel call in ``shard_map``; the port does what that
amounts to with DTensors.  Each wrapper takes the global operands (DTensors
on the mesh, or plain tensors, which count as replicated on every rank),
redistributes them to the plan's placements, runs the kernel's ordinary
dispatch on the local shards (``to_local``), and wraps the local result
with ``DTensor.from_local`` in the plan's output placements.  Plain
operands get a plain result: the whole tensor (a gather when the output is
sharded on more than one rank).

Three plan builders, :func:`matmul_plan`, :func:`attention_plan` and
:func:`paged_plan`, decide from static shapes and the mesh which dims
each mesh axis shards; they are pure shape code and return JAX's specs
(``parallel/sharding.py::P``).  A plan is None when an axis of size > 1
cannot be assigned to a dividing dim, or carries a name outside ``pod`` /
``data`` / ``model``; dispatch then declines (``mesh-declined``).  Axes of
size 1 never block a plan, so a one-rank mesh routes through the wrappers.

Reduction order (the part that must be pinned, as in JAX, :26-41):

  * M / N / batch / head / sequence sharding splits only independent
    output rows or columns.  Every scale-group fold happens locally and
    completely: each shard is bit-identical to the unsharded kernel on the
    same data.
  * K sharding splits the contraction.  Each rank folds its local partial
    products smallest-first (the kernel's epilogue, unchanged), and only
    then does one f32 ``all_reduce`` over the plan's ``psum_axes`` sum the
    partial products.  No split term ever crosses the wire: the sum is an
    f32 round-to-nearest reduction of f32 partials, and the bound gains the
    usual log2(shards) f32 summation ulps.

Tuning under a plan keys the **local** shape, under the ``shmap``
namespace (``kernels/tuning.py``'s ``backend/shmap/...`` keys), since the
tile the kernel runs is the shard's.  Without the tuner (``tune="off"``,
the port's default) each shard takes the hand rule's choice for the
**whole** shape, kernel 1's path by the global M and kernel 3's pages a
chunk by the global slots and heads: the port's kernels sum in an order
that those choices set, so a shard is then bitwise its rows of the
unsharded call.

:func:`counters` reads the ``kernels/shmap/calls`` registry counter
(label ``kernel``), one count each time a wrapper runs; the kernels' own
``launches`` count the per-shard launches.  JAX's deprecated ``CALLS`` /
``reset_calls`` are left out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch import numerics
from repro_torch.obs import metrics as _metrics
from repro_torch.parallel.ctx import (axis_names, axis_shape, is_dtensor,
                                      local_in)
from repro_torch.parallel.sharding import P, to_placements

# Cache namespace for per-shard tuning keys: ``backend/shmap/...``.
NAMESPACE = "shmap"

#: the wrapped kernels (label values of ``kernels/shmap/calls``)
KERNELS = ("matmul", "attention", "paged")


def _bump(kernel: str):
    _metrics.counter("kernels/shmap/calls").inc(kernel=kernel)


def counters() -> dict[str, int]:
    """Sharded-dispatch counts, ``{kernel: calls}`` (zeroes included),
    from the ``kernels/shmap/calls`` registry counter, so
    ``repro_torch.obs.snapshot()`` carries the same numbers."""
    c = _metrics.counter("kernels/shmap/calls")
    return {k: int(c.value(kernel=k)) for k in KERNELS}


def reset_counters():
    _metrics.counter("kernels/shmap/calls").reset()


def _cfg(cfg) -> numerics.NumericsConfig:
    return cfg if cfg is not None else numerics.active()


# ----------------------------------------------------------------- plans
#
# The framework's axis convention (parallel/sharding.py): ``pod``/``data``
# are the data-parallel axes, ``model`` the tensor-parallel one.  A plan
# assigns every size->1 mesh axis to a dim it divides; an unknown axis
# name of size > 1 makes the spec unsupported.

def _dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _axis_size(mesh, name: str) -> int:
    return int(axis_shape(mesh)[name]) if name in axis_names(mesh) else 1


def _dp_size(mesh) -> int:
    return math.prod(_axis_size(mesh, a) for a in _dp_axes(mesh))


def _known_axes_only(mesh) -> bool:
    shape = axis_shape(mesh)
    return all(a in ("pod", "data", "model") or int(shape[a]) == 1
               for a in axis_names(mesh))


@dataclass(frozen=True)
class MatmulPlan:
    """Per-shard operand specs for one canonical ``(B?, M, K) @ (B?, K, N)``.

    ``psum_axes`` is non-empty iff the contraction (K) is sharded: the
    wrapper then f32-``all_reduce``s the locally folded partial product
    over those axes.  ``local`` is the per-shard ``(B, M, N, K)`` the tuner
    keys on."""
    a_spec: P
    b_spec: P
    out_spec: P
    psum_axes: tuple[str, ...]
    local: tuple[int, int, int, int]
    sharded_dim: str                 # "batch" | "M" | "N" | "K" | "none"


def matmul_plan(a_shape, b_shape, mesh) -> MatmulPlan | None:
    """Assign mesh axes to the dims of a canonical GEMM, or None (JAX
    :177).  The data axes take the batch dim (3-D operands) or M (2-D).
    ``model`` prefers N (column parallel), then K (row parallel: local fold
    and f32 all-reduce), then M."""
    if not _known_axes_only(mesh):
        return None
    batched = len(a_shape) == 3
    B = a_shape[0] if batched else 1
    M, K = a_shape[-2], a_shape[-1]
    N = b_shape[-1]
    dp = _dp_axes(mesh)
    dsize = _dp_size(mesh)
    msize = _axis_size(mesh, "model")

    Bl, Ml, Nl, Kl = B, M, N, K
    a_dims = [None] * len(a_shape)
    b_dims = [None] * len(b_shape)
    o_dims = [None] * len(a_shape)

    m_taken = False
    if dsize > 1:
        if batched and B % dsize == 0:
            a_dims[0] = b_dims[0] = o_dims[0] = dp if len(dp) > 1 else dp[0]
            Bl = B // dsize
        elif M % dsize == 0:
            a_dims[-2] = o_dims[-2] = dp if len(dp) > 1 else dp[0]
            Ml = M // dsize
            m_taken = True
        else:
            return None

    psum: tuple[str, ...] = ()
    sharded = "none"
    if msize > 1:
        if N % msize == 0:
            b_dims[-1] = o_dims[-1] = "model"
            Nl = N // msize
            sharded = "N"
        elif K % msize == 0:
            a_dims[-1] = b_dims[-2] = "model"
            Kl = K // msize
            psum = ("model",)
            sharded = "K"
        elif M % msize == 0 and not m_taken:
            a_dims[-2] = o_dims[-2] = "model"
            Ml = M // msize
            sharded = "M"
        else:
            return None
    elif dsize > 1:
        sharded = "batch" if (batched and Bl != B) else "M"

    return MatmulPlan(P(*a_dims), P(*b_dims), P(*o_dims), psum,
                      (Bl, Ml, Nl, Kl), sharded)


@dataclass(frozen=True)
class AttentionPlan:
    """Per-shard specs for model-layout attention operands.  ``mode`` is
    ``"heads"`` (KV-head groups on ``model``) or ``"qseq"`` (query
    sequence on ``model``, K/V replicated; the global position vectors are
    sharded with q, so each shard masks at its true offsets).  ``local``
    is the per-shard ``(B, Hkv, S, T)`` the tuner keys on."""
    q_spec: P
    k_spec: P
    v_spec: P
    qp_spec: P
    kp_spec: P
    out_spec: P
    local: tuple[int, int, int, int]
    mode: str


def attention_plan(q_shape, k_shape, mesh) -> AttentionPlan | None:
    """q ``(B, S, H, hd)``, k ``(B, T, Hkv, hd)`` -> plan or None (JAX
    :260).  ``model`` prefers heads (``Hkv % msize == 0``, whole GQA groups
    a shard), else the q sequence (``S % msize == 0``); the data axes take
    the batch."""
    if not _known_axes_only(mesh):
        return None
    B, S, H, _ = q_shape
    T, Hkv = k_shape[1], k_shape[2]
    dp = _dp_axes(mesh)
    dsize = _dp_size(mesh)
    msize = _axis_size(mesh, "model")

    bdim = None
    Bl = B
    if dsize > 1:
        if B % dsize != 0:
            return None
        bdim = dp if len(dp) > 1 else dp[0]
        Bl = B // dsize

    Hkvl, Sl = Hkv, S
    if msize > 1 and Hkv % msize == 0:
        mode = "heads"
        Hkvl = Hkv // msize
        q_spec = P(bdim, None, "model", None)
        k_spec = v_spec = P(bdim, None, "model", None)
        qp_spec = kp_spec = P(bdim, None)
        out_spec = P(bdim, None, "model", None)
    elif msize > 1 and S % msize == 0:
        mode = "qseq"
        Sl = S // msize
        q_spec = P(bdim, "model", None, None)
        k_spec = v_spec = P(bdim, None, None, None)
        qp_spec = P(bdim, "model")
        kp_spec = P(bdim, None)
        out_spec = P(bdim, "model", None, None)
    elif msize > 1:
        return None
    else:
        mode = "heads"
        q_spec = k_spec = v_spec = P(bdim, None, None, None)
        qp_spec = kp_spec = P(bdim, None)
        out_spec = P(bdim, None, None, None)
    return AttentionPlan(q_spec, k_spec, v_spec, qp_spec, kp_spec, out_spec,
                         (Bl, Hkvl, Sl, T), mode)


@dataclass(frozen=True)
class PagedPlan:
    """Per-shard specs for paged decode attention: the pools shard their
    KV-head dim on ``model`` (each rank owns its heads' slices of every
    page); block tables and lengths are replicated over ``model`` and
    batch-sharded over the data axes with the query.  ``local`` is the
    per-shard ``(B, Hkv)``."""
    q_spec: P
    pool_spec: P
    bt_spec: P
    len_spec: P
    out_spec: P
    local: tuple[int, int]


def paged_plan(q_shape, pool_shape, mesh) -> PagedPlan | None:
    """q ``(B, H, hd)``, pools ``(NP, ps, Hkv, hd)`` -> plan or None (JAX
    :329)."""
    if not _known_axes_only(mesh):
        return None
    B, H, _ = q_shape
    Hkv = pool_shape[2]
    dp = _dp_axes(mesh)
    dsize = _dp_size(mesh)
    msize = _axis_size(mesh, "model")

    bdim = None
    Bl = B
    if dsize > 1:
        if B % dsize != 0:
            return None
        bdim = dp if len(dp) > 1 else dp[0]
        Bl = B // dsize

    Hkvl = Hkv
    hdim = None
    if msize > 1:
        if Hkv % msize != 0:
            return None
        hdim = "model"
        Hkvl = Hkv // msize
    return PagedPlan(
        q_spec=P(bdim, hdim, None),
        pool_spec=P(None, None, hdim, None),
        bt_spec=P(bdim, None),
        len_spec=P(bdim),
        out_spec=P(bdim, hdim, None),
        local=(Bl, Hkvl))


# ------------------------------------------------------- shard in / out

def _enter(x, mesh, spec):
    """The local shard of ``x`` (a DTensor, or a plain tensor taken as
    replicated) under ``spec``'s placements."""
    return local_in(x, mesh, to_placements(spec, mesh))


def _leave(local, mesh, spec, shape, as_dtensor: bool):
    """Wrap a local result as the global DTensor of ``shape`` under
    ``spec``; its whole tensor when the caller passed plain operands."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    out = DTensor.from_local(local.contiguous(), mesh,
                             to_placements(spec, mesh),
                             run_check=False, shape=shape, stride=stride)
    return out if as_dtensor else out.full_tensor()


def _psum(out, mesh, axes):
    for a in axes:
        if _axis_size(mesh, a) > 1:
            dist.all_reduce(out, group=mesh.get_group(a))
    return out


# -------------------------------------------------------------- wrappers

def sharded_matmul(a, b, *, policy: str, mesh, cfg=None,
                   plan: MatmulPlan | None = None):
    """Kernel 1 per shard under ``mesh`` on canonical ``(B?, M, K) @
    (B?, K, N)`` operands.  A K plan folds each shard's scale groups
    locally and then f32-all-reduces the partial products (the module
    docstring's reduction order)."""
    from . import dispatch
    cfg = _cfg(cfg)
    if plan is None:
        plan = matmul_plan(a.shape, b.shape, mesh)
    assert plan is not None, (a.shape, b.shape, axis_shape(mesh))
    as_dt = is_dtensor(a) or is_dtensor(b)
    la = _enter(a, mesh, plan.a_spec).float().contiguous()
    lb = _enter(b, mesh, plan.b_spec).float()
    block = cfg.block
    if block is None and cfg.tune == "off":
        B = a.shape[0] if len(a.shape) == 3 else 1
        block = dispatch.tuned_block(a.shape[-2], b.shape[-1], a.shape[-1],
                                     policy, B, cfg)
    out = dispatch._matmul_local(la, lb, policy, cfg, namespace=NAMESPACE,
                                 block=block)
    _psum(out, mesh, plan.psum_axes)
    _bump("matmul")
    return _leave(out, mesh, plan.out_spec,
                  tuple(a.shape[:-1]) + (b.shape[-1],), as_dt)


def _pos_2d(pos, B, n, device):
    """Global (B, n) i32 positions, made before the shard so that a
    q-sequence shard sees its true global offsets, not a local arange.  A
    (1, n) row (the cross-attention's) is every row's, and is broadcast
    before the batch is split."""
    if pos is None:
        pos = torch.arange(n, dtype=torch.int32, device=device)
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    if pos.ndim == 1:
        pos = pos[None]
    return pos.expand(B, n).contiguous()


def sharded_attention(q, k, v, q_pos=None, k_pos=None, *, policy: str,
                      causal: bool = True, window=0,
                      softcap: float | None = None, mesh, cfg=None,
                      plan: AttentionPlan | None = None):
    """Kernel 2 per shard under ``mesh`` on model-layout operands (q
    ``(B, S, H, hd)``, k/v ``(B, T, Hkv, hd[v])``).  Head sharding gives
    each rank whole GQA groups; q-sequence sharding replicates K/V and
    shards the query rows with their global positions.  Either way the
    softmax and every fold complete locally: each shard is bit-identical
    to the unsharded kernel on the same rows."""
    from . import dispatch
    cfg = _cfg(cfg)
    if plan is None:
        plan = attention_plan(q.shape, k.shape, mesh)
    assert plan is not None, (q.shape, k.shape, axis_shape(mesh))
    B, S, H, _ = q.shape
    T, hdv = k.shape[1], v.shape[3]
    as_dt = any(is_dtensor(t) for t in (q, k, v))
    qp = _enter(_pos_2d(q_pos, B, S, q.device), mesh, plan.qp_spec)
    kp = _enter(_pos_2d(k_pos, B, T, q.device), mesh, plan.kp_spec)
    lq = _enter(q, mesh, plan.q_spec)
    lk = _enter(k, mesh, plan.k_spec)
    lv = _enter(v, mesh, plan.v_spec)
    out = dispatch._attention_local(lq, lk, lv, qp, kp, policy, causal,
                                    window, softcap, cfg)
    _bump("attention")
    return _leave(out, mesh, plan.out_spec, (B, S, H, hdv), as_dt)


def sharded_paged_attention(q, k_pages, v_pages, block_tables, lengths, *,
                            policy: str, window=0,
                            softcap: float | None = None, mesh, cfg=None,
                            plan: PagedPlan | None = None):
    """Kernel 3 per shard under ``mesh``: the pools shard on the KV-head
    dim, block tables and lengths stay whole on every rank of the model
    axis, so each rank's page gather reads its own pool shard with the same
    table (no page traffic between ranks)."""
    from . import dispatch
    cfg = _cfg(cfg)
    if plan is None:
        plan = paged_plan(q.shape, k_pages.shape, mesh)
    assert plan is not None, (q.shape, k_pages.shape, axis_shape(mesh))
    B, H, _ = q.shape
    hdv = v_pages.shape[3]
    as_dt = any(is_dtensor(t) for t in (q, k_pages, v_pages))
    lq = _enter(q, mesh, plan.q_spec)
    lkp = _enter(k_pages, mesh, plan.pool_spec)
    lvp = _enter(v_pages, mesh, plan.pool_spec)
    bt = _enter(block_tables, mesh, plan.bt_spec)
    lens = _enter(lengths, mesh, plan.len_spec)
    C = cfg.paged_block
    if C is None and cfg.tune == "off":
        from .tcec_paged_attention import chunk_pages
        C = chunk_pages(B, k_pages.shape[2], block_tables.shape[1],
                        k_pages.shape[1], k_pages.shape[3], hdv,
                        k_pages.element_size())
    out = dispatch._paged_local(lq, lkp, lvp, bt, lens, policy, window,
                                softcap, cfg, namespace=NAMESPACE,
                                pages_per_chunk=C)
    _bump("paged")
    return _leave(out, mesh, plan.out_spec, (B, H, hdv), as_dt)
