"""Precision policies: the paper's technique as a framework-wide matmul knob.

Every weight/activation contraction of the models routes through
:func:`pdot` (binary einsum front-end) or :func:`policy_mm` /
:func:`policy_bmm`.  A :class:`PrecisionPolicy` selects plain f32, plain
bf16, or a split policy whose kept term products are accumulated per scale
group in f32 and folded smallest-first (the paper's Code 3).

Every split contraction funnels through :func:`_dot_impl`, which hands
bf16 split policies to ``kernels.dispatch`` (kernel 1 on a CUDA tensor, its
plain version on the CPU) and keeps the term expansion :func:`_tcec_dot`
for the policies the kernel does not take (fp16 / fp8 upcast policies).
The compensated x9 policy runs :func:`_compensated_dot`, a TwoSum K loop
in plain PyTorch on any device (the JAX package's XLA scan; no kernel).

Gradients keep the policy: :class:`_PolicyDot` (the counterpart of the JAX
package's ``_make_dg`` ``custom_vjp``) runs the backward's two products
``da = g . b`` and ``db = a . g`` through :func:`_dot_impl` under the same
policy, so on the card they run kernel 1 too, and under the forward's
numerics config (autograd runs a CUDA backward on a worker thread, which
does not see the forward's ``numerics.use`` scope).  The front-ends take it
only when autograd needs it (grad mode on and an operand that requires
grad); otherwise they call :func:`_dot_impl` directly, so serving pays
nothing for it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import numerics
from .split import MANTISSA_BITS, split


@dataclass(frozen=True)
class PrecisionPolicy:
    """A GEMM execution recipe (see module docstring)."""
    name: str
    dtype: str = "float32"          # storage dtype of the split terms
    n_splits: int = 1               # number of split terms per operand
    scale_bits: int = 0             # residual pre-cast scale shift (Eq. 18)
    keep: tuple = ()                # kept product terms (i, j); () = plain
    upcast_products: bool = False   # f32-upcast operands before each pass
    compensated: bool = False       # TwoSum group accumulation (x9)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def passes(self) -> int:
        return max(1, len(self.keep))

    @property
    def groups(self) -> tuple[int, ...]:
        """Scale groups of the kept products (ascending i+j) — one f32
        accumulator each, in the kernels and in the term expansion."""
        return tuple(sorted({i + j for (i, j) in self.keep}))

    def is_plain(self) -> bool:
        return self.n_splits == 1


def triangular_keep(n_splits: int) -> tuple:
    """Keep every split product whose scale group ``i + j`` is at most
    ``n - 1``: n=2 gives x3, n=3 the headline x6, n=4 x10."""
    return tuple(sorted(((i, j) for i in range(n_splits)
                         for j in range(n_splits) if i + j <= n_splits - 1),
                        key=lambda ij: (ij[0] + ij[1], ij)))


def full_keep(n_splits: int) -> tuple:
    """The full n x n product grid (n=3 gives the 9-pass schedule)."""
    return tuple(sorted(((i, j) for i in range(n_splits)
                         for j in range(n_splits)),
                        key=lambda ij: (ij[0] + ij[1], ij)))


def _tcec(name, dtype, n_splits, keep=None, upcast=False, compensated=False):
    mb = MANTISSA_BITS[getattr(torch, dtype)] + 1  # incl. implicit bit
    keep = triangular_keep(n_splits) if keep is None else tuple(keep)
    return PrecisionPolicy(name=name, dtype=dtype, n_splits=n_splits,
                           scale_bits=mb, keep=keep,
                           upcast_products=upcast, compensated=compensated)


POLICIES: dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy(name="fp32"),
    "bf16": PrecisionPolicy(name="bf16", dtype="bfloat16"),
    "tcec_bf16x3": _tcec("tcec_bf16x3", "bfloat16", 2,
                         [(0, 0), (0, 1), (1, 0)]),
    "tcec_bf16x6": _tcec("tcec_bf16x6", "bfloat16", 3,
                         [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0)]),
    "tcec_bf16x9": _tcec("tcec_bf16x9", "bfloat16", 3, full_keep(3),
                         compensated=True),
    "tcec_bf16x10": _tcec("tcec_bf16x10", "bfloat16", 4),
    "tcec_fp8e4m3x6": _tcec("tcec_fp8e4m3x6", "float8_e4m3fn", 3,
                            upcast=True),
    "tcec_fp8e4m3x10": _tcec("tcec_fp8e4m3x10", "float8_e4m3fn", 4,
                             upcast=True),
    "tcec_fp8e5m2x6": _tcec("tcec_fp8e5m2x6", "float8_e5m2", 3,
                            upcast=True),
    "fp16_markidis": PrecisionPolicy(
        name="fp16_markidis", dtype="float16", n_splits=2, scale_bits=0,
        keep=((0, 0), (0, 1), (1, 0), (1, 1)), upcast_products=True),
    "fp16_halfhalf": PrecisionPolicy(
        name="fp16_halfhalf", dtype="float16", n_splits=2, scale_bits=11,
        keep=((0, 0), (0, 1), (1, 0)), upcast_products=True),
}

def get_policy(p) -> PrecisionPolicy:
    """Resolve a policy name / instance / None (None = the active
    ``numerics.NumericsConfig``'s policy, ``fp32`` by default)."""
    if isinstance(p, PrecisionPolicy):
        return p
    return POLICIES[numerics.active().policy if p is None else p]


# ---------------------------------------------------------------------------
# Term-expanded GEMM (the path for policies the fused kernel declines).
# ---------------------------------------------------------------------------

def _dot_general(a, b, dims):
    """``jax.lax.dot_general`` for f32 operands: output dims are
    (batch, lhs free, rhs free)."""
    (ca, cb), (ba, bb) = dims
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    sa = [None] * a.ndim
    sb = [None] * b.ndim
    for x, y in zip(ba, bb):
        sa[x] = sb[y] = next(letters)
    for x, y in zip(ca, cb):
        sa[x] = sb[y] = next(letters)
    for i in range(a.ndim):
        if sa[i] is None:
            sa[i] = next(letters)
    for i in range(b.ndim):
        if sb[i] is None:
            sb[i] = next(letters)
    out = ([sa[x] for x in ba]
           + [sa[i] for i in range(a.ndim) if i not in ca and i not in ba]
           + [sb[i] for i in range(b.ndim) if i not in cb and i not in bb])
    spec = f"{''.join(sa)},{''.join(sb)}->{''.join(out)}"
    return torch.einsum(spec, a, b)


def _pass_dot(a, b, dims):
    """One split-product GEMM: low-precision terms in, f32 out.  The terms
    are upcast to f32 first; products of two bf16/fp16/fp8 values are exact
    in f32, so this is the tensor-core contract (exact products, f32
    accumulation) as long as TF32 stays off."""
    return _dot_general(a.float(), b.float(), dims)


def _tcec_dot(a, b, policy: PrecisionPolicy, dims):
    """Term-expanded GEMM with per-scale-group f32 accumulators + epilogue."""
    if policy.compensated:
        return _compensated_dot(a, b, policy, dims)[0]
    sa = split(a, policy.tdtype, policy.n_splits, policy.scale_bits)
    sb = split(b, policy.tdtype, policy.n_splits, policy.scale_bits)
    groups: dict[int, torch.Tensor] = {}
    for (i, j) in policy.keep:
        t = _pass_dot(sa[i], sb[j], dims)
        g = i + j
        groups[g] = t if g not in groups else groups[g] + t
    out = None
    for g in sorted(groups, reverse=True):
        term = groups[g] * (2.0 ** (-g * policy.scale_bits))
        out = term if out is None else out + term
    return out


# --- compensated (error-free) accumulation: the f64-emulation end -----------
#
# Products of two bf16 split terms are exact in f32 (at most 16 significand
# bits), so the only inexact step left is summation.  Knuth's TwoSum makes
# each addition error-free: the group accumulators and the scaled epilogue
# fold become unevaluated (head, tail) pairs whose sum carries ~K 2^-48 of
# relative error.  The K reduction is a sequential loop, one k at a time in
# the JAX package's scan order (vectorizing across k would change the sums),
# so the compensated policy is the accuracy end of the family, not the
# throughput one: ``kernels.dispatch`` declines it and it runs as plain
# PyTorch on any device.


def _two_sum(s, x):
    """Error-free transform: s + x = t + e exactly, t = fl(s + x)."""
    t = s + x
    z = t - s
    e = (s - (t - z)) + (x - z)
    return t, e


def _compensated_dot(a, b, policy: PrecisionPolicy, dims):
    """Split-product GEMM with TwoSum-compensated accumulation.

    Returns ``(head, tail)``, the f32 unevaluated sum of the result
    (``head`` is the f32 GEMM up to O(2^-48) terms; ``head + tail``
    evaluated in higher precision is the f64-grade value).  The operands
    are collapsed onto ``(B, M, K) x (B, K, N)`` as for the kernel; each scale
    group runs the K loop over its pairs in ``keep`` order, then the groups
    fold smallest-first, compensated (power-of-two scales are exact).
    """
    from repro_torch.kernels.dispatch import _canonicalize
    at, bt, shape = _canonicalize(a, b, dims)
    if at.ndim == 2:
        at, bt = at[None], bt[None]
    (B, M, K), N = at.shape, bt.shape[-1]
    sa = [t.float() for t in split(at, policy.tdtype, policy.n_splits,
                                   policy.scale_bits)]
    sb = [t.float() for t in split(bt, policy.tdtype, policy.n_splits,
                                   policy.scale_bits)]
    by_group: dict[int, list] = {}
    for (i, j) in policy.keep:
        by_group.setdefault(i + j, []).append((i, j))
    heads, tails = {}, {}
    for g, pairs in sorted(by_group.items()):
        # column k of each A term and row k of each B term, k-major
        ak = [sa[i].permute(2, 0, 1)[:, :, :, None] for (i, _) in pairs]
        bk = [sb[j].permute(1, 0, 2)[:, :, None, :] for (_, j) in pairs]
        s = torch.zeros((B, M, N), dtype=torch.float32, device=a.device)
        c = torch.zeros_like(s)
        for k in range(K):
            for xa, xb in zip(ak, bk):
                s, e = _two_sum(s, xa[k] * xb[k])       # exact product
                c = c + e
        heads[g], tails[g] = s, c
    out_s = torch.zeros((B, M, N), dtype=torch.float32, device=a.device)
    out_c = torch.zeros_like(out_s)
    for g in sorted(by_group, reverse=True):
        inv = 2.0 ** (-g * policy.scale_bits)
        out_s, e = _two_sum(out_s, heads[g] * inv)
        out_c = out_c + e + tails[g] * inv
    head, tail = _two_sum(out_s, out_c)
    return head.reshape(shape), tail.reshape(shape)


def tcec_dot_unevaluated(a, b, policy=None):
    """(M, K) @ (K, N) under a compensated policy, returned as the f32
    unevaluated pair ``(head, tail)``: evaluate ``head + tail`` in f64 to
    see the emulated-f64 accuracy."""
    pol = get_policy(policy)
    if not pol.compensated:
        raise ValueError(f"policy {pol.name!r} is not compensated; only "
                         "compensated policies produce an unevaluated pair")
    return _compensated_dot(a, b, pol, (((1,), (0,)), ((), ())))


def _plain_dot(a, b, policy: PrecisionPolicy, dims):
    if policy.name == "fp32":
        return _dot_general(a.float(), b.float(), dims)
    lp = policy.tdtype
    # values stay lp-rounded; products and accumulation in f32
    return _dot_general(a.to(lp).float(), b.to(lp).float(), dims)


def _dot_impl(a, b, policy: PrecisionPolicy, dims):
    """One policy GEMM: plain policies are one f32 product; compensated
    policies the TwoSum loop; bf16 split policies go to the fused kernel
    through ``kernels.dispatch``; the rest take the term expansion."""
    if policy.is_plain():
        return _plain_dot(a, b, policy, dims)
    if policy.compensated:
        return _compensated_dot(a, b, policy, dims)[0]
    from repro_torch.kernels import dispatch
    out = dispatch.maybe_dispatch(a, b, policy, dims)
    if out is not None:
        return out
    return _tcec_dot(a, b, policy, dims)


def _canonical_dims(nbatch: int, nm: int, nk: int):
    bdims = tuple(range(nbatch))
    ak = tuple(range(nbatch + nm, nbatch + nm + nk))
    bk = tuple(range(nbatch, nbatch + nk))
    return ((ak, bk), (bdims, bdims))


class _PolicyDot(torch.autograd.Function):
    """The canonical core ``(batch..., m..., k...) x (batch..., k..., n...)
    -> (batch..., m..., n...)`` with a policy-preserving backward: both
    gradient products run through :func:`_dot_impl` under the forward's
    policy (a ``bf16`` policy rounds the cotangent to bf16 as well), and
    come back in the operands' dtypes.  The backward runs under the
    forward's numerics config."""

    @staticmethod
    def forward(ctx, at, bt, policy, nbatch, nm, nk, nn):
        ctx.save_for_backward(at, bt)
        ctx.policy, ctx.counts = policy, (nbatch, nm, nk, nn)
        ctx.numerics = numerics.active()
        return _dot_impl(at, bt, policy, _canonical_dims(nbatch, nm, nk))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        at, bt = ctx.saved_tensors
        nbatch, nm, nk, nn = ctx.counts
        bdims = tuple(range(nbatch))
        da = db = None
        with numerics.use(ctx.numerics):
            if ctx.needs_input_grad[0]:
                # g: (batch, m, n); da = g . bt over n -> (batch, m, k)
                gn = tuple(range(nbatch + nm, nbatch + nm + nn))
                btn = tuple(range(nbatch + nk, nbatch + nk + nn))
                da = _dot_impl(g, bt, ctx.policy,
                               ((gn, btn), (bdims, bdims))).to(at.dtype)
            if ctx.needs_input_grad[1]:
                # db = at . g over m -> (batch, k, n)
                m = tuple(range(nbatch, nbatch + nm))
                db = _dot_impl(at, g, ctx.policy,
                               ((m, m), (bdims, bdims))).to(bt.dtype)
        return da, db, None, None, None, None, None


def _core(at, bt, policy: PrecisionPolicy, nbatch, nm, nk, nn):
    """The canonical core: through :class:`_PolicyDot` when autograd needs
    a gradient, else :func:`_dot_impl` alone."""
    if torch.is_grad_enabled() and (at.requires_grad or bt.requires_grad):
        return _PolicyDot.apply(at, bt, policy, nbatch, nm, nk, nn)
    return _dot_impl(at, bt, policy, _canonical_dims(nbatch, nm, nk))


def policy_mm(a, b, policy=None):
    """(M, K) @ (K, N) -> (M, N) f32 under ``policy``."""
    return _core(a, b, get_policy(policy), 0, 1, 1, 1)


def policy_bmm(a, b, policy=None):
    """(B, M, K) @ (B, K, N) -> (B, M, N) f32 under ``policy``."""
    return _core(a, b, get_policy(policy), 1, 1, 1, 1)


# ---------------------------------------------------------------------------
# Binary einsum front-end: transpose -> canonical core -> restore layout.
# ---------------------------------------------------------------------------

class EinsumParseError(ValueError):
    """Malformed / unsupported ``pdot`` subscripts (a typed error, not an
    ``assert``: it must survive ``python -O``)."""


def _parse(subscripts: str):
    spec = subscripts.replace(" ", "")
    if spec.count("->") != 1:
        raise EinsumParseError(
            f"pdot subscripts need exactly one '->': {subscripts!r}")
    lhs, out = spec.split("->")
    if lhs.count(",") != 1:
        raise EinsumParseError(
            f"pdot is a binary einsum (exactly one ','): {subscripts!r}")
    a_sub, b_sub = lhs.split(",")
    for sub in (a_sub, b_sub, out):
        if len(set(sub)) != len(sub):
            raise EinsumParseError(
                f"repeated index in {sub!r} (diagonals/traces are not "
                f"supported): {subscripts!r}")
    a_set, b_set, o_set = set(a_sub), set(b_sub), set(out)
    batch = [c for c in a_sub if c in b_set and c in o_set]
    contract = [c for c in a_sub if c in b_set and c not in o_set]
    m_dims = [c for c in a_sub if c not in b_set]
    n_dims = [c for c in b_sub if c not in a_set]
    if set(out) != set(batch) | set(m_dims) | set(n_dims):
        raise EinsumParseError(
            f"output indices {out!r} must be exactly the batch + uncontracted "
            f"operand indices of {subscripts!r}")
    return a_sub, b_sub, out, batch, contract, m_dims, n_dims


def pdot(subscripts: str, a, b, policy=None):
    """Policy-routed binary einsum (the framework's single GEMM chokepoint).

    Any two-operand einsum with no repeated indices.  Operands are
    transposed into ``(batch..., m..., k...) x (batch..., k..., n...)``; the
    dispatcher then collapses the free dims by reshape, so every product
    of the models reaches the fused kernel (see ``kernels/dispatch.py``).
    """
    policy = get_policy(policy)
    a_sub, b_sub, out, batch, contract, m_dims, n_dims = _parse(subscripts)

    def ax(sub, order):
        return [sub.index(c) for c in order]

    at = a.permute(ax(a_sub, batch + m_dims + contract))
    bt = b.permute(ax(b_sub, batch + contract + n_dims))
    o = _core(at, bt, policy, len(batch), len(m_dims), len(contract),
              len(n_dims))
    cur = batch + m_dims + n_dims
    return o.permute(ax("".join(cur), out))

