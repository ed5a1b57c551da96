"""Paper theory, computed exactly: mantissa-length expectation (Tables 1-2)
and underflow probabilities (Eqs. 13-17), generalized to any split dtype.

The mantissa analysis enumerates *all* 2^23 FP32 mantissas (vectorized
integer arithmetic — no sampling error) and simulates the two-term split
``v ~= v_lp + dv_lp`` at a given low-precision width and rounding mode,
reporting the expected number of kept mantissa bits.  The paper's numbers
(RN: 22.75, RZ: 22.5 of 23 explicit bits for FP16 splits) fall out exactly.

The underflow analysis evaluates the closed forms P_u(e_v) / P_{u+gu}(e_v)
for arbitrary (mantissa length, exponent bias) so it covers both the paper's
FP16 Tensor Cores and bf16 tensor-core targets.

A copy of the JAX package's ``core/theory.py``: the closed forms are the
same numpy code, bit for bit.  What reads a policy reads this package's
:class:`~repro_torch.core.policy.PrecisionPolicy`, and the two functions
that cast to a narrow format (:func:`measure_underflow`,
:func:`representable_relative_error`) cast through torch's dtypes, fp8
e4m3 through ``core/split.py::_cast_rn`` (JAX's NaN on overflow, where
torch's own cast saturates).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

F32_MANT = 23  # explicit bits


@dataclass(frozen=True)
class LPFormat:
    name: str
    mant: int   # explicit mantissa bits
    bias: int   # exponent bias

FP16 = LPFormat("fp16", 10, 15)
BF16 = LPFormat("bf16", 7, 127)
TF32 = LPFormat("tf32", 10, 127)
FP8E4M3 = LPFormat("fp8_e4m3", 3, 7)     # OCP e4m3fn: finite-only, max 448
FP8E5M2 = LPFormat("fp8_e5m2", 2, 15)

#: max unbiased exponent per format (e4m3fn spends the top code on 448, not
#: inf, hence 8; the rest follow IEEE ``bias`` symmetry)
MAX_UNBIASED_EXP = {"fp16": 15, "bf16": 127, "tf32": 127,
                    "fp8_e4m3": 8, "fp8_e5m2": 15}

#: policy dtype-name -> analysis format, for policy-driven lookups
FORMATS_BY_DTYPE = {"float16": FP16, "bfloat16": BF16,
                    "float8_e4m3fn": FP8E4M3, "float8_e5m2": FP8E5M2}


def _round_int(v: np.ndarray, q: int, mode: str) -> np.ndarray:
    """Round integers ``v`` to multiples of ``q`` (q = power of two)."""
    if mode == "rz":
        return np.sign(v) * (np.abs(v) // q) * q
    # RN ties-to-even on the quotient
    quot = np.abs(v) / q
    t = np.rint(quot)  # ties-to-even for half-integers
    return np.sign(v) * t.astype(np.int64) * q


def split_kept_bits(lp_mant: int = 10, mode: str = "rn") -> np.ndarray:
    """Bits of FP32 mantissa lost by a 2-term split, for every mantissa.

    Models the mantissa of v as the 24-bit integer ``M = 2^23 + m`` (implicit
    bit set).  v_lp keeps the top ``lp_mant+1`` bits (quantum q0 = 2^(23-lp_mant-1+1)
    ... computed from M's width), the residual is requantized to an
    (lp_mant+1)-bit window at its own leading bit — floating-point, so the
    quantum depends on the residual's magnitude.  Returns, per mantissa value,
    the number of bits needed to store the final error (0 = exact).
    """
    width = lp_mant + 1                       # incl. implicit bit
    M = (np.arange(2 ** F32_MANT, dtype=np.int64) + (1 << F32_MANT))
    q0 = 1 << (F32_MANT + 1 - width)          # hi-part quantum
    hi = _round_int(M, q0, mode)
    r = M - hi
    # residual quantum: keep ``width`` bits at the residual's own leading bit
    absr = np.abs(r)
    lead = np.zeros_like(absr)
    nz = absr > 0
    lead[nz] = np.floor(np.log2(absr[nz])).astype(np.int64)
    q1 = np.where(lead + 1 > width, 1 << np.maximum(lead + 1 - width, 0), 1)
    lo = _round_int(r, q1, mode)
    err = np.abs(M - (hi + lo))
    bits = np.zeros_like(err)
    nz = err > 0
    bits[nz] = np.floor(np.log2(err[nz])).astype(np.int64) + 1
    return bits


def expected_mantissa_length(lp_mant: int = 10, mode: str = "rn") -> float:
    """E[kept mantissa length] of the 2-term split (Table 1/2 bottom line)."""
    bits_lost = split_kept_bits(lp_mant, mode)
    return F32_MANT - float(bits_lost.mean())


def p_l0(n: int, lp_mant: int = 10) -> float:
    """Paper Eq. (14): distribution of l0 = run of zeros below the hi part."""
    lmax = F32_MANT - lp_mant
    if n < 0 or n > lmax:
        return 0.0
    if n == lmax:
        return 0.5 ** lmax
    return 0.5 ** (n + 1)


def p_underflow_gradual(e_v: int, fmt: LPFormat = FP16,
                        scale_bits: int = 0) -> float:
    """Eq. (15): P[underflow or gradual underflow] in the residual cast.

    ``e_v`` is the unbiased exponent of v_f32; ``scale_bits`` models the
    paper's Eq. (18) pre-cast scaling (adds to the residual exponent).
    """
    lmax = F32_MANT - fmt.mant
    lo = (e_v + scale_bits) - fmt.mant + fmt.bias - 2
    return sum(p_l0(l, fmt.mant) for l in range(max(lo + 1, 0), lmax + 1))


def p_underflow(e_v: int, fmt: LPFormat = FP16, scale_bits: int = 0) -> float:
    """Eq. (17): P[full underflow] in the residual cast."""
    lmax = F32_MANT - fmt.mant
    lo = (e_v + scale_bits) + fmt.bias - 2
    return sum(p_l0(l, fmt.mant) for l in range(max(lo + 1, 0), lmax + 1))


def p_underflow_term(e_v: int, fmt: LPFormat = FP16, scale_bits: int = 0,
                     term: int = 1) -> float:
    """Eq. (15) generalized to the ``i``-th term of an n-way split.

    Term ``i`` stores the ``i``-th residual, whose leading bit sits
    ``i * (mant+1)`` below ``e_v`` before the ``i * scale_bits`` pre-cast
    scaling — so its effective exponent is ``e_v + i*(scale_bits-(mant+1))``
    entering the same one-step closed form.  With the production convention
    ``scale_bits = mant + 1`` every term sees the same underflow
    probability as the first (the scaling walks the residual back up to
    ``e_v`` each stage)."""
    if term < 1:
        return 0.0
    drift = (term - 1) * (scale_bits - (fmt.mant + 1))
    return p_underflow_gradual(e_v + drift, fmt, scale_bits)


def safe_exponent_range(fmt: LPFormat, scale_bits: int,
                        max_e: int | None = None) -> tuple[int, int]:
    """Band of unbiased f32 operand exponents where the split is exact-safe:
    the closed-form P_{u+gu} (Eq. 15) is 0.0 at the low end and the scaled
    residual cannot overflow ``max_e`` at the high end.

    May be *empty* (lo > hi): fp8_e4m3's 4-bit exponent cannot hold a
    zero-underflow band at any operand exponent — every fp8_e4m3 split
    carries the gradual-underflow floor that
    :func:`split_residual_bound` accounts for."""
    if max_e is None:
        max_e = MAX_UNBIASED_EXP[fmt.name]
    lo = next((e for e in range(-148, 129)
               if p_underflow_gradual(e, fmt, scale_bits) == 0.0), 129)
    hi = max_e + fmt.mant + 1 - scale_bits
    return lo, hi


def representable_range(fmt: LPFormat, max_e: int | None = None
                        ) -> tuple[int, int]:
    """Unbiased operand exponents the *first* split term can store at all
    (normal range, no overflow) — the practical band for fp8 policies whose
    strict zero-underflow band is empty."""
    if max_e is None:
        max_e = MAX_UNBIASED_EXP[fmt.name]
    return -(fmt.bias - 1), max_e - 1


# ------------------------------------------------------------------ bounds
#
# Closed-form relative-error budget of an n-term split GEMM, the contract
# the policy-conformance battery holds every POLICIES entry to.  All terms
# are relative to sum_k |a_ik||b_kj| (elementwise), then converted to the
# Eq. (7) Frobenius relative residual by the sqrt(K) concentration factor
# for the zero-mean generators of core/matgen (a factor-4 safety margin is
# applied on top; bounds are upper bounds, not estimates).


def split_residual_bound(fmt: LPFormat, n_splits: int, scale_bits: int,
                         e_lo: int = 0, e_hi: int = 0) -> float:
    """Per-operand relative representation error after an n-way RN split.

    Two regimes, whichever floor is higher:
      * capture width — each RN cast halves the residual ``mant+1`` times:
        ``2^(-n (mant+1))``;
      * subnormal quantum — when the band ``[e_lo, e_hi]`` dips below the
        format's zero-underflow range, stage ``n-1``'s residual is captured
        at the subnormal quantum ``2^(1 - bias - mant)`` (descaled by its
        ``(n-1) * scale_bits`` shift), relative to the smallest operand.
    """
    w = fmt.mant + 1
    cap = 2.0 ** (-n_splits * w)
    lo_safe, _ = safe_exponent_range(fmt, scale_bits)
    if e_lo >= lo_safe:
        return cap
    quantum = 2.0 ** (1 - fmt.bias - fmt.mant
                      - (n_splits - 1) * scale_bits - e_lo)
    return max(cap, quantum)


def dropped_product_bound(keep, n_splits: int, fmt: LPFormat) -> float:
    """Relative weight of the split products the schedule drops: term ``i``
    carries at most ``2^(-i (mant+1))`` of the operand, so product ``(i, j)``
    contributes at most ``2^(-(i+j)(mant+1))`` of ``|a||b|``."""
    w = fmt.mant + 1
    kept = set(keep)
    return sum(2.0 ** (-(i + j) * w)
               for i in range(n_splits) for j in range(n_splits)
               if (i, j) not in kept)


def policy_error_bound(policy, k_depth: int,
                       e_lo: int = 0, e_hi: int = 0) -> float:
    """Upper bound on the Eq. (7) relative residual of one policy GEMM over
    a K-deep contraction with operand exponents inside ``[e_lo, e_hi]``.

    ``policy`` is a PrecisionPolicy (or name).  Budget = representation
    (both operands) + dropped cross products + accumulation:
      * plain f32: f32 dot rounding only;
      * plain lp: one RN cast per operand;
      * split, plain accumulation: per-scale-group f32 accumulators add
        ``~sqrt(K) 2^-24`` (RMS over the Frobenius norm; worst case would
        be K u, but Eq. (7) aggregates thousands of outputs);
      * split, compensated: TwoSum leaves ``K^2 2^-48`` plus the final
        f32 rounding of the folded head.
    """
    import math
    import torch
    from . import policy as P
    pol = P.get_policy(policy) if not hasattr(policy, "keep") else policy
    u32 = 2.0 ** -24
    acc_plain = 4.0 * math.sqrt(max(k_depth, 1)) * u32
    if pol.is_plain():
        if pol.name == "fp32" or pol.tdtype == torch.float32:
            return acc_plain + 4.0 * u32
        fmt = FORMATS_BY_DTYPE[pol.dtype]
        return 4.0 * 2.0 * 2.0 ** -(fmt.mant + 1) + acc_plain
    fmt = FORMATS_BY_DTYPE[pol.dtype]
    rep = split_residual_bound(fmt, pol.n_splits, pol.scale_bits, e_lo, e_hi)
    drop = dropped_product_bound(pol.keep, pol.n_splits, fmt)
    if pol.compensated:
        acc = max(k_depth, 1) ** 2 * 2.0 ** -48 + 2.0 * u32
    else:
        acc = acc_plain
    return 4.0 * (2.0 * rep + drop) + acc


def measure_underflow(e_v: int, fmt: LPFormat = FP16, scale_bits: int = 0,
                      n: int = 200_000, seed: int = 0) -> tuple[float, float]:
    """Monte-Carlo counterpart of Eqs. (15)/(17) using real IEEE casts.

    Draws v with fixed exponent ``e_v`` and uniform mantissa, performs the
    paper's split with RZ in the hi cast (the assumption under which the
    closed forms are derived), and counts residuals that land at zero
    (underflow) or in the subnormal band (gradual underflow).
    Returns (P_u, P_{u+gu}).
    """
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2 ** F32_MANT, size=n, dtype=np.int64)
    v = ((1 << F32_MANT) + m).astype(np.float64) * 2.0 ** (e_v - F32_MANT)
    v = v.astype(np.float32)
    # hi part with RZ (theory assumption): truncate to fmt.mant+1 bits
    width = fmt.mant + 1
    mm, ee = np.frexp(v.astype(np.float64))
    hi = np.ldexp(np.trunc(mm * 2.0 ** width), ee - width).astype(np.float32)
    resid = ((v.astype(np.float64) - hi) * 2.0 ** scale_bits).astype(np.float32)
    dlp = _lp_roundtrip(resid, fmt.name)
    exact_zero = resid == 0
    tiny = 2.0 ** (-(fmt.bias - 1))          # smallest normal in lp
    u = (dlp == 0) & ~exact_zero
    gu = (np.abs(dlp) < tiny) & ~exact_zero
    return float(u.mean()), float(gu.mean())


def _lp_roundtrip(x: np.ndarray, fmt_name: str) -> np.ndarray:
    """f32 ``x`` cast RN to the narrow format and back to f32 (numpy)."""
    import torch
    from .split import _cast_rn
    dtype = {"fp16": torch.float16, "bf16": torch.bfloat16,
             "fp8_e4m3": torch.float8_e4m3fn,
             "fp8_e5m2": torch.float8_e5m2}[fmt_name]
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return _cast_rn(t, dtype).float().numpy()


def representable_relative_error(values: np.ndarray,
                                 policy_name: str) -> np.ndarray:
    """Fig. 9: relative representation error of each policy over a value
    grid."""
    import torch
    from . import policy as P
    from .split import reconstruct, split
    v = np.asarray(values, dtype=np.float32)
    pol = P.get_policy(policy_name) if policy_name in P.POLICIES else None
    if policy_name == "fp32":
        rec = v.astype(np.float32)
    elif policy_name in ("fp16", "bf16"):
        rec = _lp_roundtrip(v, policy_name).astype(np.float64)
    else:
        parts = split(torch.from_numpy(v), pol.tdtype, pol.n_splits,
                      pol.scale_bits)
        rec = reconstruct(parts, pol.scale_bits).double().numpy()
    ref = v.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(rec - ref) / np.abs(ref)
    return np.where(ref == 0, 0.0, rel)
