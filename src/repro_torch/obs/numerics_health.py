"""Runtime numerics-health monitors: the paper's underflow-risk indicators,
live per contraction.

The JAX package's probes, in the port.  When the correction scheme's
operand exponents drift low, the residual ``dA = A - A_hi`` (scaled by
``2^scale_bits``, Eq. 18) lands in the narrow format's (sub)normal band and
correction-term products underflow the accumulation (the paper's Figs. 8
and 11).  These probes estimate the indicators on live operands:

  * the fraction of residuals whose scaled narrow cast fully underflows
    (``u``) or lands subnormal (``gu``), the empirical counterpart of
    ``theory.p_underflow`` / ``p_underflow_gradual``;
  * the fraction of sampled correction-term products ``|dA_scaled| |B_hi|``
    below the format's smallest normal;
  * the operand exponent range against :func:`safe_exponent_range`.

Default **off** (``NumericsConfig.monitor`` / ``REPRO_MONITOR``).  When on,
``core.policy`` calls :func:`observe` from ``pdot`` / ``policy_mm`` /
``policy_bmm`` with the forward operands only (the gradient products of
``_PolicyDot`` are not probed), as in JAX.

Where JAX delivers the probe's values through ``jax.debug.callback``, the
port reads its six scalars to the host in one transfer: that is a sync, and
a CUDA graph capture forbids one.  **While the current stream is capturing,
the probe is skipped and counted in ``numerics/monitor/skipped_capture``**,
so the engine's decode graph, captured once and replayed every step, is
never probed; its eager warm-up step is.  The probes compute side values
only (under ``no_grad``), so a contraction's output is bitwise the same
with the monitor on.

XLA on the CPU flushes f32 subnormals to zero; torch does not.  A residual
that is subnormal in f32 reads as zero in JAX before the probe sees it, and
as a (sub)normal-underflow residual here: ``u`` and ``gu`` differ there
(``tests/test_torch_obs.py`` pins the case).  For operands whose residuals
stay normal in f32 both packages read the same fractions, bit for bit.
"""
from __future__ import annotations

import functools
import threading

import torch

from repro_torch.core import theory
from repro_torch.core.split import _cast_rn
from . import metrics

_FMT = dict(theory.FORMATS_BY_DTYPE)          # dtype name -> LPFormat
_MAX_E = {d: theory.MAX_UNBIASED_EXP[f.name]  # max unbiased exponent
          for d, f in _FMT.items()}

#: an observed (gradual-)underflow fraction above this raises the
#: ``numerics/monitor/*_risk`` counters
RISK_THRESHOLD = 0.01

#: per-operand sample size for the product probe (|dA|x|B| outer product
#: over strided subsamples: 64x64 = 4096 products per probed contraction)
PRODUCT_SAMPLE = 64

_SAMPLE_LOCK = threading.Lock()
_sample_every = 1
_calls = 0


def configure(sample_every: int = 1):
    """Probe every Nth monitored contraction."""
    global _sample_every
    _sample_every = max(1, int(sample_every))


@functools.lru_cache(maxsize=None)
def safe_exponent_range(dtype: str, scale_bits: int) -> tuple[int, int]:
    """Unbiased f32 operand exponents for which the residual cast is
    exact: the closed form ``theory.p_underflow_gradual(e, fmt,
    scale_bits)`` is 0.0 at the low end, and the scaled residual cannot
    exceed the format's max exponent at the high end.  May be empty
    (lo > hi) for fp8_e4m3 (``theory.safe_exponent_range``)."""
    return theory.safe_exponent_range(_FMT[dtype], scale_bits,
                                      _MAX_E[dtype])


def _subsample(flat, n: int):
    flat = flat.reshape(-1)
    stride = max(1, flat.numel() // n)
    return flat[::stride][:n]


def _operand_probe(x, policy):
    """Probe values for one operand: underflow fractions of the first
    residual's scaled cast, exponent extrema, and the fraction of nonzero
    elements outside the policy's safe range.  Returns ``(stats,
    scaled_resid_f32, hi_f32)``, ``stats`` a dict of 0-d f32 tensors."""
    fmt = _FMT[policy.dtype]
    lo_e, hi_e = safe_exponent_range(policy.dtype, policy.scale_bits)
    xf = x.detach().float()
    hi = _cast_rn(xf, policy.tdtype).float()
    resid = xf - hi                                  # true correction term
    scaled = _cast_rn(resid * 2.0 ** policy.scale_bits, policy.tdtype).float()
    nz = resid != 0
    n = nz.sum().clamp(min=1)
    tiny = 2.0 ** -(fmt.bias - 1)                    # smallest lp normal
    u = ((scaled == 0) & nz).sum() / n
    gu = ((scaled.abs() < tiny) & nz).sum() / n      # includes full u
    ax = xf.abs()
    nzx = ax > 0
    ex = torch.floor(torch.log2(torch.where(nzx, ax, torch.ones_like(ax))))
    nx = nzx.sum().clamp(min=1)
    oob = (((ex < lo_e) | (ex > hi_e)) & nzx).sum() / nx
    zero = torch.zeros_like(ex)
    stats = {"u": u, "gu": gu, "oob": oob,
             "emin": torch.where(nzx, ex, zero).min(),
             "emax": torch.where(nzx, ex, zero).max()}
    return stats, scaled, hi


def _product_underflow(scaled_resid, other_hi, tiny):
    """Fraction of sampled correction-term products below the format's
    smallest normal: the term that silently vanishes from the corrected
    accumulation (paper Fig. 8)."""
    sa = _subsample(scaled_resid.abs(), PRODUCT_SAMPLE)
    sb = _subsample(other_hi.abs(), PRODUCT_SAMPLE)
    prod = sa[:, None] * sb[None, :]
    nz = prod != 0
    n = nz.sum().clamp(min=1)
    return ((prod < tiny) & nz).sum() / n


def _record(u, gu, oob, pf, emin, emax, *, site, policy):
    """Host-side sink: the ``numerics/monitor/*`` series, JAX's names."""
    m = metrics
    m.counter("numerics/monitor/probes").inc(site=site, policy=policy)
    m.observe("numerics/monitor/underflow_frac", gu,
              buckets=m.FRACTION_BUCKETS, policy=policy)
    m.observe("numerics/monitor/product_underflow_frac", pf,
              buckets=m.FRACTION_BUCKETS, policy=policy)
    m.observe("numerics/monitor/exponent_oob_frac", oob,
              buckets=m.FRACTION_BUCKETS, policy=policy)
    m.gauge("numerics/monitor/exponent_min").set_min(emin, policy=policy)
    m.gauge("numerics/monitor/exponent_max").set_max(emax, policy=policy)
    if gu > RISK_THRESHOLD or oob > 0.0:
        m.counter("numerics/monitor/underflow_risk").inc(site=site,
                                                         policy=policy)
    if pf > RISK_THRESHOLD:
        m.counter("numerics/monitor/product_underflow_risk").inc(
            site=site, policy=policy)


def probe(a, b, policy) -> list[float]:
    """The six probe values of one contraction, read to the host in one
    transfer: ``[u, gu, oob, product_underflow, emin, emax]`` (the worse
    of the two operands for each)."""
    fmt = _FMT[policy.dtype]
    tiny = 2.0 ** -(fmt.bias - 1)
    with torch.no_grad():
        sa, ra, ha = _operand_probe(a, policy)
        sb, rb, hb = _operand_probe(b, policy)
        pf = torch.maximum(_product_underflow(ra, hb, tiny),
                           _product_underflow(rb, ha, tiny))
        vals = torch.stack([
            torch.maximum(sa["u"], sb["u"]), torch.maximum(sa["gu"], sb["gu"]),
            torch.maximum(sa["oob"], sb["oob"]), pf,
            torch.minimum(sa["emin"], sb["emin"]),
            torch.maximum(sa["emax"], sb["emax"])])
    return vals.tolist()


def observe(a, b, policy, *, site: str = "pdot"):
    """Probe one contraction's operands (split policies only) and record
    the values; skipped, and counted, while a CUDA graph is captured."""
    global _calls
    if a.is_cuda and torch.cuda.is_current_stream_capturing():
        metrics.counter("numerics/monitor/skipped_capture").inc(
            site=site, policy=policy.name)
        return
    with _SAMPLE_LOCK:
        _calls += 1
        if (_calls - 1) % _sample_every:
            return
    _record(*probe(a, b, policy), site=site, policy=policy.name)
