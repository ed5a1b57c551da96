"""Per-request sampling: temperature / top-k / top-p / greedy + stop tokens.

Every request carries its own :class:`SamplingParams`.  :func:`sample` draws
one token for every engine slot under that slot's parameters in one
vectorized call (the per-slot knobs are tensors, so a mixed greedy/sampled
batch is one call, on the device where the logits lie).  Greedy rows
(``temperature <= 0``) take the argmax, whatever the other knobs say.

Sampled rows draw by inverse CDF: the token is the first one whose
cumulative masked probability reaches the row's uniform.  Each request's
own ``torch.Generator``, seeded from ``SamplingParams.seed``, draws that
uniform on the host, one a generated token (:func:`draw_uniform`), so a
request's stream depends only on its seed and on how many tokens it has
drawn, never on the batch it shares.  The JAX package draws with
per-request PRNG keys, whose stream cannot be reproduced in PyTorch:
sampled tokens match it only in distribution, greedy tokens match exactly.

Filtering order: temperature scales the logits, top-k masks to the k
highest, top-p keeps the smallest set whose probability mass reaches p
(applied to the top-k-filtered distribution).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

NEG_INF = -2.0e38   # matches models.layers.NEG_INF (finite: no NaN algebra)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode parameters.

    temperature: 0 (or below) means greedy argmax.
    top_k: keep only the k highest-logit tokens (0 = off).
    top_p: nucleus sampling — keep the smallest set of tokens whose
        cumulative probability reaches ``top_p`` (1.0 = off).
    max_tokens: hard cap on generated tokens.
    stop_tokens: generation ends when one is sampled; the stop token is
        not included in the output.
    seed: seed of the request's own generator.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_tokens: int = 16
    stop_tokens: tuple[int, ...] = field(default_factory=tuple)
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def _top_k_mask(logits, k):
    """Mask logits outside each row's k highest.  k: (B,) i32, 0 = off."""
    V = logits.shape[-1]
    kk = torch.clamp(k.long(), 1, V)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.take_along_dim(sorted_desc, (kk - 1)[:, None], dim=-1)
    keep = (k <= 0)[:, None] | (logits >= kth)
    return torch.where(keep, logits, NEG_INF)


def _top_p_mask(logits, p):
    """Nucleus mask: keep the smallest prefix of the sorted distribution
    whose cumulative probability reaches p.  p: (B,) f32, >= 1 = off."""
    probs = torch.softmax(logits.float(), dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    # first sorted index where the cumulative mass reaches p; every token
    # with probability >= that threshold is kept (ties keep extra mass)
    idx = torch.argmax((csum >= p[:, None]).to(torch.int8), dim=-1)
    thr = torch.take_along_dim(sp, idx[:, None], dim=-1)
    keep = (p >= 1.0)[:, None] | (probs >= thr)
    return torch.where(keep, logits, NEG_INF)


def _inverse_cdf(masked, uniforms):
    """First index whose cumulative probability reaches the row's uniform.
    The sum runs in f64, so a vocabulary of 10^5 tokens keeps every token's
    share; a uniform past the sum's end (rounding) takes the last kept
    token, which is also the first index where the sum reaches its end."""
    probs = torch.softmax(masked.float(), dim=-1)
    cdf = torch.cumsum(probs, dim=-1, dtype=torch.float64)
    u = uniforms.to(torch.float64)[:, None]
    tok = torch.searchsorted(cdf, u)
    last = torch.searchsorted(cdf, cdf[:, -1:].contiguous())
    return torch.minimum(tok, last)[:, 0]


def sample(logits, temperature, top_k, top_p, uniforms):
    """Draw one token per row under per-row parameters.

    logits: (B, V) f32; temperature/top_p: (B,) f32; top_k: (B,) i32;
    uniforms: (B,) in (0, 1], one a row (greedy rows ignore theirs).
    Returns (B,) int64 on the logits' device.
    """
    greedy_tok = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    masked = _top_p_mask(_top_k_mask(scaled, top_k), top_p)
    drawn = _inverse_cdf(masked, uniforms)
    return torch.where(temperature <= 0.0, greedy_tok, drawn)


def new_generator(params: SamplingParams) -> torch.Generator:
    return torch.Generator().manual_seed(int(params.seed))


def draw_uniform(params: SamplingParams, gen: torch.Generator) -> float:
    """The uniform of a request's next token, in (0, 1]: one draw from its
    generator when it samples, none (and 1.0) when it is greedy."""
    if params.greedy:
        return 1.0
    return 1.0 - float(torch.rand((), generator=gen, dtype=torch.float64))


def sample_one(logits, params: SamplingParams, gen: torch.Generator) -> int:
    """Single-row convenience over :func:`sample` (prefill-time draw), on
    the row's device."""
    dev = logits.device
    out = sample(logits[None].float(),
                 torch.tensor([params.temperature], dtype=torch.float32,
                              device=dev),
                 torch.tensor([params.top_k], dtype=torch.int32, device=dev),
                 torch.tensor([params.top_p], dtype=torch.float32,
                              device=dev),
                 torch.tensor([draw_uniform(params, gen)],
                              dtype=torch.float64, device=dev))
    return int(out[0])
