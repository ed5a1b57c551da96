"""Per-request sampling: temperature / top-k / top-p / greedy + stop tokens.

Every request carries its own :class:`SamplingParams`.  Greedy rows
(``temperature <= 0``) take the argmax.  Sampled rows draw from the
request's own ``torch.Generator``, seeded from ``SamplingParams.seed``, so a
request's stream does not depend on the batch it shares.  The JAX
package's PRNG stream cannot be reproduced in PyTorch: sampled tokens match
it only in distribution, greedy tokens match exactly.

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


def _top_k_mask(logits, k: int):
    """Mask a row's logits outside its k highest (k <= 0 = off)."""
    if k <= 0:
        return logits
    kth = torch.topk(logits, min(k, logits.shape[-1])).values[-1]
    return torch.where(logits >= kth, logits, NEG_INF)


def _top_p_mask(logits, p: float):
    """Nucleus mask of one row (p >= 1 = off): every token whose
    probability reaches the threshold of the first sorted index where the
    cumulative mass reaches p is kept (ties keep extra mass)."""
    if p >= 1.0:
        return logits
    probs = torch.softmax(logits.float(), dim=-1)
    sp = torch.sort(probs, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    idx = int(torch.argmax((csum >= p).to(torch.int8)))
    return torch.where(probs >= sp[idx], logits, NEG_INF)


def new_generator(params: SamplingParams) -> torch.Generator:
    return torch.Generator().manual_seed(int(params.seed))


def sample_one(logits, params: SamplingParams, gen: torch.Generator) -> int:
    """Draw one token from a (V,) row under ``params``."""
    if params.greedy:
        return int(torch.argmax(logits))
    row = logits.float().cpu() / max(params.temperature, 1e-6)
    row = _top_p_mask(_top_k_mask(row, params.top_k), params.top_p)
    probs = torch.softmax(row, dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))
