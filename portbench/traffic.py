"""The one generator of traffic: reads a mix's data file
(``portbench/traffic/<mix>.json``) and makes its schedule from the seed.

Lengths: every seed gets the same set of sizes in another order.  Requests
come in blocks, each block holds the quantiles ``(i + 1/2) / block`` of the
mix's prompt and output lengths, and the seed shuffles each block (prompts
and outputs apart) and draws the token ids, so the work of a window does
not depend on the seed.  Arrivals of an open loop are a Poisson process:
independent exponential gaps drawn from the seed, never reordered, so
bursts come as they come.

Keys of a serving mix (``"kind": "serve"``):

- ``loop``: ``closed`` (``clients`` callers, each sending its next request
  when the last one finished) or ``open`` (Poisson arrivals at ``rate``
  requests a second);
- ``prompt``, ``output``: distributions of tokens, ``{"dist": "uniform",
  "lo", "hi"}`` or ``{"dist": "lognormal", "median", "sigma", "lo", "hi"}``;
- ``requests``: how many the schedule holds (more than any window uses);
  ``block``: the block size;
- ``first_wave``: ``residual`` gives a closed loop's first request of each
  client the remaining length of a request already under way, so the
  window opens in the steady state;
- ``engine``: ``Engine`` arguments (``max_slots``, ``page_size``,
  ``max_pages_per_slot``, ``num_pages``);
- ``warmup_s``: seconds of the mix's own traffic before the window opens;
- ``check``: how many finished requests the correctness check samples
  (``requests``) and how many served tokens it wants (``tokens``).

A training mix (``"kind": "train"``) gives ``batch``, ``seq``, the optimizer
(``opt``) and the z-loss weight.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from statistics import NormalDist

import numpy as np

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    path = HERE / "traffic" / f"{name}.json"
    with open(path) as f:
        return json.load(f)


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % (2 ** 64), stream])


def quantile(dist: dict, q: float) -> int:
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["lo"], dist["hi"]
        return int(min(hi, lo + int(q * (hi - lo + 1))))
    if kind == "lognormal":
        v = dist["median"] * np.exp(dist["sigma"] * NormalDist().inv_cdf(q))
        return int(min(dist["hi"], max(dist["lo"], round(float(v)))))
    raise ValueError(f"unknown distribution {kind!r}")


def quantiles(dist: dict, n: int) -> np.ndarray:
    return np.asarray([quantile(dist, (i + 0.5) / n) for i in range(n)])


def residual_quantiles(sizes: np.ndarray, n: int) -> np.ndarray:
    """``n`` quantiles of the remaining length of a request caught under
    way (length-biased, then a uniform point within it), at least 1."""
    sizes = np.sort(np.asarray(sizes, np.float64))
    total = sizes.sum()

    def cdf(r):
        return np.minimum(r, sizes).sum() / total

    out = []
    for i in range(n):
        q = (i + 0.5) / n
        lo, hi = 0.0, float(sizes[-1])
        for _ in range(60):
            mid = (lo + hi) / 2
            lo, hi = (mid, hi) if cdf(mid) < q else (lo, mid)
        out.append(max(1, int(round(hi))))
    return np.asarray(out)


@dataclass
class Request:
    prompt: np.ndarray          # token ids
    max_tokens: int
    due: float | None = None    # open loop: seconds after the traffic starts
    client: int | None = None   # closed loop: the first wave's caller


@dataclass
class Schedule:
    mix: dict
    requests: list = field(default_factory=list)


def schedule(mix: dict, seed: int, vocab: int) -> Schedule:
    """The mix's requests in the order they are sent."""
    if mix["kind"] != "serve":
        raise ValueError("schedule() is for serving mixes")
    n, block = mix["requests"], mix["block"]
    r = rng(seed)
    p_q = quantiles(mix["prompt"], block)
    o_q = quantiles(mix["output"], block)
    due = None
    if mix["loop"] == "open":
        due = np.cumsum(rng(seed, 3).exponential(1.0 / mix["rate"], n))
    reqs = []
    for b in range(-(-n // block)):
        p, o = r.permutation(p_q), r.permutation(o_q)
        for i in range(block):
            j = b * block + i
            reqs.append(Request(
                prompt=int(p[i]), max_tokens=int(o[i]),
                due=None if due is None or j >= n else float(due[j])))
    reqs = reqs[:n]
    if mix["loop"] == "closed":
        c = mix["clients"]
        if mix.get("first_wave") == "residual":
            res = r.permutation(residual_quantiles(o_q, c))
            for i in range(c):
                reqs[i].max_tokens = int(res[i])
        for i in range(c):
            reqs[i].client = i
    tok = rng(seed, 1)
    for req in reqs:
        req.prompt = tok.integers(0, vocab, size=req.prompt, dtype=np.int64)
    return Schedule(mix=mix, requests=reqs)


def warm_prompts(mix: dict, seed: int, vocab: int) -> list:
    """Prompts served before the traffic starts: the mix's shortest and
    longest prompt (a prefill on each side of kernel 1's paths where the
    mix spans them), apart from the schedule's own requests."""
    tok = rng(seed, 2)
    return [tok.integers(0, vocab, size=n, dtype=np.int64)
            for n in (mix["prompt"]["lo"], mix["prompt"]["hi"])]


def train_batch(mix: dict, seed: int, step: int, vocab: int, device):
    """Batch ``step`` (1, 2, ...) of a training mix: ``batch`` rows of
    ``seq + 1`` seeded random ids, as ``{"tokens", "labels"}``; every step
    and every row differs."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + step) % (2 ** 63))
    ids = torch.randint(0, vocab, (mix["batch"], mix["seq"] + 1),
                        generator=gen, device=device)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}
