"""The traffic generator: one seed, one schedule; seeds reorder the same
work."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import OPEN_MIX
from portbench import traffic

SERVE_MIXES = ("reasoning", "long_prompt", "open")


def _load(mix):
    return dict(OPEN_MIX) if mix == "open" else traffic.load(mix)


def _key(sched):
    return [(tuple(r.prompt), r.max_tokens, r.due, r.client)
            for r in sched.requests]


@pytest.mark.parametrize("mix", SERVE_MIXES)
def test_schedule_is_the_seeds(mix):
    m = _load(mix)
    a = traffic.schedule(m, 2 ** 31 + 17, 1000)
    b = traffic.schedule(m, 2 ** 31 + 17, 1000)
    c = traffic.schedule(m, 2 ** 31 + 18, 1000)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)


@pytest.mark.parametrize("mix", SERVE_MIXES)
def test_seeds_share_each_blocks_sizes(mix):
    """Every block holds the same prompt and output lengths whatever the
    seed (the first wave of a closed loop aside)."""
    m = _load(mix)
    skip = m.get("clients", 0) if m.get("first_wave") else 0
    block = m["block"]
    for seed in (1, 99, 2 ** 33 + 5):
        s = traffic.schedule(m, seed, 1000)
        for b in range(1, 3):
            reqs = s.requests[b * block:(b + 1) * block]
            assert b * block >= skip
            got = (sorted(len(r.prompt) for r in reqs),
                   sorted(r.max_tokens for r in reqs))
            if seed == 1 and b == 1:
                want = got
            assert got == want


def test_open_loop_arrivals_are_poisson():
    """Gaps are independent exponentials at the mix's rate: their mean is
    1 / rate and their spread as wide, and the arrivals in windows of 8
    mean gaps spread as a Poisson count does (variance ~ mean), so bursts
    and lulls come; a schedule that spaced them evenly would read ~0."""
    m = dict(OPEN_MIX, requests=8192)
    due = np.asarray([r.due for r in traffic.schedule(m, 2 ** 31 + 3,
                                                      100).requests])
    gaps = np.diff(due)
    assert gaps.mean() * m["rate"] == pytest.approx(1.0, rel=0.05)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.08)
    counts = np.histogram(due, np.arange(0.0, due[-1], 8 / m["rate"]))[0]
    assert counts.var() / counts.mean() == pytest.approx(1.0, rel=0.2)


def test_open_loop_rate_is_the_mixs():
    s = traffic.schedule(dict(OPEN_MIX), 5, 1000)
    n = OPEN_MIX["block"] * 4
    assert s.requests[n - 1].due == pytest.approx(n / OPEN_MIX["rate"],
                                                  rel=0.2)


def test_train_batches_differ_by_step_and_row():
    m = traffic.load("train")
    m = dict(m, batch=4, seq=16)
    a = traffic.train_batch(m, 7, 1, 1000, "cpu")
    b = traffic.train_batch(m, 7, 1, 1000, "cpu")
    c = traffic.train_batch(m, 7, 2, 1000, "cpu")
    assert (a["tokens"] == b["tokens"]).all()
    assert not (a["tokens"] == c["tokens"]).all()
    assert len({tuple(r.tolist()) for r in a["tokens"]}) == 4
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all()
