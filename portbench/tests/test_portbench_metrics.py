"""The yardstick's arithmetic and the metrics' reaction to a stall."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import OPEN_MIX
from portbench import flops, hw, spec, traffic
from portbench.serve import ServeLoop

# rows of the kernel table in PERF.md (section 6): shape and the
# bound it gives, counted there in bf16 term products (x6: 6 of them a
# product) at 989 TFLOP/s or bytes at 3.35 TB/s
K1_ROWS = [  # (M, N, K, bound_ms, by)
    (1024, 151936, 1024, 1.933, "ops"),      # unembed, 2 x 512 prefill
    (1024, 3072, 1024, 0.0391, "ops"),       # MLP gate, 2 x 512 prefill
    (4, 3072, 1024, 0.0038, "bytes"),        # MLP gate at decode
    (4, 151936, 1024, 0.1865, "bytes"),      # unembed at decode
    (4, 13824, 5120, 0.0846, "bytes"),       # qwen2.5-14b gate at decode
]


@pytest.mark.parametrize("M,N,K,bound_ms,by", K1_ROWS)
def test_kernel1_roofline_counts_2mnk(M, N, K, bound_ms, by):
    f, b = flops.matmul_work(1, M, N, K)
    if by == "ops":
        # the table's term products are 6 x 2 M N K; the yardstick's are 1 x
        assert 6 * f / hw.PEAK_FLOPS * 1e3 == pytest.approx(bound_ms,
                                                             rel=2e-3)
    else:
        assert b / hw.HBM_BYTES_PER_S * 1e3 == pytest.approx(bound_ms,
                                                              rel=2e-2)
        assert hw.roofline_s(f, b) == b / hw.HBM_BYTES_PER_S


def test_kernel2_and_3_rows():
    # kernel 2, 2 x 512 causal, 16/8 heads of 128: the table's x6 ops bound
    f, _ = flops.attention_work(2, 512, 512, 16, 8, 128, 128)
    assert 6 * f / hw.PEAK_FLOPS * 1e3 == pytest.approx(0.0131, rel=1e-2)
    # kernel 3, 4 slots of 520/520/208/208 keys, pages of 16, bf16 pools
    _, b = flops.paged_work([520, 520, 208, 208], 8, 2, 128, 128, 16, 2)
    assert b / hw.HBM_BYTES_PER_S * 1e3 == pytest.approx(0.0018, rel=2e-2)


def test_causal_pairs():
    assert flops.causal_pairs(4, 4, True, 0) == 10
    assert flops.causal_pairs(1, 9, True, 0) == 9
    assert flops.causal_pairs(4, 4, True, 2) == 7
    assert flops.causal_pairs(3, 5, False, 0) == 15


# ----------------------------------------------------- a stall moves them

class FakeEngine:
    """An engine whose step takes ``dt`` on a fake clock (``stall`` more
    on every ``every``-th step) and gives every running request a token;
    ``slots`` requests run at once."""

    def __init__(self, clock, dt=0.01, slots=4, stall=0.0, every=0):
        self.clock, self.dt, self.slots = clock, dt, slots
        self.stall, self.every, self.n = stall, every, 0
        self._requests, self.waiting, self.running = {}, [], []

    def add_request(self, prompt, params):
        rid = len(self._requests)
        self._requests[rid] = SimpleNamespace(out=[], finish_reason=None,
                                              max_tokens=params.max_tokens)
        self.waiting.append(rid)
        return rid

    def step(self):
        self.n += 1
        self.clock.t += self.dt
        if self.every and self.n % self.every == 0:
            self.clock.t += self.stall
        while self.waiting and len(self.running) < self.slots:
            self.running.append(self.waiting.pop(0))
        for rid in list(self.running):
            r = self._requests[rid]
            r.out.append(1)
            if len(r.out) >= r.max_tokens:
                r.finish_reason = "length"
                self.running.remove(rid)


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _metrics(mix, stall):
    clock = Clock()
    eng = FakeEngine(clock, stall=stall, every=5 if stall else 0)
    sched = traffic.schedule(mix, 11, 100)
    loop = ServeLoop(eng, sched, clock=clock, sleep=clock.sleep)
    window, = loop.run(mix["warmup_s"], [20.0])
    run = SimpleNamespace(kind="serve", mix=mix, loop=loop, window=window)
    return {m: spec.reader(m)(run) for m in ("tok_s", "ttft_p95_s",
                                             "itl_p95_ms", "gen_lag_p95_ms")}


def _mix(loop):
    m = dict(OPEN_MIX) if loop == "open" else traffic.load("reasoning")
    m.update(prompt={"dist": "uniform", "lo": 4, "hi": 8},
             output={"dist": "uniform", "lo": 8, "hi": 24}, warmup_s=1.0)
    if loop == "open":
        m["rate"] = 20.0
    else:
        m.update(clients=4, requests=4096)
    return m


@pytest.mark.parametrize("loop", ["open", "closed"])
def test_a_stall_in_the_window_moves_rates_and_tails(loop):
    mix = _mix(loop)
    calm, stalled = _metrics(mix, 0.0), _metrics(mix, 0.05)
    assert stalled["tok_s"] < 0.7 * calm["tok_s"]
    assert stalled["itl_p95_ms"] > 3 * calm["itl_p95_ms"]
    if loop == "open":
        assert stalled["ttft_p95_s"] > 2 * calm["ttft_p95_s"]
        assert stalled["gen_lag_p95_ms"] > calm["gen_lag_p95_ms"]
