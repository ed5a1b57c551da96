"""The readers of the program's device-edged spans (``device_us``) on
hand-built runs: each gives the value computed by hand, and ``None`` where
no span carries device edges (a program without them)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import spec

SERVE = ("decode_dev_ms", "decode_gap_ms", "prefill_dev_ms_per_ktok")
TRAIN = ("train_fwd_ms", "train_bwd_ms", "train_opt_ms", "train_gap_ms")


def _span(name, host_start, dev_start, dev_end, **args):
    """A span whose host start is ``host_start`` and whose device edges
    lie at ``dev_start`` / ``dev_end`` on the host's clock (seconds)."""
    args["device_us"] = [(dev_start - host_start) * 1e6,
                         (dev_end - host_start) * 1e6]
    return (name, host_start, host_start + 0.01, args)


def _serve_spans():
    return [
        _span("decode", 1.0, 1.000005, 1.105, batch=32),
        _span("decode", 1.2, 1.20001, 1.30001, batch=32),
        _span("prefill", 1.35, 1.35, 1.43, batch=2, padded=1024),
        _span("decode", 1.5, 1.5, 1.6, batch=32),
        _span("decode", 1.7, 1.70002, 1.80002, batch=32),
        _span("prefill", 1.9, 1.9, 1.99, batch=1, padded=2048),
        # ends after the window: left out
        _span("decode", 9.995, 9.995, 10.1, batch=32),
        _span("prefill", 9.995, 9.995, 10.1, batch=1, padded=4096),
    ]


def _train_spans(micro=2):
    """Three steps on the device: per microbatch a forward of 0.15 s and a
    backward of 0.3 s, an optimizer of 0.1 s, then 0.05 s before the next
    step (the batch; the host)."""
    spans = []
    for k in range(3):
        t = 2.0 + (0.45 * micro + 0.15) * k
        for _ in range(micro):
            spans.append(_span("train.forward", t - 1e-3, t, t + 0.15))
            spans.append(_span("train.backward", t + 0.149, t + 0.15,
                               t + 0.45))
            t += 0.45
        spans.append(_span("train.optimizer", t - 2e-3, t, t + 0.1))
    return spans


def _run(spans):
    return SimpleNamespace(window=(0.5, 10.0), spans=spans)


def _read(name, spans):
    return spec.reader(name)(_run(spans))


def test_decode_and_prefill_readers():
    sp = _serve_spans()
    assert _read("decode_dev_ms", sp) == pytest.approx(
        (104.995 + 100 + 100 + 100) / 4)
    # 1.105 -> 1.20001 and 1.6 -> 1.70002; the pair around the prefill
    # at 1.35 is left out
    assert _read("decode_gap_ms", sp) == pytest.approx((95.01 + 100.02) / 2)
    # (80 + 90) ms over 2 x 1024 + 2048 tokens
    assert _read("prefill_dev_ms_per_ktok", sp) == pytest.approx(
        170 / 4.096)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_readers(micro):
    sp = _train_spans(micro)
    fwd, bwd = 150 * micro, 300 * micro
    step = fwd + bwd + 100 + 50
    want = {"train_fwd_ms": fwd, "train_bwd_ms": bwd, "train_opt_ms": 100,
            "train_gap_ms": 50}
    got = {n: _read(n, sp) for n in TRAIN}
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(step)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_no_device_edges_no_value(name):
    spans = _serve_spans() + _train_spans()
    bare = [(n, s, e, {k: v for k, v in a.items() if k != "device_us"})
            for n, s, e, a in spans]
    assert _read(name, bare) is None
    assert _read(name, []) is None
    assert _read(name, spans) is not None
