"""The check catches a broken timed path: each fault the cells can have,
planted under a whole run at the port's smoke sizes on the CPU, turns
``correct`` false; and the control, the reference in bf16 in the program's
place, fails the serving cells' limit at a size a test run holds."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import check, harness, spec, weights
from portbench.control import half_batch
from portbench.reference import dense_lm

SERVE = ("qwen2.5-14b.reasoning", "qwen3-0.6b.long_prompt")


def altered_token(engine):
    """A token altered where it is produced: every second accepted token
    is replaced by its successor."""
    accept, n = engine._accept_token, [0]

    def wrong(req, tok):
        n[0] += 1
        if n[0] % 2 == 0:
            tok = (tok + 1) % engine.cfg.vocab_size
        return accept(req, tok)
    engine._accept_token = wrong


def unchanged_state(step):
    """A step that returns its state unchanged."""
    def broken(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return broken


def _run(cell, cfg, fault):
    return harness.run_cell(cell, 2 ** 31 + 9, 2.0, False, "cpu",
                            time.perf_counter(), cfg=cfg, fault=fault)


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_token_is_not_correct(smoke_cell, name):
    cell, cfg = smoke_cell(name)
    assert _run(cell, cfg, None)["correct"]
    r = _run(cell, cfg, altered_token)
    assert not r["correct"]
    assert r["checks"]["served_gap"]["value"] > r["checks"]["served_gap"][
        "limit"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_a_broken_train_step_is_not_correct(smoke_cell, fault):
    cell, cfg = smoke_cell("qwen3-0.6b.train")
    r = _run(cell, cfg, fault)
    assert not r["correct"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_served_limit(seed):
    """At 6 layers of d 512 and 16,384 ids: greedy tokens of the f32
    reference (an exact program) read 0; the bf16 control's first choices
    lie further below the best than every serving cell's limit."""
    conf = dict(spec.cell("qwen3-0.6b.long_prompt").conf)
    conf.update(num_hidden_layers=6, hidden_size=512, vocab_size=16384,
                num_attention_heads=8, num_key_value_heads=4, head_dim=64,
                intermediate_size=1024)
    w = weights.make(conf, seed, torch.device("cpu"))
    g = np.random.default_rng(seed)
    samples = []
    for _ in range(4):
        prompt = g.integers(0, conf["vocab_size"], 32)
        seq, toks = list(prompt), []
        for _ in range(48):
            lg = dense_lm.logits(w, conf, torch.tensor(seq),
                                 torch.tensor([len(seq) - 1]),
                                 bf16_cache_from=len(prompt))
            toks.append(int(lg.argmax()))
            seq.append(toks[-1])
        samples.append((prompt, np.asarray(toks)))
    assert check.served_gap(w, conf, samples, "cpu") == 0.0
    ctl = check.control_gap(w, conf, samples, "cpu")
    for name in SERVE:
        assert ctl > spec.cell(name).limits["served_gap"]
