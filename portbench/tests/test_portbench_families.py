"""The family modules (``portbench/families/<family>.py``): the dense one
gives the values the harness gave before it held them itself, another
family is one new module, and a run stops before any weights are drawn
where the family's module or a piece of it is missing, or where the file's
family is not the port's."""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import time

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench import flops, harness, spec, weights

# small widths at which the weights and the reference's logits are hashed;
# each file keeps its own switches (QKV bias, qk-norm, tied embeddings)
SMALL = dict(num_hidden_layers=2, hidden_size=64, vocab_size=300,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             intermediate_size=96)
SEEDS = (5, 2 ** 31 + 11)
LENGTHS = (1, 1000, 6144)

# frozen from the harness as it was when the dense family's pieces lived in
# harness.py, weights.py and flops.py: sha256 (first 16 hex digits) of the
# full-size layout, of the small weights and of the small reference
# logits; prefill, decode and train (batch 8) FLOPs at each length; the
# port's configuration fields that the file holds
FROZEN = {
    "qwen2.5-14b": {
        "layout": "def50e5df2eb376e", "n_params": 14770033664,
        "weights": ["0114e8879e35583a", "f03f98d5efba43df"],
        "logits": ["bda82a39e05513ba", "f10977e6e4459536"],
        "flops": [[27982233600.0, 27982233600.0, 671573606400.0],
                  [26917683855360.0, 28964290560.0, 683358289920000.0],
                  [180908599541760.0, 34021048320.0, 4571377969397760.0]],
        "port": {"n_layers": 48, "d_model": 5120, "vocab_size": 152064,
                 "n_heads": 40, "n_kv_heads": 8, "head_dim": 128,
                 "d_ff": 13824, "rope_theta": 1000000.0, "norm_eps": 1e-05,
                 "tie_embeddings": False, "qkv_bias": True, "qk_norm": False,
                 "activation": "silu", "policy": "tcec_bf16x6",
                 "family": "dense", "name": "qwen2.5-14b"},
    },
    "qwen3-0.6b": {
        "layout": "2e24f281ee30687c", "n_params": 596049920,
        "weights": ["2e462f0ce8da70d8", "835951f2d5309cf3"],
        "logits": ["390b28573563c5f7", "59a781493dff0d56"],
        "flops": [[1192198144.0, 1192198144.0, 28612755456.0],
                  [995917692928.0, 1421344768.0, 31362514944000.0],
                  [9742001635328.0, 2601254912.0, 279683706912768.0]],
        "port": {"n_layers": 28, "d_model": 1024, "vocab_size": 151936,
                 "n_heads": 16, "n_kv_heads": 8, "head_dim": 128,
                 "d_ff": 3072, "rope_theta": 1000000.0, "norm_eps": 1e-06,
                 "tie_embeddings": True, "qkv_bias": False, "qk_norm": True,
                 "activation": "silu", "policy": "tcec_bf16x6",
                 "family": "dense", "name": "qwen3-0.6b"},
    },
}


def _conf(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _hash(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_the_dense_module_gives_the_frozen_values(name):
    want, conf = FROZEN[name], _conf(name)
    assert conf["family"] == "dense"
    lay = weights.layout(conf)
    assert hashlib.sha256(json.dumps(
        [[p, list(s), sd] for p, (s, sd) in lay.items()]).encode()
    ).hexdigest()[:16] == want["layout"]
    assert weights.n_params(conf) == want["n_params"]
    small = dict(conf, **SMALL)
    fam = spec.family("dense")
    for seed, w_hash, l_hash in zip(SEEDS, want["weights"], want["logits"]):
        w = weights.make(small, seed, torch.device("cpu"))
        assert _hash(weights.leaves(w).values()) == w_hash
        toks = torch.as_tensor(np.random.default_rng(seed % 2 ** 32)
                               .integers(0, SMALL["vocab_size"], 24))
        lg = fam.logits(w, small, toks, torch.arange(8, 24),
                        bf16_cache_from=16)
        assert _hash([lg]) == l_hash
    got = [[flops.prefill_flops(conf, n), flops.decode_flops(conf, n),
            flops.train_flops(conf, 8, n)] for n in LENGTHS]
    assert got == want["flops"]
    cfg = harness.port_config(conf)
    assert {f: getattr(cfg, f) for f in want["port"]} == want["port"]


STAND_IN = "from portbench.families.dense import *  # noqa: F401,F403\n"


def _as_family(monkeypatch, tmp_path, family: str, text: str):
    """``family`` as a module in ``tmp_path``, where the harness looks for
    families, and a family of the port served by its dense model."""
    from repro_torch.models import api, lm
    (tmp_path / f"{family}.py").write_text(text)
    monkeypatch.setattr(spec, "FAMILIES", tmp_path)
    monkeypatch.setitem(api._FAMILIES, family, lm)
    ported = lm._check_ported
    monkeypatch.setattr(lm, "_check_ported", lambda cfg: ported(
        dataclasses.replace(cfg, family="dense")))


def _run(cell, cfg, seed=2 ** 31 + 13):
    return harness.run_cell(cell, seed, 1.5, False, "cpu",
                            time.perf_counter(), cfg=cfg)


@pytest.mark.parametrize("name", ["qwen3-0.6b.long_prompt",
                                  "qwen3-0.6b.train"])
def test_a_new_family_is_one_new_module(smoke_cell, monkeypatch, tmp_path,
                                        name):
    """A stand-in module that re-exports the dense one under another name
    runs a cell as the dense one does: correct, the same metrics, and in
    training (whose first three steps repeat exactly) the same readings."""
    cell, cfg = smoke_cell(name)
    dense = _run(cell, cfg)
    dense_flops = flops.train_flops(cell.conf, 8, 1024)
    _as_family(monkeypatch, tmp_path, "dense_alias", STAND_IN)
    alias_cell = copy.deepcopy(cell)
    alias_cell.conf["family"] = "dense_alias"
    alias = _run(alias_cell, dataclasses.replace(cfg, family="dense_alias"))
    assert dense["correct"] and alias["correct"]
    assert set(alias["metrics"]) == set(dense["metrics"])
    assert set(alias["checks"]) == set(dense["checks"])
    if cell.mix["kind"] == "train":
        assert alias["checks"] == dense["checks"]
        assert alias["info"]["reference"] == dense["info"]["reference"]
    assert flops.train_flops(alias_cell.conf, 8, 1024) == dense_flops


def _no_weights(monkeypatch):
    def make(*a, **k):
        raise AssertionError("weights were drawn")
    monkeypatch.setattr(weights, "make", make)


@pytest.mark.parametrize("name", ["qwen3-0.6b.long_prompt",
                                  "qwen3-0.6b.train"])
def test_a_family_without_a_module_stops_before_the_weights(
        smoke_cell, monkeypatch, tmp_path, name):
    """(In a folder of families without one for ``moe``, so that the test
    holds once the benchmark has one.)"""
    from repro_torch.configs import get_smoke_config
    cell, _ = smoke_cell(name)
    cell.conf.update(family="moe", registry="deepseek-v3-671b")
    monkeypatch.setattr(spec, "FAMILIES", tmp_path)
    _no_weights(monkeypatch)
    with pytest.raises(RuntimeError, match="portbench/families/moe.py"):
        _run(cell, get_smoke_config("deepseek-v3-671b"))


def test_a_file_of_another_family_than_the_port_stops(smoke_cell,
                                                      monkeypatch):
    cell, cfg = smoke_cell("qwen3-0.6b.long_prompt")
    cell.conf["family"] = "moe"
    _no_weights(monkeypatch)
    with pytest.raises(RuntimeError, match="the port's family 'dense'"):
        _run(cell, cfg)
    with pytest.raises(RuntimeError, match="the port's family 'dense'"):
        harness.port_config(dict(_conf("qwen3-0.6b"), family="moe"))


def test_a_family_without_a_training_reference_has_no_train_cell(
        smoke_cell, monkeypatch, tmp_path):
    cell, cfg = smoke_cell("qwen3-0.6b.train")
    _as_family(monkeypatch, tmp_path, "no_train",
               STAND_IN + "del train_steps\n")
    cell.conf["family"] = "no_train"
    _no_weights(monkeypatch)
    with pytest.raises(RuntimeError, match="no_train.py has no train_steps"):
        _run(cell, dataclasses.replace(cfg, family="no_train"))
