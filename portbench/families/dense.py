"""The dense family: the port's ``models/lm.py`` without experts (Qwen2,
Qwen3 and their kind), with its plain reference ``reference/dense_lm.py``
and ``reference/train.py``.  What a family's module exports is listed in
``portbench/spec.py::family``."""
from __future__ import annotations

import dataclasses

from portbench.reference import dense_lm, train
from portbench.weights import padded_vocab

# the port's configuration field of each key of a configuration file
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "vocab_size": "vocab_size",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
               "intermediate_size": "d_ff", "rope_theta": "rope_theta",
               "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings",
               "attention_bias": "qkv_bias", "qk_norm": "qk_norm",
               "hidden_act": "activation", "policy": "policy"}

# keys that set no size, which the run takes from the file where the
# port's registry holds another value
RUN_AS_FILE = ("rms_norm_eps",)


def port_config(conf: dict, cfg):
    """``cfg`` held to the file: the keys of ``RUN_AS_FILE`` are set from
    the file, any other field that differs stops the run."""
    cfg = dataclasses.replace(cfg, **{PORT_FIELDS[k]: conf[k]
                                      for k in RUN_AS_FILE})
    bad = {k: (conf[k], getattr(cfg, f)) for k, f in PORT_FIELDS.items()
           if conf[k] != getattr(cfg, f)}
    if bad:
        raise RuntimeError(f"{cfg.name}: the port's configuration differs "
                           f"from the benchmark's file: {bad}")
    return cfg


def layout(conf: dict) -> dict:
    """``embed`` (padded vocab, d), ``ln_f``, ``dense_blocks`` with a
    leading layer axis, ``unembed`` (d, padded vocab) unless the
    embeddings are tied.  A norm's weight is ``1 + scale``."""
    L, D = conf["num_hidden_layers"], conf["hidden_size"]
    H, Hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, F, V = conf["head_dim"], conf["intermediate_size"], padded_vocab(conf)
    b = "dense_blocks"
    out = {"embed": ((V, D), 0.02), "ln_f": ((D,), 0.1),
           f"{b}/ln1": ((L, D), 0.1), f"{b}/ln2": ((L, D), 0.1),
           f"{b}/attn/wq": ((L, D, H, hd), D ** -0.5),
           f"{b}/attn/wk": ((L, D, Hkv, hd), D ** -0.5),
           f"{b}/attn/wv": ((L, D, Hkv, hd), D ** -0.5),
           f"{b}/attn/wo": ((L, H, hd, D), (H * hd) ** -0.5)}
    if conf["attention_bias"]:
        out.update({f"{b}/attn/bq": ((L, H, hd), 0.1),
                    f"{b}/attn/bk": ((L, Hkv, hd), 0.1),
                    f"{b}/attn/bv": ((L, Hkv, hd), 0.1)})
    if conf["qk_norm"]:
        out.update({f"{b}/attn/q_norm": ((L, hd), 0.1),
                    f"{b}/attn/k_norm": ((L, hd), 0.1)})
    out.update({f"{b}/mlp/w_gate": ((L, D, F), D ** -0.5),
                f"{b}/mlp/w_up": ((L, D, F), D ** -0.5),
                f"{b}/mlp/w_down": ((L, F, D), F ** -0.5)})
    if not conf["tie_word_embeddings"]:
        out["unembed"] = ((D, V), D ** -0.5)
    return out


logits = dense_lm.logits
train_steps = train.steps


def matmul_params(conf: dict) -> int:
    """Weights one token multiplies by in the layer stack (no embedding,
    no unembedding)."""
    D, H, Hkv = (conf["hidden_size"], conf["num_attention_heads"],
                 conf["num_key_value_heads"])
    hd, F = conf["head_dim"], conf["intermediate_size"]
    per_layer = D * H * hd * 2 + D * Hkv * hd * 2 + 3 * D * F
    return conf["num_hidden_layers"] * per_layer


def attn_flops_per_pair(conf: dict) -> float:
    """Forward attention FLOPs of one (query, key) pair over every layer
    and head."""
    return (2.0 * conf["num_hidden_layers"] * conf["num_attention_heads"]
            * 2 * conf["head_dim"])


def logit_params(conf: dict) -> int:
    """Weights of one logit row: the unembedding over the vocabulary."""
    return conf["hidden_size"] * conf["vocab_size"]
