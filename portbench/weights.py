"""Weights drawn from the seed, in the port's parameter layout.

The benchmark makes the weights itself, on the device, one draw for each
stacked leaf (every layer's copy of a weight in one tensor), so the same
seed gives the same tensors on every run.  The program and the reference
are handed the same tensors; after the program's state is freed the
reference draws them again from the seed.

The layout is the port's dense family (``models/lm.py``): ``embed``
(padded vocab, d), ``ln_f``, ``dense_blocks`` with a leading layer axis,
``unembed`` (d, padded vocab) unless the embeddings are tied.  A norm's
weight is ``1 + scale``.  :func:`check_layout` holds this layout to the
port's own before a run starts.
"""
from __future__ import annotations

import math

import torch


def padded_vocab(conf: dict) -> int:
    return -(-conf["vocab_size"] // 128) * 128


def layout(conf: dict) -> dict:
    """``{path: (shape, std)}`` of every leaf; ``path`` is ``a/b/c``."""
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


def _seed(seed: int) -> int:
    return seed % (2 ** 63)


def make(conf: dict, seed: int, device) -> dict:
    """The parameter tree from ``seed``: normal values times each leaf's
    std, drawn by a generator on ``device`` one leaf at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed(seed))
    tree: dict = {}
    for path, (shape, std) in layout(conf).items():
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t.normal_(generator=gen).mul_(std)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def leaves(tree: dict, prefix: str = "") -> dict:
    """``{path: tensor}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(leaves(v, p + "/"))
        else:
            out[p] = v
    return out


def check_layout(conf: dict, port_tree: dict) -> None:
    """Raise unless the port's parameter tree (``meta`` tensors from its
    own init) has exactly this layout's paths and shapes."""
    mine = {p: tuple(s) for p, (s, _) in layout(conf).items()}
    theirs = {p: tuple(t.shape) for p, t in leaves(port_tree).items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))
        raise RuntimeError(f"the port's parameter layout differs from the "
                           f"benchmark's: {diff[:6]}")


def n_params(conf: dict) -> int:
    return sum(math.prod(s) for s, _ in layout(conf).values())
