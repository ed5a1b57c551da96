"""Weights drawn from the seed, in the port's parameter layout.

The benchmark makes the weights itself, on the device, one draw for each
stacked leaf (every layer's copy of a weight in one tensor), so the same
seed gives the same tensors on every run.  The program and the reference
are handed the same tensors; after the program's state is freed the
reference draws them again from the seed.

The layout is the port's parameter tree of the configuration's family, as
its module ``portbench/families/<family>.py`` gives it (``layout``; the
first is ``families/dense.py``).  :func:`check_layout` holds it to the
port's own before a run starts.
"""
from __future__ import annotations

import math

import torch

from . import spec


def padded_vocab(conf: dict) -> int:
    return -(-conf["vocab_size"] // 128) * 128


def layout(conf: dict) -> dict:
    """``{path: (shape, std)}`` of every leaf; ``path`` is ``a/b/c``.  The
    configuration's family module gives it (``portbench/families/``)."""
    return spec.family(conf["family"]).layout(conf)


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
