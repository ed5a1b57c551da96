"""Parameter helpers: seeded initializers on a ``torch.Generator`` and the
nested-dict parameter trees the models use (stacked per-layer leaves with a
leading layer axis, the JAX package's layout).

``torch`` and ``jax.random`` give different numbers from the same seed, so
a model made here is not the JAX model of that seed; ``repro_torch.bridge``
carries JAX parameters over exactly.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator | None:
    """A seeded generator on ``device``; None on the ``meta`` device, where
    a parameter tree has shapes and no values (a checkpoint's template)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def dense_init(gen, shape, fan_in: int | None = None, device=None):
    """Normal values over sqrt(fan_in), scaled in place: the largest leaf
    (an embedding) never exists twice."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=gen, device=device).mul_(std)


def embed_init(gen, shape, device=None):
    return torch.randn(shape, generator=gen, device=device).mul_(0.02)


def zeros(shape, device=None):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over nested dicts of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stack_init(init_fn, n: int):
    """Initialize ``n`` layer trees and stack their leaves on a leading dim.

    Each leaf's ``(n, ...)`` stack is allocated once, from layer 0's tree,
    and every layer is copied in as it is drawn, so the peak is the stacks
    and one layer, where stacking a list of ``n`` trees would hold twice the
    stacks.  The generator draws in the same order: the values are those of
    ``torch.stack`` over the ``n`` trees, bit for bit."""
    tree = init_fn()
    stacked = tree_map(lambda x: x.new_empty((n, *x.shape)), tree)
    for i in range(n):
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, tree)
        tree = None                  # freed before the next layer is drawn
        if i + 1 < n:
            tree = init_fn()
    return stacked


def layer(stacked, i: int):
    """Layer ``i``'s view of a stacked parameter (or cache) tree."""
    return tree_map(lambda x: x[i], stacked)


def layer_views(stacked, n: int) -> list:
    """Every layer's view of a stacked tree, from one ``unbind`` a leaf.
    Under autograd its backward stacks the layers' gradients once, where
    ``n`` calls of :func:`layer` would each add a zero tensor the size of
    the whole stack into the leaf's gradient."""
    views = tree_map(lambda x: torch.unbind(x, 0), stacked)
    return [tree_map(lambda t: t[i], views) for i in range(n)]


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))
