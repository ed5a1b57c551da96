"""Parameter helpers: seeded initializers on a ``torch.Generator`` and the
nested-dict parameter trees the models use (stacked per-layer leaves with a
leading layer axis, the JAX package's layout).

``torch`` and ``jax.random`` give different numbers from the same seed, so
a model made here is not the JAX model of that seed; ``repro_torch.bridge``
carries JAX parameters over exactly.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import numerics


def checkpointed(fn, *args):
    """``fn(*args)``, recomputed in the backward (``jax.checkpoint``): the
    recompute runs under the forward's numerics config, since autograd's
    worker thread does not see the forward's ``numerics.use`` scope."""
    cfg = numerics.active()
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          numerics.use(cfg)))


def generator(seed: int, device) -> torch.Generator | None:
    """A seeded generator on ``device``; None on the ``meta`` device, where
    a parameter tree has shapes and no values (a checkpoint's template)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


# Where the next leaves are made: None (a new tensor each), or a function
# of (shape, dtype, device) that :func:`stack_init` sets, in its own
# context, to hand out the slots of its stacks.
_slot: contextvars.ContextVar = contextvars.ContextVar("slot", default=None)


def _leaf(shape, dtype, device):
    slot = _slot.get()
    if slot is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return slot(tuple(shape), dtype, torch.device(device or "cpu"))


def dense_init(gen, shape, fan_in: int | None = None, device=None):
    """Normal values over sqrt(fan_in), drawn and scaled in place: the
    largest leaf (an embedding) never exists twice."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return _normal(gen, shape, device).mul_(std)


def embed_init(gen, shape, device=None):
    return _normal(gen, shape, device).mul_(0.02)


def _normal(gen, shape, device):
    # torch.randn's own draw: an empty tensor filled by normal_
    t = _leaf(shape, torch.get_default_dtype(), device)
    return t if t.is_meta else t.normal_(generator=gen)


def zeros(shape, device=None):
    return _leaf(shape, torch.float32, device).zero_()


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

    A first call of ``init_fn`` makes its :func:`dense_init`,
    :func:`embed_init` and :func:`zeros` leaves on the ``meta`` device: their
    shapes, without a draw.  Each leaf's ``(n, ...)`` stack is allocated
    once, and the ``n`` real calls draw every such leaf straight into its
    layer's slot of the stack (a leaf made otherwise, a constant, is copied
    in).  So the peak is the stacks and no layer beside them: stacking a
    list of ``n`` trees would hold the stacks twice, and copying each layer
    in would hold one layer more (deepseek-v3-671b's MoE layer is 46 GB).
    The generator draws in the same order: the values are those of
    ``torch.stack`` over the ``n`` trees, bit for bit."""
    made, where = [], []

    def on_meta(shape, dtype, device):
        made.append(torch.empty(shape, dtype=dtype, device="meta"))
        where.append(device)
        return made[-1]

    template = _with_slot(on_meta, init_fn)
    order = {id(t): k for k, t in enumerate(made)}
    stacks = [torch.empty((n, *t.shape), dtype=t.dtype, device=d)
              for t, d in zip(made, where)]

    def stack_of(t):
        if id(t) in order:
            return stacks[order[id(t)]]
        if t.is_meta and any(d.type != "meta" for d in where):
            raise RuntimeError("stack_init: a leaf computed from a drawn "
                               "leaf; draw it in place")
        return t.new_empty((n, *t.shape))

    stacked = tree_map(stack_of, template)
    del template, made
    for i in range(n):
        slots = iter([s[i] for s in stacks])

        def in_slot(shape, dtype, device):
            t = next(slots)
            if t.shape != shape or t.dtype != dtype:
                raise RuntimeError("stack_init: the layers' trees differ")
            return t

        tree = _with_slot(in_slot, init_fn)
        tree_map(lambda dst, src: None if src._base is dst or dst.is_meta
                 else dst[i].copy_(src), stacked, tree)
    return stacked


def _with_slot(slot, init_fn):
    token = _slot.set(slot)
    try:
        return init_fn()
    finally:
        _slot.reset(token)


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
