"""Distributed-optimization collectives (the JAX package's
``parallel/collectives.py`` :15-36).

``compressed_psum`` applies the paper's split idea to the gradient
all-reduce: gradients are reduced in bf16 (half the bytes on the wire) and
the rounding residual is carried to the next step as an error-feedback
buffer, the same "keep the mantissa loss in an extra variable" trick as
the paper's Eqs. (3)/(5), applied across steps instead of across split
terms."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.modules import tree_map


def compressed_psum(grads, residual, group=None):
    """bf16 all-reduce with error feedback over ``group`` (a process group,
    default the world; None with no process group sums over this process
    alone).

    Returns ``(reduced_f32, new_residual)``.  The residual holds the f32 -
    bf16 rounding error of this rank's contribution and is added back
    before the next compression, so over steps the bias telescopes away.
    The sum runs in f32 over the bf16-rounded values, as JAX's ``psum`` of
    ``glo.astype(f32)`` does."""
    def one(g, r):
        g32 = g.float() + r
        glo = g32.to(torch.bfloat16)
        new_r = g32 - glo.float()
        red = glo.float()
        if dist.is_initialized() and dist.get_world_size(group) > 1:
            dist.all_reduce(red, group=group)
        return red, new_r

    out = tree_map(one, grads, residual)      # leaves: (reduced, residual)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def zeros_like_residual(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
