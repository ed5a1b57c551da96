"""Train and prefill steps (the port's ``launch/step.py``).

A train step takes ``state = {"params", "opt"}`` and a batch of
``tokens`` / ``labels`` (and the enc-dec and VLM families' ``frames`` /
``patches``) and returns the new state and its metrics: the
loss and its gradient by autograd (every policy product and its gradient
products run kernel 1, every attention forward kernel 2), then one AdamW
step.  The sharded step and the lowering helpers of the JAX module are not
ported.
"""
from __future__ import annotations

import torch

from repro_torch.models import get_model
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.optim import adamw


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(cfg, opt_cfg: adamw.OptConfig, num_microbatches: int = 1):
    """``train_step(state, batch) -> (new_state, metrics)``.  With
    ``num_microbatches > 1`` the batch is split on its leading dim, the
    microbatches' gradients are summed and divided by their number, and the
    metrics are their means (JAX's gradient accumulation)."""
    model = get_model(cfg)

    def grads_of(params, batch):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = model.loss_fn(p, batch)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        if num_microbatches > 1:
            n = len(batch["tokens"])
            if n % num_microbatches:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{num_microbatches} microbatches")
            micro = [dict(zip(batch, mb)) for mb in zip(*(
                v.chunk(num_microbatches) for v in batch.values()))]
            grads, metrics = grads_of(params, micro[0])
            for mb in micro[1:]:
                g, m = grads_of(params, mb)
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [g / num_microbatches for g in grads]
            metrics = {k: v / num_microbatches for k, v in metrics.items()}
        else:
            grads, metrics = grads_of(params, batch)
        new_params, new_opt, om = adamw.apply_updates(
            params, _unflatten(params, grads), state["opt"], opt_cfg)
        metrics.update(om)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_prefill_step(cfg):
    """``prefill_step(params, batch) -> logits`` of the batch (its
    ``tokens``, with ``frames`` or ``patches`` in the enc-dec and VLM
    families)."""
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.forward_logits(params, batch)

    return prefill_step
