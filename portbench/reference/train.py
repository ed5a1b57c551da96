"""Plain PyTorch training steps: the loss of ``dense_lm.loss``, its gradient
by autograd (one row of the batch at a time, summed), and AdamW as the
training mix states it (global-norm clipping, linear warm-up, bias
correction, decoupled weight decay).  Imports nothing of the program."""
from __future__ import annotations

import math

import torch

from . import dense_lm


def _lr(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(opt["warmup_steps"], 1)
    t = (step - opt["warmup_steps"]) / max(
        opt["total_steps"] - opt["warmup_steps"], 1)
    cos = 0.5 * (1.0 + math.cos(math.pi * min(max(t, 0.0), 1.0)))
    return opt["lr"] * (0.1 + 0.9 * cos)


def _grads(params, conf, batch, z_loss, precision):
    for p in params.values():
        p.grad = None
    tokens, labels = batch["tokens"], batch["labels"]
    n = tokens.numel()
    total = 0.0
    with dense_lm.exact_f32():
        for r in range(tokens.shape[0]):
            s, _ = dense_lm.loss(_tree(params), conf, tokens[r:r + 1],
                                 labels[r:r + 1], z_loss, precision=precision)
            (s / n).backward()
            total += float(s.detach())
    return total / n, {k: p.grad for k, p in params.items()}


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def steps(flat0: dict, conf: dict, batches: list, mix: dict,
          precision: str = "f32") -> dict:
    """Run ``len(batches)`` steps from the parameters ``flat0``
    (``{path: tensor}``, left unchanged); return each step's loss, every
    leaf's norm of the first step's gradient as the optimizer takes it
    (after clipping), of that gradient before clipping, and of each leaf's
    change over all the steps."""
    opt, z = mix["opt"], mix["z_loss"]
    params = {k: t.detach().clone().requires_grad_() for k, t in flat0.items()}
    m = {k: torch.zeros_like(t) for k, t in flat0.items()}
    v = {k: torch.zeros_like(t) for k, t in flat0.items()}
    losses, g1, g1_raw = [], None, None
    for i, batch in enumerate(batches, start=1):
        loss, grads = _grads(params, conf, batch, z, precision)
        losses.append(loss)
        with torch.no_grad():
            gnorm = math.sqrt(sum(float(g.double().square().sum())
                                  for g in grads.values()))
            scale = min(1.0, opt["clip_norm"] / (gnorm + 1e-9))
            if i == 1:
                g1_raw = {k: float(g.norm()) for k, g in grads.items()}
                g1 = {k: n * scale for k, n in g1_raw.items()}
            lr = _lr(opt, i)
            bc1, bc2 = 1 - opt["b1"] ** i, 1 - opt["b2"] ** i
            for k, p in params.items():
                g = grads[k] * scale
                m[k].mul_(opt["b1"]).add_(g, alpha=1 - opt["b1"])
                v[k].mul_(opt["b2"]).addcmul_(g, g, value=1 - opt["b2"])
                upd = (m[k] / bc1) / ((v[k] / bc2).sqrt() + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
    with torch.no_grad():
        change = {k: float((params[k] - flat0[k]).norm()) for k in params}
    return {"losses": losses, "grad1": g1, "grad1_raw": g1_raw,
            "change": change}
