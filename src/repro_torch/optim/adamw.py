"""Hand-written AdamW with global-norm clipping, a warmup-cosine schedule,
configurable moment dtypes and an optional factored second moment
(Adafactor-style row/col statistics for leaves of at least 128 x 128).

The same arithmetic as the JAX package's ``optim/adamw.py``, on nested dicts
of tensors, and functional as it is: :func:`apply_updates` returns new
trees and leaves its arguments as they were.  Scalars (the step, the
learning rate, the clip scale) stay 0-d f32 tensors on the parameters'
device, so a step never waits for the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.modules import tree_leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"     # bf16 halves the optimizer's memory
    factored_v: bool = False          # Adafactor-style v for >=2D params


def schedule(cfg: OptConfig, step):
    """Learning rate at ``step``: linear warmup, then cosine to 0.1 x lr."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    cos = 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(t, 0.0, 1.0)))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                0.1 + 0.9 * cos)


def _factorable(p) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def init_state(params, cfg: OptConfig):
    """``{"m", "v", "step"}``: zero moments (v factored into ``{"row",
    "col"}`` where asked and the leaf is large enough), step 0 (int32)."""
    mdt = getattr(torch, cfg.moment_dtype)

    def mk_v(p):
        if cfg.factored_v and _factorable(p):
            return {"row": p.new_zeros(p.shape[:-1], dtype=mdt),
                    "col": p.new_zeros(p.shape[:-2] + p.shape[-1:],
                                       dtype=mdt)}
        return p.new_zeros(p.shape, dtype=mdt)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(lambda p: p.new_zeros(p.shape, dtype=mdt), params),
            "v": tree_map(mk_v, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    """The f32 2-norm of every leaf together."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """One AdamW step; returns ``(new_params, new_state, metrics)`` with
    metrics ``grad_norm`` and ``lr``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        if isinstance(v, dict):
            g2 = torch.square(g) + 1e-30
            row = b2 * v["row"].float() + (1 - b2) * g2.mean(-1)
            col = b2 * v["col"].float() + (1 - b2) * g2.mean(-2)
            v32 = (row[..., None] * col[..., None, :]
                   / torch.clamp(row.mean(-1)[..., None, None], min=1e-30))
            new_v = {"row": row.to(mdt), "col": col.to(mdt)}
        else:
            v32 = b2 * v.float() + (1 - b2) * torch.square(g)
            new_v = v32.to(mdt)
        mh = m32 / bc1
        vh = v32 / bc2
        new_p = p - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * p)
        return new_p.to(p.dtype), m32.to(mdt), new_v

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = (lambda i: tree_map(lambda o: o[i], out))
    return (pick(0), {"m": pick(1), "v": pick(2), "step": step},
            {"grad_norm": gnorm, "lr": lr})
