"""Abstract input and state specs (the JAX package's ``launch/specs.py``
:17-61): tensors on the ``meta`` device stand in for every model input,
parameter and optimizer leaf, with their shapes and dtypes and no
storage."""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, ShapeConfig
from repro_torch.models import get_model
from repro_torch.optim import adamw


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape: ShapeConfig | str) -> dict:
    """Train / prefill batch stand-ins for one (arch x shape) cell."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((B, S), torch.int32),
             "labels": _sds((B, S), torch.int32)}
    if cfg.family == "vlm":
        # the frontend stub's precomputed patch embeddings; patches + text
        # make the cell's seq_len
        n = cfg.n_frontend_tokens
        batch["tokens"] = _sds((B, S - n), torch.int32)
        batch["patches"] = _sds((B, n, cfg.frontend_dim), torch.float32)
        batch["labels"] = _sds((B, S), torch.int32)
    if cfg.family == "audio":
        batch["frames"] = _sds((B, S, cfg.frontend_dim), torch.float32)
    if shape.kind == "prefill":
        batch.pop("labels")
    return batch


def decode_specs(cfg, shape: ShapeConfig | str):
    """``(tokens, cache_index, cache)`` stand-ins for a decode cell."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    kwargs = {}
    if cfg.family == "audio":
        kwargs["mem_len"] = max(S // 8, 64)
    cache = get_model(cfg).init_cache(B, S, device="meta", **kwargs)
    return _sds((B,), torch.int32), _sds((), torch.int32), cache


def abstract_params(cfg):
    return get_model(cfg).init(0, device="meta")


def abstract_state(cfg, opt_cfg: adamw.OptConfig):
    params = abstract_params(cfg)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}
