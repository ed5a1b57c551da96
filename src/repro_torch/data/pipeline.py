"""Deterministic synthetic data pipeline (the port's copy of the JAX
package's ``data/pipeline.py``).

Token/label batches come from a counter-based numpy generator seeded by
``(seed, step, host)``, so a restart replays the exact stream, and each
host makes only its slice of the global batch.  The numpy code is the JAX
package's, so a batch is bitwise the one JAX makes for the same
``(seed, step, host)``, the VLM family's patches and the enc-dec
family's frames included.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128


def _rng(seed: int, step: int, host: int):
    return np.random.default_rng(
        np.random.SeedSequence([seed, step, host]))


def host_batch(cfg, data_cfg: DataConfig, step: int,
               host_index: int = 0, num_hosts: int = 1) -> dict:
    """The host-local slice of the global batch at ``step``: numpy int32
    ``tokens`` and ``labels`` (b, seq_len).  The VLM family gets f32
    ``patches`` (b, P, frontend_dim), text of ``max(seq_len - P, 8)``
    tokens and labels (b, P + text) that are -1 on the patch positions;
    the enc-dec (``audio``) family gets f32 ``frames`` (b, seq_len,
    frontend_dim)."""
    if data_cfg.global_batch % num_hosts:
        raise ValueError(f"global batch {data_cfg.global_batch} does not "
                         f"split over {num_hosts} hosts")
    b = data_cfg.global_batch // num_hosts
    s = data_cfg.seq_len
    rng = _rng(data_cfg.seed, step, host_index)
    # zipf-ish marginals: more realistic logit/softmax magnitudes than uniform
    z = rng.zipf(1.3, size=(b, s + 1))
    tokens_full = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)
    batch = {"tokens": tokens_full[:, :s],
             "labels": tokens_full[:, 1:s + 1].copy()}
    if cfg.family == "vlm":
        p = cfg.n_frontend_tokens
        s_text = max(s - p, 8)
        batch["tokens"] = tokens_full[:, :s_text]
        batch["patches"] = rng.standard_normal(
            (b, p, cfg.frontend_dim)).astype(np.float32)
        labels = np.full((b, p + s_text), -1, np.int32)
        labels[:, p:] = tokens_full[:, 1:s_text + 1]
        batch["labels"] = labels
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    return batch


def device_batch(cfg, data_cfg: DataConfig, step: int, device=None) -> dict:
    """The global batch at ``step`` as tensors on ``device`` (int32 tokens
    and labels, f32 patches or frames)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in host_batch(cfg, data_cfg, step).items()}
