"""InternVL2-style VLM (the ``vlm`` family, internvl2-2b).  Counterpart of
the JAX package's ``models/vlm_lm.py``.  The vision tower is a STUB:
``batch["patches"]`` carries precomputed patch embeddings (InternViT
features, B, P, frontend_dim); the MLP projector and the InternLM2-style
language backbone are real, and the LM loss is masked to the text
positions (labels -1 on the patches).

Parameters: ``models.lm``'s tree plus ``projector`` (``w1``
(frontend_dim, D), ``w2`` (D, D)).  Decoding is ``models.lm``'s over the
dense cache (text only in ``launch.serve.generate_dense``, as in JAX);
there is no paged decode path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pdot
from . import layers as L
from . import lm
from .lm import _positions, cross_entropy, embed, unembed_logits
from .modules import dense_init, generator


def init(cfg, seed: int = 0, device=None):
    """``lm.init``'s parameters from ``seed`` and the projector's from a
    second generator derived from it, on ``device``."""
    device = resolve_device(device)
    params = lm.init(cfg, seed, device)
    derived = np.random.SeedSequence([seed, 1]).generate_state(1)[0]
    gen = generator(int(derived), device)
    params["projector"] = {
        "w1": dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                         fan_in=cfg.frontend_dim, device=device),
        "w2": dense_init(gen, (cfg.d_model, cfg.d_model), fan_in=cfg.d_model,
                         device=device),
    }
    return params


def project_patches(params, patches, cfg):
    """Two policy products with the tanh GELU between them."""
    h = pdot("bpf,fd->bpd", patches.float(), params["projector"]["w1"],
             cfg.policy)
    h = L._act(h, "gelu")
    return pdot("bpd,de->bpe", h, params["projector"]["w2"], cfg.policy)


def forward_logits(params, batch, cfg):
    """batch: ``patches`` (B, P, frontend_dim), ``tokens`` (B, S_text) ->
    logits (B, P + S_text, V): the projected patches first, then the
    embedded text, through the block stack at each layer's window."""
    vis = project_patches(params, batch["patches"], cfg)
    x = torch.cat([vis, embed(params, batch["tokens"], cfg)], dim=1)
    B, S = x.shape[:2]
    x, _ = lm.apply_blocks(params, x, cfg, _positions(B, S, x.device))
    x = L.rmsnorm(params["ln_f"], x, cfg.norm_eps)
    return unembed_logits(params, x, cfg)


def loss_fn(params, batch, cfg):
    """labels: (B, P + S_text) with -1 on the patch positions."""
    logits = forward_logits(params, batch, cfg)
    loss, denom = cross_entropy(logits, batch["labels"])
    return loss, {"loss": loss, "lm_loss": loss, "tokens": denom}


# decode is the LM's over the combined sequence (image prefilled)
init_cache = lm.init_cache
decode_step = lm.decode_step
