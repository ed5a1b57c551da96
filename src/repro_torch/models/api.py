"""Family-dispatched model handle with the JAX package's entry names.

The dense and MoE families are ``models.lm``, the SSM family
``models.ssm_lm``, the hybrid family ``models.hybrid_lm``, the enc-dec
family (``audio``) ``models.encdec_lm`` and the VLM family
``models.vlm_lm``, as in the JAX package.  Every handle has ``init``,
``loss_fn``, ``forward_logits``, ``init_cache`` and ``decode_step`` (the
dense-cache loop of ``launch.serve.generate_dense``); the paged serving
entries (``prefill``, ``prefill_chunk``, ``init_paged_cache``,
``decode_step_paged``) are None
for the families without them (SSM, hybrid, enc-dec, VLM), and the engine
and ``generate`` check for that.

``forward_logits(params, batch)`` takes JAX's batch dict: ``{"tokens"}``,
plus ``"frames"`` (enc-dec) or ``"patches"`` (VLM).  The text-only
families also take a bare tokens tensor, so a caller may treat every
family alike by passing the dict.

``get_model(cfg, numerics_config)`` pins every entry of the handle to that
:class:`repro_torch.numerics.NumericsConfig`, as JAX's does: each call runs
inside ``numerics.use(numerics_config)``, whatever the caller's context.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace

from repro_torch import numerics
from . import encdec_lm, hybrid_lm, lm, ssm_lm, vlm_lm

_FAMILIES = {"dense": lm, "moe": lm, "ssm": ssm_lm, "hybrid": hybrid_lm,
             "audio": encdec_lm, "vlm": vlm_lm}
# the families whose forward_logits takes the batch dict itself
_BATCH_INPUT = ("audio", "vlm")


_ENTRIES = ("init", "loss_fn", "forward_logits", "init_cache", "decode_step",
            "prefill", "prefill_chunk", "init_paged_cache",
            "decode_step_paged")


def _pinned(fn, cfg: numerics.NumericsConfig):
    if fn is None:
        return None

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with numerics.use(cfg):
            return fn(*a, **kw)

    return wrapped


def get_model(cfg, numerics_config: numerics.NumericsConfig | None = None
              ) -> SimpleNamespace:
    """Build the model handle for ``cfg``; with ``numerics_config``, every
    entry runs under that config."""
    mod = _FAMILIES.get(cfg.family)
    if mod is None:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet")
    paged = hasattr(mod, "decode_step_paged")
    if cfg.family in _BATCH_INPUT:
        def forward_logits(params, batch):
            return mod.forward_logits(params, batch, cfg)
    else:
        def forward_logits(params, batch):
            tokens = batch["tokens"] if isinstance(batch, dict) else batch
            return mod.forward_logits(params, tokens, cfg)
    handle = SimpleNamespace(
        init=lambda seed=0, device=None: mod.init(cfg, seed, device),
        loss_fn=lambda params, batch: mod.loss_fn(params, batch, cfg),
        forward_logits=forward_logits,
        init_cache=lambda batch, max_len, **kw: mod.init_cache(
            cfg, batch, max_len, **kw),
        decode_step=lambda params, cache, tokens, idx: mod.decode_step(
            params, cfg, cache, tokens, idx),
        prefill=(lambda params, tokens, positions=None: mod.prefill(
            params, cfg, tokens, positions)) if paged else None,
        prefill_chunk=(lambda params, cache, tokens, start:
                       mod.prefill_chunk(params, cfg, cache, tokens, start)
                       ) if paged else None,
        init_paged_cache=(lambda num_pages, page_size, **kw:
                          mod.init_paged_cache(cfg, num_pages, page_size,
                                               **kw)) if paged else None,
        decode_step_paged=(lambda params, pools, block_tables, lengths,
                           tokens: mod.decode_step_paged(
                               params, cfg, pools, block_tables, lengths,
                               tokens)) if paged else None,
        module=mod,
    )
    if numerics_config is not None:
        for name in _ENTRIES:
            setattr(handle, name, _pinned(getattr(handle, name),
                                          numerics_config))
    return handle
