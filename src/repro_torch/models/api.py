"""Family-dispatched model handle with the JAX package's entry names.

The dense and MoE families are ported (both ``models.lm``, as in the JAX
package); the other families raise.
"""
from __future__ import annotations

from types import SimpleNamespace

from . import lm


def get_model(cfg) -> SimpleNamespace:
    """Build the model handle for ``cfg`` (dense or MoE family)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to PyTorch yet")
    return SimpleNamespace(
        init=lambda seed=0, device=None: lm.init(cfg, seed, device),
        loss_fn=lambda params, batch: lm.loss_fn(params, batch, cfg),
        forward_logits=lambda params, tokens: lm.forward(params, tokens, cfg),
        prefill=lambda params, tokens, positions=None: lm.prefill(
            params, cfg, tokens, positions),
        init_paged_cache=lambda num_pages, page_size, **kw:
            lm.init_paged_cache(cfg, num_pages, page_size, **kw),
        decode_step_paged=lambda params, pools, block_tables, lengths,
            tokens: lm.decode_step_paged(params, cfg, pools, block_tables,
                                         lengths, tokens),
        module=lm,
    )
