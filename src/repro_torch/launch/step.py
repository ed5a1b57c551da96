"""Train, prefill and serve steps (the port's ``launch/step.py``).

A train step takes ``state = {"params", "opt"}`` and a batch of
``tokens`` / ``labels`` (and the enc-dec and VLM families' ``frames`` /
``patches``) and returns the new state and its metrics: the
loss and its gradient by autograd (every policy product and its gradient
products run kernel 1, every attention forward kernel 2), then one AdamW
step.  :func:`make_sharded_train_step` runs the same step on DTensor state
under a mesh (JAX :89-117): every product and attention call then runs per
shard through ``kernels/shmap.py``.  JAX's ``lower_cell`` (XLA lowering
for the dry run) is not here.

Under a ``repro_torch.obs`` tracer the train step records three spans,
each with its device edges on the card (``obs/trace.py``):
``train.forward`` (``model.loss_fn``) and ``train.backward``
(``torch.autograd.grad``, with remat's recompute) once per microbatch, and
``train.optimizer`` (the gradients' reduction and the AdamW update) once
per step.  With no tracer it records nothing.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import numerics
from repro_torch.configs import SHAPES
from repro_torch.models import get_model
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.obs.trace import current as _current_tracer
from repro_torch.optim import adamw
from repro_torch.parallel import ctx
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import P
from . import specs as S


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_train_step(cfg, opt_cfg: adamw.OptConfig, num_microbatches: int = 1,
                    reduce_grads=None):
    """``train_step(state, batch) -> (new_state, metrics)``.  With
    ``num_microbatches > 1`` the batch is split on its leading dim, the
    microbatches' gradients are summed and divided by their number, and the
    metrics are their means (JAX's gradient accumulation).
    ``reduce_grads(grads, params)`` (flat lists) runs on the gradients
    before the update."""
    model = get_model(cfg)

    def grads_of(params, batch, span):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        with span("train.forward"):
            loss, metrics = model.loss_fn(p, batch)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(p))
        return grads, {k: v.detach() for k, v in metrics.items()}

    def train_step(state, batch):
        params = state["params"]
        span = _phase_spans(params)
        if num_microbatches > 1:
            n = len(batch["tokens"])
            if n % num_microbatches:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{num_microbatches} microbatches")
            micro = [dict(zip(batch, mb)) for mb in zip(*(
                v.chunk(num_microbatches) for v in batch.values()))]
            grads, metrics = grads_of(params, micro[0], span)
            for mb in micro[1:]:
                g, m = grads_of(params, mb, span)
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [g / num_microbatches for g in grads]
            metrics = {k: v / num_microbatches for k, v in metrics.items()}
        else:
            grads, metrics = grads_of(params, batch, span)
        with span("train.optimizer"):
            if reduce_grads is not None:
                grads = reduce_grads(grads, tree_leaves(params))
            new_params, new_opt, om = adamw.apply_updates(
                params, _unflatten(params, grads), state["opt"], opt_cfg)
        metrics.update(om)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _phase_spans(params):
    """``span(name)`` for the phases of one train step: the active
    tracer's span, with device edges when the parameters are on the card,
    or a no-op context when no tracer is installed."""
    tr = _current_tracer()
    if tr is None:
        return lambda name: contextlib.nullcontext()
    on_card = tree_leaves(params)[0].is_cuda
    return lambda name: tr.span(name, cat="train", device=on_card)


def _reduce_once(grads, params):
    """Each gradient in its parameter's placements: the data-parallel
    partial sums are all-reduced here, once, in f32 (the gradients are
    f32)."""
    return [g.redistribute(p.device_mesh, p.placements)
            if ctx.is_dtensor(g) and tuple(g.placements) != tuple(p.placements)
            else g for g, p in zip(grads, params)]


def make_sharded_train_step(cfg, opt_cfg: adamw.OptConfig, mesh,
                            num_microbatches: int = 1):
    """The train step on ``mesh``: ``(step, state_shardings,
    batch_sharder)``.

    ``state_shardings`` is the :class:`parallel.sharding.NamedSharding`
    tree of the state (``param_specs`` for the parameters, the optimizer
    state's mirrored by :func:`_opt_specs`); place a state with
    ``sharding.shard_tree(state, state_shardings)``.  ``batch_sharder``
    lays a whole batch out by ``batch_specs``.  The step runs under
    ``ctx.use_mesh(mesh, batch_axes)``, so dispatch routes every eligible
    call through the per-shard wrappers; its metrics come back whole."""
    state_abs = S.abstract_state(cfg, opt_cfg)
    pspec = shd.param_specs(state_abs["params"], mesh, cfg)
    state_spec = {"params": pspec,
                  "opt": _opt_specs(state_abs["opt"], pspec)}
    state_sh = shd.to_shardings(state_spec, mesh)
    inner = make_train_step(cfg, opt_cfg, num_microbatches, _reduce_once)
    axes = shd.batch_axes(cfg, mesh)

    def step(state, batch):
        with ctx.use_mesh(mesh, axes):
            new_state, metrics = inner(state, batch)
            return new_state, {k: ctx.full(v) for k, v in metrics.items()}

    def batch_sharder(batch):
        spec = shd.batch_specs(cfg, mesh, batch)
        return shd.shard_tree(batch, shd.to_shardings(spec, mesh))

    return step, state_sh, batch_sharder


def _opt_specs(opt_abs, pspec):
    """Optimizer-state specs mirror the parameter specs (JAX :181-196); a
    factored ``v`` drops the corresponding parameter dim; ``step`` is
    replicated."""
    def mk_v(p_spec, v_leaf):
        if isinstance(v_leaf, dict):  # factored second moment
            dims = list(p_spec) + [None] * (
                len(v_leaf["row"].shape) + 1 - len(list(p_spec)))
            return {"row": P(*dims[:-1]),
                    "col": P(*(dims[:-2] + dims[-1:]))}
        return p_spec

    def walk(p, v):
        if isinstance(p, dict):
            return {k: walk(p[k], v[k]) for k in p}
        return mk_v(p, v)

    return {"m": pspec, "v": walk(pspec, opt_abs["v"]), "step": P()}


def make_prefill_step(cfg):
    """``prefill_step(params, batch) -> logits`` of the batch (its
    ``tokens``, with ``frames`` or ``patches`` in the enc-dec and VLM
    families)."""
    model = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        return model.forward_logits(params, batch)

    return prefill_step


def make_serve_step(cfg):
    """``serve_step(params, cache, tokens, cache_index) -> (logits,
    cache)``: one token a row against the dense cache (the family's
    ``decode_step``; the cache is updated in place)."""
    model = get_model(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, cache_index):
        return model.decode_step(params, cache, tokens, cache_index)

    return serve_step


# ------------------------------------------------------------- tracing

def lower_cell(cfg, shape_name: str, mesh, opt_cfg=None,
               numerics_overrides: dict | None = None):
    """Trace one (arch x shape x mesh) cell of the dry run (``shape_name``
    a key of ``configs.SHAPES``, or a ``ShapeConfig`` of its own); returns
    ``(record, kind)``, ``record`` being ``launch/hlo_cost.py::analyze``'s
    per-device counts and ``kind`` ``"train"``, ``"prefill"`` or
    ``"decode"``.

    JAX's ``lower_cell`` lowers the step to HLO.  This one traces it: the
    cell's state and inputs are ``meta`` stand-ins (``launch/specs.py``),
    each placed as this rank's shard of its spec (``param_specs`` /
    ``batch_specs`` / ``cache_specs`` / :func:`_opt_specs`, through
    ``parallel/sharding.py::shard_tree``, which scatters nothing), and the
    step runs once under ``parallel.ctx.use_mesh(mesh, batch_axes)`` and
    ``numerics.use(**numerics_overrides)`` inside the counter.  Nothing is
    stored and nothing launches: each kernel call leaves a record
    (``kernels/meta.py``).  The decode cell's ``cache_index`` is the last
    position of the cache (a Python int, as the port's decode takes; the
    work does not depend on it)."""
    from .hlo_cost import CostCounter, analyze
    with numerics.use(**(numerics_overrides or {})):
        counter = CostCounter()
        kind, run, inputs = _cell(cfg, shape_name, mesh, opt_cfg)
        counter.add_arguments(inputs)
        with ctx.use_mesh(mesh, shd.batch_axes(cfg, mesh)), counter:
            out = run()   # held through analyze: its storage is the output
        return analyze(counter), kind


def _place(tree, spec_tree, mesh):
    return shd.shard_tree(tree, shd.to_shardings(spec_tree, mesh))


def _cell(cfg, shape_name, mesh, opt_cfg):
    """``(kind, run, inputs)``: the cell's step as a thunk over its placed
    stand-ins, and those stand-ins."""
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    opt_cfg = opt_cfg or adamw.OptConfig(
        moment_dtype=("bfloat16" if cfg.shard_mode == "fsdp_tp"
                      else "float32"),
        factored_v=(cfg.shard_mode == "fsdp_tp"))

    if shape.kind == "train":
        state_abs = S.abstract_state(cfg, opt_cfg)
        pspec = shd.param_specs(state_abs["params"], mesh, cfg)
        state = _place(state_abs, {"params": pspec,
                                   "opt": _opt_specs(state_abs["opt"],
                                                     pspec)}, mesh)
        batch_abs = S.input_specs(cfg, shape)
        batch = _place(batch_abs, shd.batch_specs(cfg, mesh, batch_abs),
                       mesh)
        step = make_train_step(cfg, opt_cfg, reduce_grads=_reduce_once)
        return "train", lambda: step(state, batch), [state, batch]

    params_abs = S.abstract_params(cfg)
    params = _place(params_abs, shd.param_specs(params_abs, mesh, cfg), mesh)
    if shape.kind == "prefill":
        batch_abs = S.input_specs(cfg, shape)
        batch = _place(batch_abs, shd.batch_specs(cfg, mesh, batch_abs),
                       mesh)
        prefill = make_prefill_step(cfg)

        def run():
            # JAX's out_shardings: the logits laid out P(dp, None, model)
            return ctx.constrain(prefill(params, batch), shd.dp_axes(mesh),
                                 None, "model")
        return "prefill", run, [params, batch]

    tokens_abs, _, cache_abs = S.decode_specs(cfg, shape)
    cache = _place(cache_abs, shd.cache_specs(
        cfg, mesh, cache_abs, shape.global_batch, shape.seq_len), mesh)
    tspec = (P(shd.dp_axes(mesh))
             if shape.global_batch % shd.data_size(mesh) == 0 else P())
    tokens = _place(tokens_abs, tspec, mesh)
    serve = make_serve_step(cfg)
    return ("decode",
            lambda: serve(params, cache, tokens, shape.seq_len - 1),
            [params, cache, tokens])
