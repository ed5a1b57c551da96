"""Sharding rules: parameter, batch and cache specs per family (the JAX
package's ``parallel/sharding.py`` :25-212, rule for rule).

Logical layout on the mesh ``(pod, data, model)``:
  * batch -> ``(pod, data)`` (DP across pods and within a pod);
  * attention heads / MLP hidden / vocab / experts -> ``model`` (TP / EP);
  * ``fsdp_tp`` mode: large parameters also sharded on the data axes
    (ZeRO-3);
  * KV caches: batch on ``(pod, data)`` when divisible; a trailing dim that
    is not ``max_len`` on ``model``.

Rules are path-regex -> per-dim templates matched against the parameter
path (dict keys joined by ``/``).  When no ``"M"`` dim of a matched
template divides the model axis, the ``model`` axis falls back to the last
divisible dim.

A spec is :class:`P`, one entry per tensor dim (None, an axis name, or a
tuple of axis names), so it compares entry for entry with JAX's
``PartitionSpec``.  :func:`to_placements` turns one into DTensor
placements, one per mesh dim: ``Shard(d)`` where the mesh dim's name is in
entry ``d``, else ``Replicate()``.  **Two axes on one dim** (the batch's
``("pod", "data")``; the experts' ``("model", "data")`` under
``ep_mode="2d"``): DTensor splits the dim over its mesh dims in mesh-dim
order, outermost first.  For ``("pod", "data")`` that is JAX's order (pod
major).  For ``("model", "data")`` on a ``(data, model)`` mesh it is data
major where JAX is model major: rank ``(d, m)`` holds chunk ``d *
model + m`` of the experts, where JAX's device holds ``m * data + d``.
The full tensor is the same either way; only which rank holds which
experts differs.

Every function takes a ``DeviceMesh`` or any object with ``.axis_names``
and a ``.shape`` dict, as JAX's do, so the tests pass shape-only stand-ins.
"""
from __future__ import annotations

import math
import re

from .ctx import axis_names, axis_shape


class P(tuple):
    """A partition spec: one entry per tensor dim (None, an axis name, or a
    tuple of names), JAX's ``PartitionSpec`` as a tuple.  A one-name tuple
    is stored as the name, as JAX normalizes it."""

    def __new__(cls, *dims):
        return super().__new__(cls, tuple(
            d[0] if isinstance(d, tuple) and len(d) == 1 else d
            for d in dims))

    def __repr__(self):
        return "P(" + ", ".join(repr(d) for d in self) + ")"


def dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def model_size(mesh) -> int:
    return axis_shape(mesh)["model"]


def data_size(mesh) -> int:
    shape = axis_shape(mesh)
    return math.prod(shape[a] for a in dp_axes(mesh))


# path-regex -> spec template ("M" = want model axis here; None =
# replicated).  Templates are right-padded with None; first match wins.
_RULES: list[tuple[str, tuple | None]] = [
    (r"embed$", ("M", None)),
    (r"unembed$", (None, "M")),
    # attention ------------------------------------------------------------
    (r"(attn|xattn)/wq$", (None, "M", None)),
    (r"(attn|xattn)/w[kv]$", (None, "M", None)),
    (r"(attn|xattn)/wo$", ("M", None, None)),
    (r"(attn|xattn)/b[qkv]$", None),
    (r"(attn|xattn)/(q_norm|k_norm)$", None),
    # MLA -------------------------------------------------------------------
    (r"attn/w_dq$", None),
    (r"attn/w_uq$", (None, "M", None)),
    (r"attn/w_dkv$", None),
    (r"attn/w_u[kv]$", (None, "M", None)),
    (r"attn/w_kr$", None),
    # dense MLP --------------------------------------------------------------
    (r"(mlp|shared)/w_gate$", (None, "M")),
    (r"(mlp|shared)/w_up$", (None, "M")),
    (r"(mlp|shared)/w_down$", ("M", None)),
    # MoE experts (EP on model) ---------------------------------------------
    (r"moe/router$", None),
    (r"moe/w_(gate|up|down)$", ("M", None, None)),
    # SSD ---------------------------------------------------------------------
    (r"ssd/w[zx]$", (None, "M")),
    (r"ssd/w(b|c|dt)$", None),
    (r"ssd/conv_x$", (None, "M")),
    (r"ssd/conv_bias_x$", ("M",)),
    (r"ssd/(conv_b|conv_c|conv_bias_[bc])$", None),
    (r"ssd/(A_log|D_skip|dt_bias)$", None),
    (r"ssd/norm$", ("M",)),
    (r"ssd/w_out$", ("M", None)),
    # hybrid / misc projections -----------------------------------------------
    (r"(mtp_proj|w_cat)$", ("M", None)),
    (r"shared/w_out$", ("M", None)),
    (r"frontend_proj$", ("M", None)),
    (r"projector/w1$", (None, "M")),
    (r"projector/w2$", ("M", None)),
    (r".*", None),
]


def _spec_for(path: str, shape, mesh, cfg, stacked: bool) -> P:
    msize = model_size(mesh)
    off = 1 if stacked else 0
    body = tuple(shape[off:])
    for pat, tpl in _RULES:
        if not re.search(pat, path):
            continue
        dims: list = [None] * len(body)
        if tpl is not None:
            tplp = tuple(tpl) + (None,) * (len(body) - len(tpl))
            placed = False
            for d, t in enumerate(tplp[:len(body)]):
                if t == "M" and body[d] % msize == 0 and not placed:
                    dims[d] = "model"
                    placed = True
            if not placed and any(t == "M" for t in tplp):
                # fallback: the last divisible dim takes the model axis
                for d in range(len(body) - 1, -1, -1):
                    if body[d] % msize == 0:
                        dims[d] = "model"
                        break
        dims = _apply_fsdp(path, body, dims, mesh, cfg)
        if stacked:
            dims = [None] + dims
        return P(*dims)
    return P()


_FSDP_MIN_SIZE = 1 << 22  # 4M elements


def _apply_fsdp(path, body, dims, mesh, cfg):
    """``fsdp_tp``: shard the largest still-replicated dim of a big
    parameter over the data axes (ZeRO-3; across pods too when the pod
    axis exists)."""
    if getattr(cfg, "shard_mode", "tp") != "fsdp_tp":
        return dims
    if math.prod(body) < _FSDP_MIN_SIZE:
        return dims
    shape = axis_shape(mesh)
    for axes in (dp_axes(mesh), ("data",)):
        fsdp_size = math.prod(shape[a] for a in axes)
        cand = [(body[i], i) for i in range(len(body))
                if dims[i] is None and body[i] % fsdp_size == 0]
        if cand:
            _, idx = max(cand)
            dims = list(dims)
            dims[idx] = tuple(axes) if len(axes) > 1 else axes[0]
            return dims
    return dims


def tree_map_with_path(fn, tree, prefix=()):
    """``fn(path, leaf)`` over nested dicts; the path is the keys joined by
    ``/`` (JAX's ``_path_str`` of a dict tree)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def param_specs(param_shapes, mesh, cfg):
    """Spec tree for a parameter tree (any leaves with ``.shape``: tensors
    on ``meta`` will do).  Layer-stacked leaves (under ``*blocks*``) keep
    their leading stack dim replicated."""
    msize = model_size(mesh)
    dsize = axis_shape(mesh).get("data", 1)

    def fn(ps, leaf):
        if getattr(cfg, "dp_over_model", False):
            return P()        # small model: replicate, model axis = extra DP
        stacked = "blocks" in ps
        if getattr(cfg, "ep_mode", "1d") == "2d" and \
                re.search(r"moe/w_(gate|up|down)$", ps):
            off = 1 if stacked else 0
            E = leaf.shape[off]
            if E % (msize * dsize) == 0:
                dims = [None] * len(leaf.shape)
                dims[off] = ("model", "data")   # 1 expert per chip
                return P(*dims)
        return _spec_for(ps, leaf.shape, mesh, cfg, stacked)
    return tree_map_with_path(fn, param_shapes)


def batch_axes(cfg, mesh):
    axes = dp_axes(mesh)
    if getattr(cfg, "dp_over_model", False):
        axes = axes + ("model",)
    return axes


def batch_specs(cfg, mesh, batch_shapes):
    """Batch inputs: the leading (global-batch) dim on ``(pod, data)``,
    plus ``model`` when the config runs DP over the model axis."""
    dp = batch_axes(cfg, mesh)
    shape = axis_shape(mesh)
    dsize = math.prod(shape[a] for a in dp)

    def fn(leaf):
        if len(leaf.shape) and leaf.shape[0] % dsize == 0:
            return P(dp)
        return P()
    return _map(fn, batch_shapes)


def cache_specs(cfg, mesh, cache_shapes, batch: int, max_len: int):
    """KV / SSM cache specs (see the module docstring)."""
    dp = dp_axes(mesh)
    dsize = data_size(mesh)
    msize = model_size(mesh)

    def fn(leaf):
        shape = tuple(leaf.shape)
        dims = [None] * len(shape)
        for i in range(1, len(shape)):
            if shape[i] == batch and batch % dsize == 0:
                dims[i] = dp
                break
        for i in range(len(shape) - 1, 0, -1):
            # never the batch dim already assigned, never the max_len dim
            if dims[i] is None and shape[i] != max_len \
                    and shape[i] % msize == 0:
                dims[i] = "model"
                break
        return P(*dims)
    return _map(fn, cache_shapes)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the dim's name is in entry ``d``, else
    ``Replicate()`` (see the module docstring for two axes on one dim).
    A mesh dim of size 1 is ``Replicate()`` whatever the spec says: the
    same layout, and DTensor's view rules refuse to squeeze a dim sharded
    over one rank."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else \
            ((entry,) if entry else ())
        for n in names:
            where[n] = d
    sizes = axis_shape(mesh)
    return tuple(Shard(where[n]) if n in where and sizes[n] > 1
                 else Replicate() for n in axis_names(mesh))


class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``); ``placements`` are its
    DTensor placements."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)
        self.placements = to_placements(self.spec, mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


def to_shardings(spec_tree, mesh):
    """The :class:`NamedSharding` tree of a spec tree."""
    return _map(lambda s: NamedSharding(mesh, s), spec_tree)


def local_shard(t, mesh, placements):
    """The slice of the whole tensor ``t`` that this rank holds under
    ``placements``: ``torch.chunk`` along each sharded dim, mesh dim by mesh
    dim (DTensor's own even split).  No communication: every rank passes
    the same ``t``."""
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            t = t.chunk(n, dim=pl.dim)[mesh.get_local_rank(i)]
    return t


def distribute(t, mesh, placements):
    """A DTensor of the whole tensor ``t`` (the same on every rank) laid out
    by ``placements``, each rank keeping its slice (no communication)."""
    from torch.distributed.tensor import DTensor
    local = local_shard(t, mesh, placements).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def shard_tree(tree, shardings):
    """:func:`distribute` leafwise over a tree and its
    :class:`NamedSharding` tree."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, shardings[k]) for k, v in tree.items()}
    return distribute(tree, shardings.mesh, shardings.placements)
