"""Mesh context (the JAX package's ``parallel/ctx.py`` :16-61): lets model
code place sharding constraints without threading the mesh through every
call signature.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dim names
are JAX's axis names (``("data", "model")`` or ``("pod", "data",
"model")``; ``launch/mesh.py::make_host_mesh`` builds one).  Sharded
tensors are ``DTensor``s, and :func:`constrain` is JAX's
``with_sharding_constraint``: ``x.redistribute`` to the spec's placements
when ``x`` is a DTensor and a mesh is installed, the identity otherwise,
so the unsharded path never changes.

While a mesh is installed, DTensor's implicit replication is on: a plain
tensor that meets a DTensor in an op (positions, masks, RoPE tables) is
taken as replicated on every rank, as a closed-over constant is in a JAX
program traced under a mesh.

:func:`axis_names` and :func:`axis_shape` read a ``DeviceMesh`` or any
stand-in with ``.axis_names`` and a ``.shape`` dict (JAX's interface), so
the rules of :mod:`.sharding` and the plans of ``kernels/shmap.py`` run on
shape-only meshes.
"""
from __future__ import annotations

import contextlib

import torch

_CURRENT: list = []   # (mesh, batch_axes)
_implicit: list = []  # the entered implicit-replication scope, if any


def axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_shape(mesh) -> dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def is_device_mesh(mesh) -> bool:
    return getattr(mesh, "mesh_dim_names", None) is not None


@contextlib.contextmanager
def use_mesh(mesh, batch_axes: tuple | None = None):
    """Install ``mesh`` (and the batch axes; default its ``pod`` / ``data``
    axes) for the scope.  A ``DeviceMesh`` also turns DTensor's implicit
    replication on until the outermost such scope exits."""
    if batch_axes is None:
        batch_axes = tuple(a for a in ("pod", "data")
                           if a in axis_names(mesh))
    _CURRENT.append((mesh, tuple(batch_axes)))
    entered = False
    if is_device_mesh(mesh) and not _implicit:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        scope = implicit_replication()
        scope.__enter__()
        _implicit.append(scope)
        entered = True
    try:
        yield mesh
    finally:
        if entered:
            _implicit.pop().__exit__(None, None, None)
        _CURRENT.pop()


def current_mesh():
    return _CURRENT[-1][0] if _CURRENT else None


def dp_axes():
    return _CURRENT[-1][1] if _CURRENT else ()


def clean_spec(shape, spec_dims, mesh) -> tuple:
    """JAX's spec trimming (:37-58): dims longer than ``len(shape)`` are
    trimmed from the left, shorter ones padded with None; an axis name
    absent from the mesh or already used by an earlier dim is dropped
    (``dp_over_model`` puts ``model`` among the batch axes), and a dim the
    remaining axes do not divide is replicated."""
    ndim = len(shape)
    dims = list(spec_dims)[-ndim:] if len(spec_dims) > ndim \
        else list(spec_dims) + [None] * (ndim - len(spec_dims))
    names_all, sizes = axis_names(mesh), axis_shape(mesh)
    clean = []
    used: set = set()
    for d, size in zip(dims, shape):
        names = d if isinstance(d, tuple) else ((d,) if d else ())
        names = tuple(n for n in names if n in names_all and n not in used)
        total = 1
        for n in names:
            total *= sizes[n]
        if names and size % total == 0:
            clean.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            clean.append(None)
    return tuple(clean)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *spec_dims):
    """``x.redistribute`` to the cleaned spec's placements when a mesh is
    installed and ``x`` is a DTensor; else ``x`` unchanged."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, torch.Tensor) or not is_dtensor(x):
        return x
    from .sharding import P, to_placements
    spec = P(*clean_spec(x.shape, spec_dims, mesh))
    placements = to_placements(spec, x.device_mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def local_like(x, ref):
    """The local shard of ``x`` in ``ref``'s layout, dims aligned from the
    right (``x`` may be a row of ``ref``, as a written token is of a page
    pool): ``x`` redistributed to ``ref``'s placements and taken local when
    ``ref`` is a DTensor (a plain ``x`` counts as replicated), else ``x``.
    In-place writes into a sharded pool go through this and
    ``ref.to_local()``."""
    if not is_dtensor(ref):
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, off = ref.device_mesh, ref.ndim - x.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    placements = tuple(Shard(p.dim - off) if p.is_shard() else p
                       for p in ref.placements)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    return x.to_local()


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor split or pending a sum over a mesh dim of
    more than one rank."""
    return is_dtensor(x) and any(
        not p.is_replicate() and x.device_mesh.size(m) > 1
        for m, p in enumerate(x.placements))


def evenly(x):
    """``x`` with every uneven shard made whole: a DTensor sharded on a dim
    its mesh dims do not divide (DTensor's product rules pick such
    shardings, and its views then refuse them) is redistributed to
    ``Replicate`` on those mesh dims; anything else is returned as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    per_dim = _ranks_per_dim(x)
    keep = tuple(Replicate() if p.is_shard()
                 and x.shape[p.dim] % per_dim[p.dim] else p
                 for p in x.placements)
    if keep == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, keep)


def _ranks_per_dim(x) -> dict[int, int]:
    """``{tensor dim: ranks it is split over}`` of a DTensor's shards."""
    out: dict[int, int] = {}
    for m, p in enumerate(x.placements):
        if p.is_shard():
            out[p.dim] = out.get(p.dim, 1) * x.device_mesh.size(m)
    return out


def _groups(old, new):
    """The contiguous dim groups of a reshape ``old -> new``: pairs of
    (old dims, new dims) whose sizes have equal products."""
    out, i, j = [], 0, 0
    while i < len(old) and j < len(new):
        a, b, pa, pb = [i], [j], old[i], new[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb and i < len(old):
                pa *= old[i]
                a.append(i)
                i += 1
            elif j < len(new):
                pb *= new[j]
                b.append(j)
                j += 1
            else:
                break
        out.append((a, b))
    return out


def reshape(x, shape):
    """``x.reshape(shape)``, for a DTensor too where a sharded dim cannot
    keep its sharding through the reshape: DTensor's view refuses to split
    a dim sharded over n ranks unless the split's leading size divides by
    n (and, sharded over several mesh dims, checks each mesh dim alone, so
    that an uneven split passes and gives wrong local shapes), and to
    flatten a group unless its leading dim carries the sharding.  Such a
    mesh dim is made whole first (an all-gather), as XLA reshards ahead of
    such a reshape; every other placement is kept.  The gradient goes back
    through the same rule.  A plain tensor is reshaped directly."""
    shape = tuple(shape)
    if not is_dtensor(x):
        return x.reshape(shape)
    if -1 in shape:
        known = 1
        for n in shape:
            known *= n if n != -1 else 1
        shape = tuple(x.numel() // known if n == -1 else n for n in shape)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Reshape.apply(x, shape)
    return _reshape(x, shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, shape):
        fctx.shape = tuple(x.shape)
        return _reshape(x, shape)

    @staticmethod
    def backward(fctx, g):
        return _reshape(g, fctx.shape), None


def _reshape(x, shape):
    from torch.distributed.tensor import Replicate
    old = tuple(x.shape)
    where = {}
    for a, b in _groups(old, shape):
        for d in a:
            where[d] = (a, b)
    per_dim = _ranks_per_dim(x)
    keep = []
    for p in x.placements:
        ok = True
        if p.is_shard() and p.dim in where:
            a, b = where[p.dim]
            n = per_dim[p.dim]
            lead = next((shape[j] for j in b if shape[j] != 1), 1)
            if len(a) == 1:
                ok = len(b) == 1 or lead % n == 0
            else:
                ok = len(b) == 1 and p.dim == a[0] and old[a[0]] % n == 0
        keep.append(p if ok else Replicate())
    if tuple(keep) != tuple(x.placements):
        x = x.redistribute(x.device_mesh, keep)
    return x.reshape(shape)


def full(x):
    """The whole tensor of a DTensor (gathered on every rank), else
    ``x``."""
    return x.full_tensor() if is_dtensor(x) else x
