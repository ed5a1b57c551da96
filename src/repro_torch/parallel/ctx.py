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
    from torch.distributed.tensor import Shard
    off = ref.ndim - x.ndim
    return local_in(x, ref.device_mesh, tuple(
        Shard(p.dim - off) if p.is_shard() else p for p in ref.placements))


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


def local_in(t, mesh, placements, grad_placements=None):
    """The local shard of ``t`` (a DTensor, or a plain tensor taken as
    replicated) under ``placements``; its gradient comes back in
    ``grad_placements`` (default ``placements``)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t.to_local(grad_placements=grad_placements)


def per_channel(fn, x, *weights):
    """``fn(x, *weights)`` for an op that is local along its last
    (channel) dim and its leading (batch) dim: ``x`` (B, S, C) and weights
    whose last dim is C.  On DTensors each rank runs ``fn`` on its shards:
    the batch kept split where ``x`` splits it, the channels split over
    ``model`` where it divides C, everything else whole; a weight's
    gradient is then a partial sum over the batch's mesh dims.  This is
    the SSD layer's causal convolution: DTensor's rule for its padding
    gives a spec of the wrong length on a two-dim mesh (torch 2.11), and
    a depthwise convolution along S needs no communication.  Plain
    operands go to ``fn`` as they are."""
    if not (is_dtensor(x) or any(is_dtensor(w) for w in weights)):
        return fn(x, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = next(t for t in (x, *weights) if is_dtensor(t)).device_mesh
    names = axis_names(mesh)
    C = x.shape[-1]
    xp, wp, wg = [], [], []
    for m, name in enumerate(names):
        n = mesh.size(m)
        cur = x.placements[m] if is_dtensor(x) else Replicate()
        if cur.is_shard() and cur.dim == 0 and n > 1:
            xp.append(Shard(0))
            wp.append(Replicate())
            wg.append(Partial())
        elif name == "model" and n > 1 and C % n == 0:
            xp.append(Shard(x.ndim - 1))
            wp.append(Shard(-1))
            wg.append(Shard(-1))
        else:
            xp.append(Replicate())
            wp.append(Replicate())
            wg.append(Replicate())

    def local(t, placements, grad):
        last = [Shard(t.ndim - 1) if p.is_shard() and p.dim == -1 else p
                for p in (*placements, *grad)]
        return local_in(t, mesh, last[:len(placements)],
                        last[len(placements):])

    out = fn(local(x, xp, xp), *(local(w, wp, wg) for w in weights))
    shape = torch.Size(tuple(x.shape))
    return DTensor.from_local(out, mesh, xp, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def along(fn, x, dim: int):
    """``fn(x)`` for an op that acts along ``dim`` alone and keeps the
    shape (a ``cumsum``): on a DTensor, ``fn`` runs on the local shard,
    any split of ``dim`` made whole first, and the result keeps that
    layout.  DTensor has no rule for the backward of ``cumsum`` (a
    ``flip``) in torch 2.11; a local step needs none."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    d = dim % x.ndim
    pl = tuple(Replicate() if p.is_shard() and p.dim % x.ndim == d else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


# ------------------------------------------------- vocab-parallel loss

def vocab_split(x) -> int | None:
    """The one mesh dim of more than one rank that splits ``x``'s last
    dim (the logits' vocab, on ``model``), or None: a plain tensor, a
    whole last dim, or a last dim split over several mesh dims."""
    if not is_dtensor(x):
        return None
    dims = [m for m, p in enumerate(x.placements)
            if p.is_shard() and p.dim in (-1, x.ndim - 1)
            and x.device_mesh.size(m) > 1]
    return dims[0] if len(dims) == 1 else None


def logz_and_pick(logits, labels):
    """``(logsumexp(logits, -1), logits[..., labels])`` for f32 logits
    whose vocab dim is split over one mesh dim (:func:`vocab_split`),
    computed from each rank's shard: the row maxima and the exponential
    sums are all-reduced over that mesh dim, and the label's logit is
    gathered on the rank that holds its column (0 elsewhere) and summed
    over it.  JAX sums against a one-hot constrained to the vocab on
    ``model``; this gathers instead, so no rank holds a one-hot, and the
    backward writes the local shard's gradient straight into one buffer
    of the logits' local size.  Both results are DTensors of
    ``labels.shape`` in the logits' batch layout, whole over the vocab's
    mesh dim."""
    return _LogzPick.apply(logits, labels)


def _row_placements(x):
    """``x``'s placements with the last dim's shards made whole."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_shard() and p.dim in (-1, x.ndim - 1)
                 else p for p in x.placements)


def _rows_out(local, mesh, placements, shape):
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


class _LogzPick(torch.autograd.Function):
    @staticmethod
    def forward(fctx, logits, labels):
        import torch.distributed as dist
        mesh, m = logits.device_mesh, vocab_split(logits)
        group = mesh.get_group(m)
        rows = _row_placements(logits)
        local = logits.to_local()
        V = logits.shape[-1]
        per = -(-V // mesh.size(m))              # torch.chunk's split
        lo = mesh.get_local_rank(m) * per
        idx = local_in(labels, mesh, rows).long() - lo
        here = (idx >= 0) & (idx < local.shape[-1])
        idx = torch.where(here, idx, torch.zeros_like(idx))
        top = local.amax(dim=-1)
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        sums = (local - top[..., None]).exp_().sum(dim=-1)
        dist.all_reduce(sums, group=group)
        logz = top + torch.log(sums)
        pick = torch.where(here, local.gather(-1, idx[..., None])[..., 0],
                           torch.zeros_like(logz))
        dist.all_reduce(pick, group=group)
        fctx.save_for_backward(local, logz, idx, here)
        fctx.layout = (mesh, tuple(logits.placements), rows,
                       tuple(logits.shape), tuple(logits.stride()))
        shape = tuple(labels.shape)
        return (_rows_out(logz, mesh, rows, shape),
                _rows_out(pick, mesh, rows, shape))

    @staticmethod
    def backward(fctx, g_logz, g_pick):
        from torch.distributed.tensor import DTensor
        local, logz, idx, here = fctx.saved_tensors
        mesh, placements, rows, shape, stride = fctx.layout
        g = (local - logz[..., None]).exp_()
        if g_logz is not None:
            g.mul_(local_in(g_logz, mesh, rows)[..., None])
        else:
            g.zero_()
        if g_pick is not None:
            gp = local_in(g_pick, mesh, rows) * here
            g.scatter_add_(-1, idx[..., None], gp[..., None])
        return DTensor.from_local(g, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=stride), None
