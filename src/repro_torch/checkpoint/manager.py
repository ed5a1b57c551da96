"""Checkpoints with atomic commits, keep-k retention, integrity hashes and
resume, in the JAX package's on-disk layout (``checkpoint/manager.py``), so
either package restores what the other wrote:

    <dir>/step_<n>/
        manifest.json       (step, leaf paths joined by "/", shapes,
                             dtypes, sha256 of each file's bytes)
        <leaf-hash>.npy     (one file per leaf, named sha1(path)[:16])

Leaves are nested dicts of tensors, walked in sorted key order as JAX
flattens a dict.  bf16 and fp8 leaves are stored as their raw bits under a
same-width unsigned integer view (``.npy`` has no such dtypes); the
manifest keeps the real dtype's name.  A checkpoint is written to
``step_<n>.tmp`` and renamed into place, so a crashed writer never leaves a
loadable but partial checkpoint.

Checkpoints are mesh-agnostic: a DTensor leaf is saved whole (gathered;
rank 0 writes), and :func:`restore` with ``shardings`` lays each leaf out
on a mesh, any mesh whose axes divide the dims (JAX's elastic restart,
``manager.py`` :76-95).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.bridge import numpy_from_tensor

# dtypes .npy cannot hold, stored as raw bits: manifest name -> torch dtype
_RAW = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
        "float8_e5m2": torch.float8_e5m2}


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_paths(tree[k], prefix + (str(k),))
        return out
    return [("/".join(prefix), tree)]


def _fname(path: str) -> str:
    return hashlib.sha1(path.encode()).hexdigest()[:16] + ".npy"


def _to_numpy(t: torch.Tensor):
    """``(array as stored, dtype name)``: bf16 / fp8 as unsigned bits."""
    arr = numpy_from_tensor(t)
    name = str(t.dtype).split(".")[1]
    if name in _RAW:
        arr = arr.view(f"uint{8 * arr.itemsize}")
    return arr, name


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier():
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomically save a tree of tensors.  Returns the final directory.
    DTensor leaves are gathered whole on every rank (a collective: every
    rank calls this), rank 0 writes, and the ranks meet again after."""
    from repro_torch.parallel import ctx
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    leaves = [(path, ctx.full(leaf)) for path, leaf in _leaf_paths(tree)]
    if _rank() != 0:
        _barrier()
        return final
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for path, leaf in leaves:
        arr, dtype_name = _to_numpy(leaf)
        fn = _fname(path)
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][path] = {
            "file": fn, "shape": list(arr.shape), "dtype": dtype_name,
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _barrier()
    return final


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def check_fits(ckpt_dir: str, step: int, like_tree) -> dict:
    """The manifest of checkpoint ``step``, once its leaf paths and shapes
    equal those of ``like_tree`` (any leaves with a ``shape``).  Otherwise
    a ``ValueError`` names the first leaf, in sorted path order, that is
    missing on either side or has another shape: the checkpoint is of
    another model, and nothing has been read but its manifest."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    have = {p: tuple(m["shape"]) for p, m in manifest["leaves"].items()}
    want = {p: tuple(leaf.shape) for p, leaf in _leaf_paths(like_tree)}
    for path in sorted(have.keys() | want.keys()):
        if have.get(path) != want.get(path):
            raise ValueError(
                f"checkpoint {d} does not fit this model: leaf {path} has "
                f"shape {have.get(path, 'none (absent)')} there, "
                f"{want.get(path, 'none (absent)')} in the model")
    return manifest


def restore(ckpt_dir: str, step: int, like_tree, device=None,
            verify: bool = True, shardings=None):
    """Restore into the structure of ``like_tree`` (any leaves with a
    ``shape``: tensors on the ``meta`` device will do), onto ``device``
    (default: the CPU).  :func:`check_fits` holds the leaves' paths and
    shapes against the manifest before any file is read, so a checkpoint
    of another model is refused at once.  With ``shardings`` (a
    :class:`parallel.sharding.NamedSharding` tree of the same structure)
    each leaf becomes a DTensor on that sharding's mesh, this rank keeping
    its slice: the elastic restart, onto a mesh other than the writer's."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = check_fits(ckpt_dir, step, like_tree)

    def load(path, leaf):
        meta = manifest["leaves"][path]
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and (hashlib.sha256(arr.tobytes()).hexdigest()
                       != meta["sha256"]):
            raise IOError(f"checkpoint corruption at {path}")
        if meta["dtype"] in _RAW:               # raw-bits integer view
            t = torch.from_numpy(arr.view(f"int{8 * arr.itemsize}").copy())
            t = t.view(_RAW[meta["dtype"]])
        else:
            t = torch.from_numpy(arr.copy())
        return t.to(device) if device is not None else t

    def build(tree, sh, prefix=()):
        if isinstance(tree, dict):
            return {k: build(v, None if sh is None else sh[k],
                             prefix + (str(k),)) for k, v in tree.items()}
        t = load("/".join(prefix), tree)
        if sh is None:
            return t
        from repro_torch.parallel.sharding import distribute
        return distribute(t, sh.mesh, sh.placements)

    return build(like_tree, shardings)


def retain(ckpt_dir: str, keep: int = 3):
    """Delete all but the newest ``keep`` checkpoints."""
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
