"""Mesh construction (the JAX package's ``launch/mesh.py``):
:func:`make_production_mesh`, the dry run's mesh over a fake world, and
:func:`make_host_mesh`, a mesh over the ranks that really run.

Functions, not module-level constants: importing this module touches no
process group and no device.  JAX's ``TPU_XLA_FLAGS`` (XLA compiler flags
for collective overlap on a TPU) is not ported: the port has no XLA.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _init_world(backend: str):
    """Start the default process group: torchrun's (its environment and
    localhost rendezvous) when torchrun launched this process, else a world
    of this one rank over an in-process ``HashStore``."""
    if dist.is_torchelastic_launched():
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def production_shape(multi_pod: bool = False, world: int = 0):
    """``(shape, names)`` of the production mesh: JAX's ``(16, 16)``
    ``("data", "model")`` or ``(2, 16, 16)`` ``("pod", "data", "model")``.
    A ``world`` other than 0 (``REPRO_DRYRUN_DEVICES``, for tests) shrinks
    it: two pods when the world is even and the mesh is multi-pod, a model
    axis as large as divides what is left (at most 16), the rest data."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    if not world:
        return shape, names
    pod = 2 if multi_pod and world % 2 == 0 else 1
    rest = world // pod
    model = max(d for d in range(1, min(16, rest) + 1) if rest % d == 0)
    dims = (rest // model, model)
    return ((pod,) + dims if multi_pod else dims), names


def make_production_mesh(*, multi_pod: bool = False):
    """The dry run's mesh: ``(16, 16)`` ``("data", "model")`` over 256
    ranks, or ``(2, 16, 16)`` ``("pod", "data", "model")`` over 512, a
    ``DeviceMesh`` over a fake process group (``torch.distributed``'s
    ``fake`` backend), as JAX's is a mesh of placeholder devices.  Nothing
    on it stores or moves data: its collectives return at once, and the
    dry run's tensors are ``meta``.  The mesh's device type is ``cpu``
    (DTensor needs a device module for it), so DTensor runs each of its
    all-to-alls as an all-gather of the same operand, as it does over gloo;
    the counter then sees an all-gather of the all-to-all's bytes.  This
    process is rank 0.

    ``REPRO_DRYRUN_DEVICES`` (read through ``numerics.env_value``) shrinks
    the world for tests (:func:`production_shape`).  The fake group
    becomes the process's default group, so a live group of another
    backend makes this raise; a fake group of another size is replaced."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import numerics
    shape, names = production_shape(
        multi_pod, numerics.env_value("REPRO_DRYRUN_DEVICES"))
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "make_production_mesh: a process group of backend "
                f"{dist.get_backend()!r} is live; the dry run's fake world "
                "would replace it as the default group")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_host_mesh(model: int = 1, *, backend: str | None = None,
                   device=None):
    """A ``(world // model, model)`` ``DeviceMesh`` over the ranks, dims
    ``("data", "model")``.

    ``device`` is ``cuda`` unless the caller asks for the CPU.  The backend
    is chosen here and never switched: ``nccl`` by default on ``cuda``
    (``gloo`` on the CPU, where NCCL does not run).  NCCL refuses two ranks
    on one card, so a world with more ranks than visible cards raises,
    naming ``backend="gloo"``; over gloo, collectives cannot be captured in
    a CUDA graph (the engine then decodes eagerly).  A process group that
    already exists is used as it is, and must have the backend asked for.
    Each rank's card is ``cuda:(rank % cards)``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA device; pass "
                           "device='cpu'")
    if not dist.is_initialized():
        _init_world(backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, "
                         f"not {backend}")
    n = dist.get_world_size()
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and n > cards:
            raise ValueError(
                f"{n} ranks on {cards} visible card(s): NCCL takes one "
                "rank a card; pass backend=\"gloo\" to run them over gloo")
        torch.cuda.set_device(dist.get_rank() % cards)
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world of "
                         f"{n} ranks")
    return init_device_mesh(dev.type, (n // model, model),
                            mesh_dim_names=("data", "model"))
