"""Host mesh construction (the JAX package's ``launch/mesh.py``
``make_host_mesh``).

A function, not a module-level constant: importing this module touches no
process group and no device.  JAX's ``make_production_mesh`` (the dry
run's 512-chip mesh) and ``TPU_XLA_FLAGS`` (XLA only) are not here: they
belong with the dry run.
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
