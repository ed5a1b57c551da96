"""Per-device cost of a traced step (the JAX package's
``launch/hlo_cost.py``; the name is kept so a reader finds the
counterpart).

JAX's analyzer walks the partitioned HLO text of a compiled step.  The port
compiles nothing: the dry run runs the step eagerly on ``meta`` tensors
under a ``DeviceMesh`` over a fake process group, and this module reads
that eager trace.  :class:`CostCounter` is a ``TorchDispatchMode``.  It
declines every op that has a ``DTensor`` operand, so DTensor handles the op
and the counter sees the local ops DTensor then runs on this rank's
shards, and the collectives it issues to redistribute them: the counts are
per device, as JAX's are after partitioning.  The ops DTensor runs on fake
tensors to propagate shapes (under a ``FakeTensorMode``) are skipped.  The
kernels, which compute nothing on ``meta`` operands, hand their calls in
through ``kernels/meta.py``.

Per device, :func:`analyze` gives JAX's keys:

  * ``dot_flops``: 2 M N K of every ``mm`` / ``bmm`` / ``addmm`` /
    ``baddbmm`` (``einsum`` and ``matmul`` reach the counter as these) and
    every kernel record's FLOPs; ``dot_flops_by_dtype`` splits them by the
    operands' type (kernel term products are ``bf16``), since on the card
    bf16 products run at the tensor-core rate and f32 products at the FP32
    rate (TF32 stays off);
  * ``bytes``: operands and result of every op and kernel record.  Eager
    PyTorch fuses nothing, so there is no fusion to exclude, as JAX's
    analyzer excludes fusion internals; views, allocations and the
    propagation ops move nothing and count nothing;
  * ``per_op_bytes`` and ``counts`` under JAX's collective names, over the
    functional collectives (``_c10d_functional.*`` and
    ``_dtensor.shard_dim_alltoall``, DTensor's) and the c10d ops
    (``c10d.allreduce_`` and kin: ``kernels/shmap.py``'s K plans):
    operand bytes, all-reduce doubled (ring = reduce-scatter +
    all-gather), as JAX's; ``per_device_bytes`` their sum, split into
    ``intra_node_bytes`` (a group inside one node of ``gpus_per_node``
    ranks) and ``inter_node_bytes``;
  * ``unknown_trip_counts``: always 0, since an eager trace has no loop to
    multiply: a Python loop runs its body as often as it runs;
  * ``memory``: live ``meta`` storage, tracked op by op, under JAX's
    ``argument_size_in_bytes`` (the step's inputs, this rank's shards),
    ``output_size_in_bytes`` (storage the step made that is still held at
    its end) and ``temp_size_in_bytes`` (the peak above both), and
    ``peak_size_in_bytes`` (the peak of all live storage, inputs included);
  * ``largest_allocation`` (the port's own): the bytes, shape and op of
    the largest single storage a local op made.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import meta as _meta

aten = torch.ops.aten

# 2 M N K per output element of each product op: (lhs, rhs) argument index
_DOTS = {
    aten.mm.default: (0, 1),
    aten.bmm.default: (0, 1),
    aten.addmm.default: (1, 2),
    aten.baddbmm.default: (1, 2),
}
_COLLECTIVES = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
}
# ops that move no data: allocations without a fill, and bookkeeping
_FREE = {
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten.detach.default,
    aten.alias.default, aten.lift_fresh.default,
}
_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.float64: "f64"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _size(t) -> int:
    return t.numel() * t.element_size()


def _fake_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _group_ranks(args, kwargs):
    """The ranks of a collective's group, from its group name (functional
    collectives) or its process group (c10d ops); None if neither
    resolves."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        try:
            if isinstance(a, str):
                return dist.get_process_group_ranks(
                    _resolve_process_group(a))
            if isinstance(a, dist.ProcessGroup):
                return dist.get_process_group_ranks(a)
        except (RuntimeError, ValueError, KeyError):
            return None
    return None


class CostCounter(TorchDispatchMode):
    """Counts the local ops of a traced step (see the module docstring).
    Enter it around the step, after the inputs exist, and give it the
    inputs with :meth:`add_arguments` so the memory counts know them."""

    def __init__(self, gpus_per_node: int = 8):
        super().__init__()
        self.gpus_per_node = gpus_per_node
        self.flops = collections.Counter()          # by operand dtype
        self.bytes = 0.0
        self.coll = collections.Counter()
        self.coll_counts = collections.Counter()
        self.node_bytes = collections.Counter()      # intra / inter
        self.top_coll: list = []
        self.top_dots: list = []
        self.ops = collections.Counter()
        self.kernels: dict[str, dict] = {}
        self._live: dict[int, int] = {}
        self._args: set[int] = set()
        self.argument_bytes = 0
        self._cur = 0
        self.peak = 0
        self.largest = (0, (), "")     # bytes, shape, op of one allocation
        self._sink = None

    # ------------------------------------------------------------ memory

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return key
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        self.peak = max(self.peak, self._cur)
        weakref.finalize(st, self._free, key)
        return key

    def _free(self, key):
        n = self._live.pop(key, None)
        if n is not None:
            self._cur -= n

    def add_arguments(self, tree):
        """Count the step's inputs (nested dicts, lists or tuples of
        tensors; DTensors by their local shard) as live arguments."""
        from torch.distributed.tensor import DTensor
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, (list, tuple)):
            for x in tree:
                self.add_arguments(x)
            return
        if isinstance(tree, DTensor):
            tree = tree.to_local()
        if isinstance(tree, torch.Tensor):
            key = self._track(tree)
            if key not in self._args:
                self._args.add(key)
                self.argument_bytes += self._live[key]

    def memory(self) -> dict:
        out = sum(n for k, n in self._live.items() if k not in self._args)
        return {"argument_size_in_bytes": int(self.argument_bytes),
                "output_size_in_bytes": int(out),
                "temp_size_in_bytes": int(max(
                    0, self.peak - self.argument_bytes - out)),
                "peak_size_in_bytes": int(self.peak)}

    # ------------------------------------------------------------ kernels

    def _kernel(self, rec: _meta.KernelRecord):
        self.flops["bf16"] += rec.flops
        self.bytes += rec.bytes
        k = self.kernels.setdefault(rec.kernel, {"launches": 0, "flops": 0.0,
                                                 "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += rec.flops
        k["bytes"] += rec.bytes
        self.top_dots.append((f"{rec.kernel} {rec.shapes} x{rec.terms}",
                              rec.flops))
        if len(self.top_dots) > 256:
            self._trim()

    def _trim(self):
        self.top_dots = sorted(self.top_dots, key=lambda t: -t[1])[:24]
        self.top_coll = sorted(self.top_coll, key=lambda t: -t[1])[:24]

    def __enter__(self):
        self._sink = _meta.recording(self._kernel)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._sink.__exit__(*exc)

    # --------------------------------------------------------------- ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # DTensor runs the local ops
        out = func(*args, **kwargs)
        if _fake_active():                  # DTensor's shape propagation
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._schema.name.replace("::", ".")
        self.ops[name] += 1
        for t in _tensors(out):
            if t.device.type == "meta":
                self._track(t)
                n = t.untyped_storage().nbytes()
                if n > self.largest[0]:
                    self.largest = (n, tuple(t.shape), name)
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            ob = sum(_size(t) for t in _tensors(args[0] if args else ()))
            factor = 2.0 if coll == "all-reduce" else 1.0
            self.coll[coll] += factor * ob
            self.coll_counts[coll] += 1
            ranks = _group_ranks(args[1:], kwargs)
            g = self.gpus_per_node
            intra = ranks is not None and len({r // g for r in ranks}) == 1
            self.node_bytes["intra" if intra else "inter"] += factor * ob
            self.top_coll.append((f"{coll} {ob}B", factor * ob))
            return
        if name.startswith("_c10d_functional.") or func.is_view \
                or func in _FREE:
            return
        moved = sum(_size(t) for t in _tensors(args)) + sum(
            _size(t) for t in _tensors(out))
        self.bytes += moved
        dot = _DOTS.get(func)
        if dot is not None:
            a, b = args[dot[0]], args[dot[1]]
            fl = 2.0 * a.shape[-2] * a.shape[-1] * b.shape[-1]
            if a.ndim == 3:
                fl *= a.shape[0]
            self.flops[_DTYPE_NAMES.get(a.dtype, str(a.dtype))] += fl
            self.top_dots.append(
                (f"{name} {tuple(a.shape)} x {tuple(b.shape)}", fl))
            if len(self.top_dots) > 256:
                self._trim()


def analyze(counter: CostCounter) -> dict:
    """JAX's ``analyze_hlo`` keys (and the port's extras) from a counter
    that has run over a step."""
    counter._trim()
    per_op = {k: float(v) for k, v in counter.coll.items()}
    return {
        "dot_flops": float(sum(counter.flops.values())),
        "dot_flops_by_dtype": {k: float(v) for k, v in counter.flops.items()},
        "bytes": float(counter.bytes),
        "per_op_bytes": per_op,
        "counts": dict(counter.coll_counts),
        "per_device_bytes": float(sum(per_op.values())),
        "intra_node_bytes": float(counter.node_bytes["intra"]),
        "inter_node_bytes": float(counter.node_bytes["inter"]),
        "unknown_trip_counts": 0,
        "top_collectives": counter.top_coll[:12],
        "top_dots": counter.top_dots[:12],
        "kernels": {k: dict(v) for k, v in counter.kernels.items()},
        "memory": counter.memory(),
        "largest_allocation": {"bytes": counter.largest[0],
                               "shape": list(counter.largest[1]),
                               "op": counter.largest[2]},
        "ops": sum(counter.ops.values()),
    }
