"""The port's dry run (``repro_torch/launch/dryrun.py``, ``hlo_cost.py``,
``step.py::lower_cell``, the kernels' ``meta`` route) on the CPU.

* The counter's exact counts: a Python loop of products (the mirror of
  ``tests/test_distribution.py::test_hlo_analyzer_trip_counts``), a
  column-sharded product on a fake world of 4, an all-gather, an all-reduce
  (doubled, as JAX's), and kernel 1's ``meta`` record, which launches
  nothing and runs no plain version.
* Coverage: every arch x shape traces at its smoke config on a (2, 2) fake
  world.

The parity with the JAX package is in ``test_torch_dryrun_parity.py``.

Each fake world is the process's default group only inside the fixture,
which destroys it.
"""
from __future__ import annotations

import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (LONG_CONTEXT_ARCHS, SHAPES, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_cost import CostCounter, analyze


@pytest.fixture
def fake_world():
    """``make(shape, names)``: a ``DeviceMesh`` over a fake group of
    ``prod(shape)`` ranks; the group is destroyed after the test."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()

    def make(shape, names=("data", "model")):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        return init_device_mesh("cpu", shape, mesh_dim_names=names)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _meta(*shape):
    return torch.empty(shape, device="meta")


# ----------------------------------------------------------- the counter

def test_counter_counts_a_python_loop_exactly():
    x, w = _meta(16, 64), _meta(8, 64, 64)
    counter = CostCounter()
    with counter:
        for i in range(8):
            x = torch.tanh(x @ w[i])
    res = analyze(counter)
    assert res["dot_flops"] == 2 * 16 * 64 * 64 * 8
    assert res["dot_flops_by_dtype"] == {"f32": 2 * 16 * 64 * 64 * 8}
    assert res["unknown_trip_counts"] == 0
    assert res["counts"] == {} and res["per_device_bytes"] == 0.0


def test_column_sharded_product_counts_a_quarter_per_device(fake_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_world((1, 4))
    a = DTensor.from_local(_meta(16, 64), mesh, [Replicate(), Replicate()],
                           run_check=False)
    b = DTensor.from_local(_meta(64, 8), mesh, [Replicate(), Shard(1)],
                           run_check=False)
    counter = CostCounter()
    with counter:
        c = a @ b
    assert tuple(c.shape) == (16, 32)
    assert analyze(counter)["dot_flops"] == 2 * 16 * 64 * 32 / 4


def test_shard_to_replicate_counts_one_all_gather_of_the_local_bytes(
        fake_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake_world((1, 4))
    x = DTensor.from_local(_meta(4, 64), mesh, [Replicate(), Shard(0)],
                           run_check=False)
    counter = CostCounter()
    with counter:
        y = x.redistribute(mesh, [Replicate(), Replicate()])
    res = analyze(counter)
    assert tuple(y.to_local().shape) == (16, 64)
    assert res["counts"] == {"all-gather": 1}
    assert res["per_op_bytes"] == {"all-gather": 4 * 64 * 4}
    assert res["per_device_bytes"] == 4 * 64 * 4
    # four ranks in one group of one node
    assert res["intra_node_bytes"] == 4 * 64 * 4


def test_all_reduce_counts_twice_its_bytes(fake_world):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = fake_world((16, 16))
    x = DTensor.from_local(_meta(8, 32), mesh, [Replicate(), Partial()],
                           run_check=False)
    counter = CostCounter()
    with counter:
        x.redistribute(mesh, [Replicate(), Replicate()])
        dist.all_reduce(_meta(10), group=mesh.get_group("model"))
    res = analyze(counter)
    assert res["counts"] == {"all-reduce": 2}
    assert res["per_op_bytes"] == {"all-reduce": 2.0 * (8 * 32 * 4 + 40)}
    # a 16-wide model axis spans two nodes of 8
    assert res["inter_node_bytes"] == res["per_device_bytes"]


def test_kernel_meta_calls_record_and_launch_nothing(monkeypatch):
    from repro_torch.core import pdot
    from repro_torch.kernels import (tcec_attention, tcec_matmul,
                                     tcec_paged_attention)

    def refuse(*a, **k):
        raise AssertionError("a meta operand reached a plain version or "
                             "a launch")
    for mod, names in ((tcec_matmul, ("_plain", "enqueue")),
                       (tcec_attention, ("_plain_core", "_entry")),
                       (tcec_paged_attention, ("_plain_core", "_enqueue"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    before = (tcec_matmul.launches, tcec_attention.launches,
              tcec_paged_attention.launches)
    counter = CostCounter()
    with counter:
        out = pdot("mk,kn->mn", _meta(128, 256), _meta(256, 64),
                   "tcec_bf16x6")
        att = tcec_attention.tcec_attention_plain(
            _meta(2, 64, 8, 32), _meta(2, 96, 4, 32), _meta(2, 96, 4, 16),
            policy="tcec_bf16x3")
        pg = tcec_paged_attention.tcec_paged_attention(
            _meta(3, 8, 32), _meta(20, 16, 4, 32), _meta(20, 16, 4, 32),
            torch.empty((3, 5), dtype=torch.int32, device="meta"),
            torch.empty((3,), dtype=torch.int32, device="meta"),
            policy="tcec_bf16x10")
    assert (out.shape, out.device.type) == ((128, 64), "meta")
    assert att.shape == (2, 64, 8, 16) and pg.shape == (3, 8, 32)
    assert (tcec_matmul.launches, tcec_attention.launches,
            tcec_paged_attention.launches) == before
    k = analyze(counter)["kernels"]
    assert k["tcec_matmul"] == {"launches": 1, "flops": 6 * 2 * 128 * 64 * 256,
                                "bytes": 4 * (128 * 256 + 256 * 64
                                              + 128 * 64)}
    assert k["tcec_attention"]["flops"] == 3 * 2 * 2 * 8 * 64 * 96 * (32 + 16)
    assert k["tcec_paged_attention"]["flops"] == \
        10 * 2 * 3 * 8 * (5 * 16) * (32 + 32)


# ------------------------------------------------------------- coverage

def _overrides(arch):
    """None (the smoke config), but the SSM families take the full
    config's chunk (256): the smoke config's 16-position chunk makes 2048
    chunk iterations a layer at 32k positions, minutes of tracing on the
    CPU."""
    smoke = get_smoke_config(arch)
    if smoke.family in ("ssm", "hybrid"):
        return {"ssm_chunk": get_config(arch).ssm_chunk}
    return None


@pytest.mark.parametrize("arch", list_archs())
def test_every_shape_traces_on_a_2x2_fake_world(arch, fake_world):
    mesh = fake_world((2, 2))
    for shape in SHAPES:
        rec = dryrun.run_cell(arch, shape, False, mesh_override=mesh,
                              overrides=_overrides(arch), smoke=True)
        if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
            assert rec["status"] == "skip"
            continue
        assert rec["status"] == "ok" and rec["chips"] == 4
        assert rec["kind"] == SHAPES[shape].kind
        assert rec["hlo_flops_per_device"] > 0
        assert rec["bottleneck"] in ("compute", "memory", "collective")
        assert rec["memory"]["peak_size_in_bytes"] >= \
            rec["memory"]["argument_size_in_bytes"] > 0


# ------------------------------------------------- the vocab-parallel loss

def test_train_step_allocates_no_global_logits(fake_world):
    """qwen3's smoke train step on a (2, 2) fake world: the loss keeps the
    logits' vocab split over ``model`` in its forward and backward, so no
    local op makes a tensor of the global (B, S, V) f32 size (the loss's
    label gather used to make one of zeros in its backward).  The largest
    allocation left is kernel 1's N plan for the unembedding's input
    gradient (JAX's plan: the logits' gradient whole over the vocab, the
    size of a local (B / data, S, V) tensor).  The vocab is widened to 8192
    so that the logits, not a weight, are the step's largest tensors, as
    they are at full width."""
    from repro_torch.launch.step import lower_cell
    cfg = get_smoke_config("qwen3-0.6b").replace(vocab_size=8192)
    shape = SHAPES["train_4k"].__class__("t", 64, 8, "train")
    rec, kind = lower_cell(cfg, shape, fake_world((2, 2)))
    assert kind == "train"
    B, S, V = shape.global_batch, shape.seq_len, cfg.padded_vocab
    big = rec["largest_allocation"]
    assert big["bytes"] < 4 * B * S * V, big
    assert big["bytes"] <= 4 * (B // 2) * S * V, big


def test_cross_entropy_allocates_at_most_the_local_logits_shard(
        fake_world):
    """``lm.cross_entropy`` and its backward on vocab-split logits (meta,
    (16, 64, 4096) on a (2, 2) fake world): nothing larger than the local
    (B / data, S, V / model) shard, and no all-gather: the vocab stays
    split, only (B / data, S) rows are all-reduced."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.lm import cross_entropy
    from repro_torch.parallel import ctx
    mesh = fake_world((2, 2))
    B, S, V = 16, 64, 4096
    logits = DTensor.from_local(
        _meta(B // 2, S, V // 2), mesh, [Shard(0), Shard(2)],
        run_check=False).requires_grad_()
    labels = DTensor.from_local(
        torch.empty((B // 2, S), dtype=torch.int64, device="meta"), mesh,
        [Shard(0), Replicate()], run_check=False)
    counter = CostCounter()
    counter.add_arguments([logits, labels])
    with ctx.use_mesh(mesh), counter:
        loss, _ = cross_entropy(logits, labels)
        (g,) = torch.autograd.grad(loss, logits)
    res = analyze(counter)
    assert tuple(g.placements) == (Shard(0), Shard(2))
    assert res["largest_allocation"]["bytes"] <= 4 * (B // 2) * S * (V // 2)
    assert res["counts"].get("all-gather", 0) == 0
