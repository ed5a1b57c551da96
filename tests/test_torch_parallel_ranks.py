"""The parallel layer on two ranks: one spawned gloo battery on the CPU.

Two processes (``torch.multiprocessing``, rendezvous through a
``FileStore`` under the test's temporary directory, so that pytest workers
never share a port) each run, on ``(1, 2)`` and ``(2, 1)`` meshes:

  * the kernel battery of ``chip_smoke.py`` phase 17c at smoke sizes (the
    kernels' plain versions): each rank's shard of an N, M, batch, heads,
    q-sequence or paged plan is bitwise its slice of the unsharded call;
    a K plan (local fold, then one f32 all-reduce) is within
    ``1e-5 * max(scale, 1)``, the bound of JAX's battery;
  * the engine of phase 17d at the smoke config on ``(1, 2)``: greedy
    tokens equal the unsharded engine's wherever the unsharded top-2 gap
    exceeds 2e-3, and a teacher-forced prefill of the unsharded run's
    tokens has logits within 1e-3 (relative) of the unsharded ones;
  * the train step at the smoke config on both meshes: loss within 1e-5
    relative and every gradient within 1e-3 of its ``max|g|``, with the
    parameters (``(1, 2)``) or the batch (``(2, 1)``) really split;
  * ``compressed_psum`` across the ranks: the f32 sum of the two ranks'
    bf16-rounded values, bitwise, and each rank's residual;
  * in a second battery, every non-dense family's train step on both
    meshes (:func:`_family_train`) and the vocab-parallel
    ``lm.cross_entropy`` (:func:`_vocab_parallel_loss`).

The unsharded references are computed in each rank on the same seeded
inputs.  No JAX here: ``tests/test_torch_parallel.py`` holds the one-rank
paths to JAX.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _local(ref, mesh, placements):
    from repro_torch.parallel.sharding import local_shard
    return local_shard(ref, mesh, placements)


def _place(t, mesh, spec):
    from repro_torch.parallel import sharding as shd
    return shd.distribute(t, mesh, shd.to_placements(spec, mesh))


def _kernel_battery(mesh12, mesh21):
    from repro_torch.kernels import dispatch, shmap
    from repro_torch.kernels.tcec_matmul import tcec_matmul_plain
    pol = "tcec_bf16x6"
    cases = [(mesh12, (64, 64), (64, 96), "N"),
             (mesh12, (64, 96), (96, 65), "K"),
             (mesh12, (64, 65), (65, 63), "M"),
             (mesh21, (4, 16, 32), (4, 32, 24), "batch"),
             (mesh21, (64, 32), (32, 24), "M")]
    for i, (mesh, ash, bsh, kind) in enumerate(cases):
        a, b = _rand(ash, 10 + i), _rand(bsh, 20 + i)
        plan = shmap.matmul_plan(a.shape, b.shape, mesh)
        assert plan.sharded_dim == kind, (kind, plan)
        ref = tcec_matmul_plain(a, b, pol)
        out = shmap.sharded_matmul(_place(a, mesh, plan.a_spec),
                                   _place(b, mesh, plan.b_spec), policy=pol,
                                   mesh=mesh, plan=plan)
        mine = _local(ref, mesh, out.placements)
        if kind == "K":
            scale = float(ref.abs().max())
            assert float((out.to_local() - mine).abs().max()) <= \
                1e-5 * max(scale, 1.0)
        else:
            assert torch.equal(out.to_local(), mine), kind
    # attention: heads (Hkv 4 on 2 ranks) and q sequence (3 heads)
    for mode, (H, Hkv) in (("heads", (8, 4)), ("qseq", (3, 1))):
        q, k, v = (_rand((2, 64, H, 32), 30), _rand((2, 64, Hkv, 32), 31),
                   _rand((2, 64, Hkv, 32), 32))
        plan = shmap.attention_plan(q.shape, k.shape, mesh12)
        assert plan.mode == mode
        ref = dispatch._attention_local(q, k, v, None, None, pol, True, 17,
                                        None, dispatch._cfg(None))
        out = shmap.sharded_attention(
            _place(q, mesh12, plan.q_spec), _place(k, mesh12, plan.k_spec),
            _place(v, mesh12, plan.v_spec), policy=pol, window=17,
            mesh=mesh12, plan=plan)
        assert torch.equal(out.to_local(),
                           _local(ref, mesh12, out.placements)), mode
    # paged decode, pools sharded on KV heads
    rng = np.random.default_rng(12)
    B, Hkv, rep, hd, ps, maxp, NP = 2, 4, 2, 32, 8, 4, 9
    q = _rand((B, Hkv * rep, hd), 13)
    kp = _rand((NP, ps, Hkv, hd), 14).bfloat16()
    vp = _rand((NP, ps, Hkv, hd), 15).bfloat16()
    bt = torch.from_numpy((rng.permutation(8).reshape(B, maxp) + 1)
                          .astype(np.int32))
    lens = torch.tensor([25, 30], dtype=torch.int32)
    plan = shmap.paged_plan(q.shape, kp.shape, mesh12)
    ref = dispatch._paged_local(q, kp, vp, bt, lens, pol, 0, None,
                                dispatch._cfg(None))
    out = shmap.sharded_paged_attention(
        _place(q, mesh12, plan.q_spec), _place(kp, mesh12, plan.pool_spec),
        _place(vp, mesh12, plan.pool_spec), bt, lens, policy=pol,
        mesh=mesh12, plan=plan)
    assert torch.equal(out.to_local(), _local(ref, mesh12, out.placements))


def _engine(mesh12, cfg, params):
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.serving import Engine, SamplingParams
    rng = np.random.default_rng(7)
    prompts = [list(rng.integers(0, cfg.vocab_size, n)) for n in (5, 9, 12)]
    sp = SamplingParams(temperature=0.0, max_tokens=6)
    base = Engine(cfg, params, max_slots=2, device="cpu").run(prompts, sp)
    sharded = shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh12, cfg), mesh12))
    assert any(leaf.to_local().shape != leaf.shape
               for leaf in tree_leaves(sharded))
    eng = Engine(cfg, sharded, max_slots=2, device="cpu", mesh=mesh12)
    out = eng.run(prompts, sp)
    assert eng.stats()["decode_graph"] is False
    model = get_model(cfg)
    for rid, p in enumerate(prompts):
        seq = torch.tensor([p + list(base[rid])])
        ref, _ = model.prefill(params, seq)
        with ctx.use_mesh(mesh12):
            got, _ = model.prefill(sharded, seq)
        got = ctx.full(got)
        assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-3
        # greedy tokens agree wherever the unsharded top-2 gap is clear
        rows = ref[0, len(p) - 1:-1, :cfg.vocab_size]
        top2 = rows.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2e-3
        want, have = list(base[rid]), list(out[rid])
        for j in range(len(want)):
            if not clear[j]:
                break
            assert have[j] == want[j], (rid, j)


def _train(mesh, cfg, params, kind):
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (4, 32))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    model = get_model(cfg)

    def grads(p, b):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = model.loss_fn(p, b)
        return loss, torch.autograd.grad(loss, tree_leaves(p))

    ref_loss, ref_g = grads(params, batch)
    sharded = shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh, cfg), mesh))
    bsh = shd.shard_tree(batch, shd.to_shardings(
        shd.batch_specs(cfg, mesh, batch), mesh))
    if kind == "params":
        assert any(leaf.to_local().shape != leaf.shape
                   for leaf in tree_leaves(sharded))
    else:
        assert bsh["tokens"].to_local().shape[0] == 2
    with ctx.use_mesh(mesh, shd.batch_axes(cfg, mesh)):
        loss, g = grads(sharded, bsh)
    loss = float(ctx.full(loss))
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    for a, b in zip(g, ref_g):
        a = ctx.full(a)
        assert float((a - b).abs().max()) <= 1e-3 * max(
            float(b.abs().max()), 1e-30)


MOE_GRAD_REL = 2.0 ** -8


def _family_train(mesh, cfg, params, kind):
    """:func:`_train` for any family, on a 4-row batch of
    ``data.pipeline`` (frames and patches for the enc-dec and VLM
    families): the loss within 1e-5 relative of the unsharded loss, every
    gradient within 1e-3 of its ``max|g|``.  The MoE family's gradients
    are held at 2^-8: its dispatch and combine products run the ``bf16``
    policy, whose backward rounds the cotangent to bf16, so any reordered
    f32 sum upstream moves a gradient by up to a bf16 rounding (scaling
    the unsharded loss by 1 + 2^-20 alone moves granite's and deepseek's
    smoke gradients by 5e-4 of their ``max|g|``, qwen3's by 3e-7); 2^-8
    is the MoE layer's own gate on the card."""
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    seq = 2 * cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 32
    batch = device_batch(cfg, DataConfig(seed=3, global_batch=4,
                                         seq_len=seq), 0, "cpu")
    model = get_model(cfg)

    def grads(p, b):
        p = tree_map(lambda t: t.detach().requires_grad_(), p)
        loss, _ = model.loss_fn(p, b)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(p))

    ref_loss, ref_g = grads(params, batch)
    sharded = shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh, cfg), mesh))
    bsh = shd.shard_tree(batch, shd.to_shardings(
        shd.batch_specs(cfg, mesh, batch), mesh))
    if kind == "params":
        assert any(leaf.to_local().shape != leaf.shape
                   for leaf in tree_leaves(sharded))
    else:
        assert bsh["tokens"].to_local().shape[0] == 2
    with ctx.use_mesh(mesh, shd.batch_axes(cfg, mesh)):
        loss, g = grads(sharded, bsh)
    loss = float(ctx.full(loss))
    assert abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)), \
        (cfg.name, kind)
    rel = MOE_GRAD_REL if cfg.family == "moe" else 1e-3
    for a, b in zip(g, ref_g):
        a = ctx.full(a)
        assert float((a - b).abs().max()) <= rel * max(
            float(b.abs().max()), 1e-30), (cfg.name, kind)


def _vocab_parallel_loss(mesh):
    """``lm.cross_entropy`` on logits whose vocab is split over two ranks
    (and, on ``(2, 1)``, whose batch is): the loss within 1e-6 relative of
    the unsharded loss, the logits' gradient within 1e-6 of ``max|g|``,
    and the gradient left split as the logits are."""
    from repro_torch.models.lm import cross_entropy
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 8, 384, generator=g) * 3
    labels = torch.randint(0, 384, (4, 8), generator=g)
    labels[0, :3] = -1
    x = logits.clone().requires_grad_()
    ref, _ = cross_entropy(x, labels)
    (ref_g,) = torch.autograd.grad(ref, x)
    placements = shd.to_placements(shd.P("data", None, "model"), mesh)
    xd = shd.distribute(logits, mesh, placements).requires_grad_()
    with ctx.use_mesh(mesh):
        split = ctx.vocab_split(xd) is not None
        loss, _ = cross_entropy(xd, labels)
        (gd,) = torch.autograd.grad(loss, xd)
    assert split == (mesh.size(1) > 1)
    assert tuple(gd.placements) == placements
    loss = float(ctx.full(loss.detach()))
    assert abs(loss - float(ref)) <= 1e-6 * abs(float(ref))
    assert float((ctx.full(gd) - ref_g).abs().max()) <= \
        1e-6 * float(ref_g.abs().max())


def _families(rank, store_path, world):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import numerics
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import get_model
        mesh12 = init_device_mesh("cpu", (1, 2),
                                  mesh_dim_names=("data", "model"))
        mesh21 = init_device_mesh("cpu", (2, 1),
                                  mesh_dim_names=("data", "model"))
        with numerics.use(interpret=True):
            _vocab_parallel_loss(mesh12)
            _vocab_parallel_loss(mesh21)
            for arch in FAMILIES:
                cfg = get_smoke_config(arch)
                params = get_model(cfg).init(0, device="cpu")
                _family_train(mesh12, cfg, params, "params")
                _family_train(mesh21, cfg, params, "batch")
    finally:
        dist.destroy_process_group()


FAMILIES = ("granite-moe-1b-a400m", "deepseek-v3-671b", "mamba2-130m",
            "zamba2-1.2b", "seamless-m4t-large-v2", "internvl2-2b")


def _battery(rank, store_path, world):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import numerics
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import get_model
        from repro_torch.parallel.collectives import (compressed_psum,
                                                      zeros_like_residual)
        mesh12 = init_device_mesh("cpu", (1, 2),
                                  mesh_dim_names=("data", "model"))
        mesh21 = init_device_mesh("cpu", (2, 1),
                                  mesh_dim_names=("data", "model"))
        with numerics.use(interpret=True):
            _kernel_battery(mesh12, mesh21)
            cfg = get_smoke_config("qwen3-0.6b")
            params = get_model(cfg).init(0, device="cpu")
            _engine(mesh12, cfg, params)
            _train(mesh12, cfg, params, "params")
            _train(mesh21, cfg, params, "batch")
        g = {"w": torch.full((64,), 1.0 + 2.0 ** -12) * (rank + 1)}
        res = zeros_like_residual(g)
        for _ in range(3):
            red, res = compressed_psum(g, res)
        g32 = [torch.full((64,), 1.0 + 2.0 ** -12) * (r + 1)
               for r in range(world)]
        r32 = [torch.zeros(64) for _ in range(world)]
        for _ in range(3):
            lows = [(x + r).bfloat16() for x, r in zip(g32, r32)]
            r32 = [x + r - lo.float() for x, r, lo in zip(g32, r32, lows)]
            total = lows[0].float() + lows[1].float()
        assert torch.equal(red["w"], total)
        assert torch.equal(res["w"], r32[rank])
    finally:
        dist.destroy_process_group()


def _spawn(fn, tmp_path):
    import torch.multiprocessing as mp
    store = str(tmp_path / "store")
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        mp.start_processes(fn, args=(store, 2), nprocs=2, join=True,
                           start_method="spawn")
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env


def test_two_rank_gloo_battery(tmp_path):
    _spawn(_battery, tmp_path)


def test_two_rank_family_train_steps_and_vocab_parallel_loss(tmp_path):
    """Every non-dense family's smoke train step on ``(1, 2)`` (parameters
    split) and ``(2, 1)`` (batch split), and the vocab-parallel loss on
    both meshes."""
    _spawn(_families, tmp_path)
