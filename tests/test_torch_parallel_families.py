"""Every non-dense family under a one-rank mesh, against the port unsharded
and against the JAX package, on the CPU.

For granite-moe-1b-a400m, deepseek-v3-671b (MLA and the MTP head),
mamba2-130m, zamba2-1.2b, seamless-m4t-large-v2 and internvl2-2b at their
smoke configs, weights from JAX's ``init`` through ``bridge``, on a
``(1, 1)`` ``("data", "model")`` mesh over gloo (an in-process store):

  * the serving path (the engine for the MoE family, ``generate_dense``
    for the others) gives the port's unsharded greedy tokens and JAX's
    ``generate_dense`` tokens;
  * ``make_sharded_train_step``'s loss and every parameter and moment are
    bitwise the unsharded step's, and the loss is within 2^-13 relative of
    JAX's unsharded ``loss_fn`` on the same batch (frames and patches
    included);
  * the serve CLI with ``--mesh-model 1 --backend gloo`` prints the tokens
    it prints without a mesh;
  * ``kernels/shmap.py``'s plans at the families' full-width shapes
    (kernel 2 at hd 64, MLA's 192 / 128 and non-causal; kernel 1's
    batched expert products; kernel 3 at hd 64) equal JAX's on
    shape-only meshes.

``tests/test_torch_parallel_ranks.py`` runs the train steps on two ranks.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import shmap as jshmap  # noqa: E402
from repro.launch.serve import \
    generate_dense as jax_generate_dense  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, host_batch  # noqa: E402
from repro_torch.kernels import shmap  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.step import (make_sharded_train_step,  # noqa: E402
                                     make_train_step)
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import ctx  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

class FakeMesh:
    """Shape-only mesh stand-in (no ranks), JAX's test double."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = [FakeMesh(data=d, model=m) for d in (1, 2, 16)
          for m in (1, 2, 4, 8, 16)] + [FakeMesh(pod=2, data=16, model=16)]

ARCHS = ["granite-moe-1b-a400m", "deepseek-v3-671b", "mamba2-130m",
         "zamba2-1.2b", "seamless-m4t-large-v2", "internvl2-2b"]
ENGINE = ("granite-moe-1b-a400m", "deepseek-v3-671b")
REL = 2.0 ** -13


@pytest.fixture(scope="module")
def mesh():
    """A one-rank ``(data, model)`` mesh over gloo; the process group is
    torn down after the module."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    m = make_host_mesh(1, device="cpu")
    yield m
    dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _smoke(arch):
    """(JAX config, JAX params, port config, bridged params)."""
    jcfg = jax_smoke_config(arch)
    jparams = jax.jit(jax_get_model(jcfg).init)(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(arch), params


def _sharded(params, mesh, cfg):
    return shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh, cfg), mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_tokens_under_mesh_equal_unsharded_and_jax(arch, mesh):
    """3 prompts of 16 tokens, 6 greedy tokens each (``test_torch_mla``'s
    prompts, where deepseek's engine and dense oracle route alike).  The
    MoE family runs the engine (``generate``: one slot a prompt,
    prefilled together) with its pools laid out by ``_pool_spec``; the
    others ``generate_dense`` with the cache laid out by
    ``cache_specs``."""
    jcfg, jparams, cfg, params = _smoke(arch)
    prompts = np.random.default_rng(10).integers(0, cfg.vocab_size, (3, 16))
    ref = np.asarray(jax_generate_dense(jcfg, jparams, jnp.asarray(prompts),
                                        6))
    run = serve.generate if arch in ENGINE else serve.generate_dense
    base = run(cfg, params, prompts, 6, device="cpu")
    sharded = _sharded(params, mesh, cfg)
    shmap.reset_counters()
    with ctx.use_mesh(mesh):
        out = run(cfg, sharded, prompts, 6, device="cpu")
    calls = shmap.counters()
    assert calls["matmul"] > 0
    if arch in ENGINE:
        assert calls["paged"] > 0 or cfg.use_mla
    assert out.tolist() == base.tolist() == ref.tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_bitwise_and_near_jax(arch, mesh):
    """One AdamW step on a 2 x 32 batch of ``data.pipeline`` (frames and
    patches for the enc-dec and VLM families)."""
    jcfg, jparams, cfg, params = _smoke(arch)
    opt = adamw.OptConfig(lr=1e-3)
    seq = 32 if cfg.family not in ("ssm", "hybrid") else 2 * cfg.ssm_chunk
    host = host_batch(cfg, DataConfig(seed=4, global_batch=2, seq_len=seq),
                      0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in host.items()}
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    ref, rmet = make_train_step(cfg, opt)(state, batch)
    step, sh, sharder = make_sharded_train_step(cfg, opt, mesh)
    shmap.reset_counters()
    new, met = step(shd.shard_tree(state, sh), sharder(batch))
    assert shmap.counters()["matmul"] > 0
    assert all(not ctx.is_dtensor(v) for v in met.values())
    assert sorted(met) == sorted(rmet)
    for k in rmet:
        assert torch.equal(met[k], rmet[k]), k
    for a, b in zip(tree_leaves(new), tree_leaves(ref)):
        assert torch.equal(ctx.full(a), b)
    jloss, _ = jax_get_model(jcfg).loss_fn(
        jparams, {k: jnp.asarray(v) for k, v in host.items()})
    assert abs(float(met["loss"]) - float(jloss)) <= REL * abs(float(jloss))


@pytest.mark.parametrize("arch", ["mamba2-130m", "seamless-m4t-large-v2"])
def test_serve_cli_under_mesh_prints_the_unsharded_tokens(arch, mesh,
                                                          capsys):
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen", "4"]

    def sample():
        lines = capsys.readouterr().out.splitlines()
        return [ln for ln in lines if ln.startswith("sample:")]

    serve.main(args)
    want = sample()
    serve.main(args + ["--mesh-model", "1", "--backend", "gloo"])
    got = sample()
    assert len(want) == 1 and got == want


def _fields(plan):
    return None if plan is None else {
        k: tuple(v) if k.endswith("spec") else v
        for k, v in vars(plan).items()}


# the families' full-width shapes of each kernel (batch 8, 512 positions)
PLAN_CASES = [
    # kernel 2: hd 64 (padded inside) for granite and zamba2, MLA's qk 192
    # beside v 128, seamless's non-causal cross-attention against 512
    ("attention", (8, 512, 16, 64), (8, 512, 8, 64)),
    ("attention", (8, 512, 32, 64), (8, 512, 32, 64)),
    ("attention", (8, 512, 128, 192), (8, 512, 128, 192)),
    ("attention", (8, 1, 16, 64), (8, 512, 16, 64)),
    # kernel 1: the experts' batched products (E, G C, D) @ (E, D, F)
    ("matmul", (32, 1280, 1024), (32, 1024, 512)),
    ("matmul", (32, 1280, 512), (32, 512, 1024)),
    ("matmul", (256, 320, 7168), (256, 7168, 2048)),
    # kernel 3: granite's decode at hd 64
    ("paged", (8, 16, 64), (161, 16, 8, 64)),
]


@pytest.mark.parametrize("kind,a,b", PLAN_CASES)
def test_plans_at_the_families_shapes_equal_jax(kind, a, b):
    plan = {"attention": "attention_plan", "matmul": "matmul_plan",
            "paged": "paged_plan"}[kind]
    for m in MESHES:
        assert _fields(getattr(shmap, plan)(a, b, m)) == \
            _fields(getattr(jshmap, plan)(a, b, m)), (kind, a, b, m.shape)
