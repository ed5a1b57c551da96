"""The port's parallel layer against the JAX package, on the CPU.

Specs and plans are pure shape code and must equal JAX's entry for entry:
``param_specs`` on every config (JAX: ``jax.eval_shape`` of ``init``; the
port: ``launch/specs.py`` on ``meta``), ``batch_specs``, ``cache_specs``,
the engine's ``_pool_spec`` and the three plans of ``kernels/shmap.py``, on
shape-only stand-in meshes.  The routing tests mirror JAX's
``tests/test_shmap.py`` (the 15 that pass on the CPU) and the mesh cases of
``test_serving.py``, ``test_attention.py`` and ``test_checkpoint_and_loop.py``
on a one-rank mesh (gloo, an in-process store), held to JAX's result on the
same inputs.  ``tests/test_torch_parallel_ranks.py`` runs two ranks.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import repro  # noqa: E402
from repro import numerics as jnumerics  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import shmap as jshmap  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.parallel import ctx as jctx  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serving.engine import _pool_spec as jax_pool_spec  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import numerics  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.core import get_policy  # noqa: E402
from repro_torch.kernels import dispatch, shmap, tuning  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.step import (make_sharded_train_step,  # noqa: E402
                                     make_train_step)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.modules import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import ctx  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.collectives import (  # noqa: E402
    compressed_psum, zeros_like_residual)
from repro_torch.parallel.sharding import P  # noqa: E402
from repro_torch.serving import Engine, SamplingParams  # noqa: E402
from repro_torch.serving.engine import _pool_spec  # noqa: E402

explain = importlib.import_module("repro_torch.obs.explain")
FORCED = dict(force=True, interpret=True, min_dim=0)
U24 = 2.0 ** -24


class FakeMesh:
    """Shape-only mesh stand-in (no ranks), JAX's test double."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = ([FakeMesh(data=d, model=m) for d in (1, 2, 16)
           for m in (1, 2, 4, 8, 16)]
          + [FakeMesh(pod=2, data=2, model=4), FakeMesh(pod=2, data=16,
                                                         model=16)])


@pytest.fixture(scope="module")
def mesh():
    """A one-rank ``(data, model)`` mesh over gloo; the process group is
    torn down after the module."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    m = make_host_mesh(1, device="cpu")
    yield m
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_1d(mesh):
    """A one-rank ``("model",)`` mesh, JAX's tests' 1-D mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (1,), mesh_dim_names=("model",))


def _jax_mesh(names=("data", "model")):
    return Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(names)),
                names)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _specs(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _gemm_tol(a, b):
    return 8 * a.shape[-1] * U24 * (np.abs(a).astype(np.float64)
                                    @ np.abs(b).astype(np.float64))


# ------------------------------------------------------------ spec parity

def _variants(arch):
    out = [("tp", {})]
    out.append(("fsdp_tp", {"shard_mode": "fsdp_tp"}))
    out.append(("dp_over_model", {"dp_over_model": True}))
    if jax_config(arch).n_experts:
        out.append(("ep_2d", {"ep_mode": "2d"}))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_jax_on_every_config_and_mesh(arch):
    """``param_specs`` on every leaf, every stand-in mesh and every mode
    (``tp``, ``fsdp_tp``, ``dp_over_model``, ``ep_mode="2d"``)."""
    jparams = JS.abstract_params(jax_config(arch))
    params = S.abstract_params(get_config(arch))
    assert {k: tuple(v.shape) for k, v in _flat(params).items()} == \
        {k: tuple(v.shape) for k, v in _flat(jparams).items()}
    for _, kw in _variants(arch):
        jcfg, cfg = jax_config(arch).replace(**kw), \
            get_config(arch).replace(**kw)
        for m in MESHES:
            assert _specs(shd.param_specs(params, m, cfg)) == \
                _specs(jshd.param_specs(jparams, m, jcfg)), (kw, m.shape)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-2b",
                                  "seamless-m4t-large-v2",
                                  "deepseek-v3-671b"])
def test_batch_and_cache_specs_equal_jax(arch):
    """``batch_specs`` of each cell's inputs and ``cache_specs`` of each
    decode cell's cache (abstract on both sides), every stand-in mesh."""
    for dp_over_model in (False, True):
        jcfg = jax_config(arch).replace(dp_over_model=dp_over_model)
        cfg = get_config(arch).replace(dp_over_model=dp_over_model)
        for shape in ("train_4k", "prefill_32k"):
            jb, b = JS.input_specs(jcfg, shape), S.input_specs(cfg, shape)
            assert {k: tuple(v.shape) for k, v in b.items()} == \
                {k: tuple(v.shape) for k, v in jb.items()}
            for m in MESHES:
                assert _specs(shd.batch_specs(cfg, m, b)) == \
                    _specs(jshd.batch_specs(jcfg, m, jb))
    cfg, jcfg = get_config(arch), jax_config(arch)
    for shape in ("decode_32k",):
        _, _, jc = JS.decode_specs(jcfg, shape)
        _, _, c = S.decode_specs(cfg, shape)
        B, T = 128, 32_768
        for m in MESHES:
            assert _specs(shd.cache_specs(cfg, m, c, B, T)) == \
                _specs(jshd.cache_specs(jcfg, m, jc, B, T)), m.shape


@pytest.mark.parametrize("factored", [False, True])
def test_optimizer_state_specs_equal_jax(factored):
    """``_opt_specs`` mirrors the parameter specs into the AdamW state
    (a factored ``v`` drops a dim), as JAX's does."""
    from repro.launch.step import _opt_specs as jax_opt_specs
    from repro.optim import adamw as jadamw

    from repro_torch.launch.step import _opt_specs
    for arch in ("qwen3-0.6b", "granite-moe-1b-a400m"):
        jopt = jadamw.OptConfig(factored_v=factored)
        opt = adamw.OptConfig(factored_v=factored)
        jstate = JS.abstract_state(jax_config(arch), jopt)
        state = S.abstract_state(get_config(arch), opt)
        for m in (FakeMesh(data=2, model=4), FakeMesh(data=16, model=16)):
            jp = jshd.param_specs(jstate["params"], m, jax_config(arch))
            pp = shd.param_specs(state["params"], m, get_config(arch))
            got = _specs(_opt_specs(state["opt"], pp))
            want = {k: tuple(v) for k, v in _flat(
                jax_opt_specs(jstate["opt"], jp)).items()}
            assert got == want


def test_pool_spec_head_dim_fallback():
    """The engine's pool layout (JAX's test, and JAX's function on a grid):
    KV heads on model when divisible, else head_dim, else replicated."""
    assert _pool_spec((9, 8, 4, 64), FakeMesh(data=2, model=2)) \
        == P(None, None, "model", None)
    assert _pool_spec((9, 8, 2, 64), FakeMesh(data=1, model=4)) \
        == P(None, None, None, "model")
    assert _pool_spec((9, 8, 3, 7), FakeMesh(data=1, model=4)) \
        == P(None, None, None, None)
    for m in MESHES:
        for shape in ((28, 41, 16, 8, 128), (9, 8, 3, 7), (2, 9, 8, 4, 64),
                      (9, 8, 2, 64)):
            assert tuple(_pool_spec(shape, m)) == \
                tuple(jax_pool_spec(shape, m))


def test_to_placements_follow_the_spec():
    """Placements per mesh dim; size-1 dims replicate."""
    from torch.distributed.tensor import Replicate, Shard
    m = FakeMesh(pod=2, data=2, model=4)
    assert shd.to_placements(P(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert shd.to_placements(P(None, "model"), FakeMesh(data=1, model=1)) \
        == (Replicate(), Replicate())
    assert shd.to_placements(P(("model", "data")), FakeMesh(data=2,
                                                             model=2)) == \
        (Shard(0), Shard(0))


# ------------------------------------------------------------ plan parity

def _plan_fields(plan):
    if plan is None:
        return None
    out = {}
    for k, v in vars(plan).items():
        out[k] = tuple(v) if k.endswith("spec") else v
    return out


PLAN_MESHES = MESHES + [FakeMesh(model=3), FakeMesh(expert=2),
                        FakeMesh(expert=1, model=2), FakeMesh(data=3),
                        FakeMesh(model=2, data=2)]


@pytest.mark.parametrize("batched", [False, True])
def test_matmul_plans_equal_jax(batched):
    dims = (1, 2, 3, 4, 8, 16, 129, 256, 1024)
    n = 0
    for m in PLAN_MESHES:
        for M in dims:
            for K in (3, 16, 129, 256):
                for N in (1, 8, 129, 3072):
                    a = (4, M, K) if batched else (M, K)
                    b = (4, K, N) if batched else (K, N)
                    got = _plan_fields(shmap.matmul_plan(a, b, m))
                    assert got == _plan_fields(jshmap.matmul_plan(a, b, m))
                    n += got is None
    assert n > 0                      # the None cases are on the grid


def test_attention_and_paged_plans_equal_jax():
    n = 0
    for m in PLAN_MESHES:
        for B in (1, 2, 3, 8):
            for S in (1, 251, 256, 512):
                for H, Hkv in ((16, 8), (8, 4), (3, 1), (2, 1), (4, 2)):
                    q, k = (B, S, H, 128), (B, 128, Hkv, 128)
                    got = _plan_fields(shmap.attention_plan(q, k, m))
                    assert got == _plan_fields(
                        jshmap.attention_plan(q, k, m))
                    n += got is None
            for H, Hkv in ((16, 8), (8, 4), (3, 3), (2, 1)):
                q, pool = (B, H, 128), (41, 16, Hkv, 128)
                got = _plan_fields(shmap.paged_plan(q, pool, m))
                assert got == _plan_fields(jshmap.paged_plan(q, pool, m))
                n += got is None
    assert n > 0


# ------------------------------------------- JAX's plan tests, mirrored

def test_matmul_plan_prefers_n_then_k_then_m():
    m = FakeMesh(data=1, model=4)
    cases = [((256, 256), (256, 256)), ((256, 256), (256, 129)),
             ((256, 131), (131, 129)), ((130, 131), (131, 129))]
    for a, b in cases:
        assert _plan_fields(shmap.matmul_plan(a, b, m)) == \
            _plan_fields(jshmap.matmul_plan(a, b, m))
    plan = shmap.matmul_plan((256, 256), (256, 256), m)
    assert plan.sharded_dim == "N" and not plan.psum_axes
    assert plan.local == (1, 256, 64, 256)
    plan = shmap.matmul_plan((256, 256), (256, 129), m)
    assert plan.sharded_dim == "K" and plan.psum_axes == ("model",)
    assert plan.a_spec == P(None, "model") and plan.b_spec == P("model", None)
    assert shmap.matmul_plan((256, 131), (131, 129), m).sharded_dim == "M"
    assert shmap.matmul_plan((130, 131), (131, 129), m) is None


def test_matmul_plan_batch_and_dp_axes():
    m = FakeMesh(pod=2, data=2, model=2)
    for a, b in (((8, 256, 256), (8, 256, 256)), ((256, 256), (256, 256)),
                 ((3, 129, 256), (3, 256, 256))):
        assert _plan_fields(shmap.matmul_plan(a, b, m)) == \
            _plan_fields(jshmap.matmul_plan(a, b, m))
    plan = shmap.matmul_plan((8, 256, 256), (8, 256, 256), m)
    assert plan.b_spec == P(("pod", "data"), None, "model")
    assert plan.local == (2, 256, 128, 256)
    assert shmap.matmul_plan((3, 129, 256), (3, 256, 256), m) is None


def test_plans_reject_unknown_axis_names():
    m = FakeMesh(expert=2)
    assert shmap.matmul_plan((256, 256), (256, 256), m) is None
    assert shmap.attention_plan((1, 256, 4, 64), (1, 256, 2, 64), m) is None
    assert shmap.paged_plan((2, 8, 64), (9, 8, 2, 64), m) is None
    got = shmap.matmul_plan((256, 256), (256, 256),
                            FakeMesh(expert=1, model=2))
    assert got is not None and _plan_fields(got) == _plan_fields(
        jshmap.matmul_plan((256, 256), (256, 256),
                           FakeMesh(expert=1, model=2)))


def test_attention_plan_heads_then_qseq():
    m = FakeMesh(data=2, model=2)
    for q, k in (((2, 256, 8, 64), (2, 256, 4, 64)),
                 ((2, 256, 3, 64), (2, 256, 1, 64)),
                 ((2, 251, 3, 64), (2, 251, 1, 64)),
                 ((3, 256, 8, 64), (3, 256, 4, 64))):
        assert _plan_fields(shmap.attention_plan(q, k, m)) == \
            _plan_fields(jshmap.attention_plan(q, k, m))
    plan = shmap.attention_plan((2, 256, 3, 64), (2, 256, 1, 64), m)
    assert plan.mode == "qseq" and plan.qp_spec == P("data", "model")
    assert shmap.attention_plan((2, 251, 3, 64), (2, 251, 1, 64), m) is None


def test_paged_plan_heads_on_model_tables_local():
    m = FakeMesh(data=2, model=2)
    plan = shmap.paged_plan((2, 8, 64), (9, 8, 4, 64), m)
    assert _plan_fields(plan) == _plan_fields(
        jshmap.paged_plan((2, 8, 64), (9, 8, 4, 64), m))
    assert plan.pool_spec == P(None, None, "model", None)
    assert plan.bt_spec == P("data", None) and plan.local == (1, 2)
    assert shmap.paged_plan((2, 8, 64), (9, 8, 3, 64), m) is None


# ----------------------------------------- routing on a one-rank mesh

def test_matmul_routes_through_the_wrapper_under_mesh(mesh):
    """Under a one-rank mesh kernel 1 runs through ``sharded_matmul``
    (one count), bitwise the unsharded call, and within the GEMM bound of
    JAX's routed call on the same inputs."""
    a, b = _rand((128, 128), 0), _rand((128, 128), 1)
    with jnumerics.use(**FORCED, block=(128, 128, 128)):
        with jctx.use_mesh(_jax_mesh()):
            jout = np.asarray(repro.matmul(jnp.asarray(a), jnp.asarray(b),
                                           policy="tcec_bf16x6"))
    with numerics.use(interpret=True):
        ref = repro_torch.matmul(torch.from_numpy(a), torch.from_numpy(b),
                                 policy="tcec_bf16x6")
        n0 = shmap.counters()["matmul"]
        with ctx.use_mesh(mesh):
            out = repro_torch.matmul(torch.from_numpy(a),
                                     torch.from_numpy(b),
                                     policy="tcec_bf16x6")
        assert shmap.counters()["matmul"] == n0 + 1
    assert torch.equal(out, ref)
    assert np.all(np.abs(out.numpy() - jout) <= _gemm_tol(a, b))


def test_shard_map_knob_declines_under_mesh(mesh, monkeypatch):
    """``shard_map=False`` under a mesh: kernel 1's walk records
    ``mesh-declined`` and runs nothing of the kernel; the result is the
    term expansion's, bitwise, as JAX's is XLA's."""
    a, b = _rand((128, 128), 2), _rand((128, 128), 3)
    calls = []
    real = dispatch._matmul_local
    monkeypatch.setattr(dispatch, "_matmul_local",
                        lambda *x, **kw: (calls.append(1), real(*x, **kw))[1])
    explain.reset()
    with numerics.use(interpret=True, shard_map=False):
        with ctx.use_mesh(mesh):
            out = repro_torch.matmul(torch.from_numpy(a),
                                     torch.from_numpy(b),
                                     policy="tcec_bf16x6")
    assert calls == []
    rules = {e["rule"] for e in explain.report().entries
             if e["kernel"] == "matmul"}
    assert rules == {"mesh-declined"}, rules
    with numerics.use(enabled=False):
        plain = repro_torch.matmul(torch.from_numpy(a), torch.from_numpy(b),
                                   policy="tcec_bf16x6")
    assert torch.equal(out, plain)
    with jnumerics.use(**FORCED, shard_map=False):
        with jctx.use_mesh(_jax_mesh()):
            jout = np.asarray(repro.matmul(jnp.asarray(a), jnp.asarray(b),
                                           policy="tcec_bf16x6"))
    assert np.all(np.abs(out.numpy() - jout) <= _gemm_tol(a, b))


def test_unsupported_spec_declines():
    a, b = _rand((2, 128, 128), 4), _rand((2, 128, 128), 5)
    dims = (((2,), (1,)), ((0,), (0,)))
    pol = get_policy("tcec_bf16x6")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with numerics.use(interpret=True):
        assert dispatch.decide(ta, tb, pol, dims) is not None
        with ctx.use_mesh(FakeMesh(model=3)):
            assert dispatch.decide(ta, tb, pol, dims) is None
            assert dispatch.maybe_dispatch(ta, tb, pol, dims) is None
    jpol = repro.get_policy("tcec_bf16x6")
    with jnumerics.use(**FORCED):
        with jctx.use_mesh(FakeMesh(model=3)):
            assert jdispatch.decide(jnp.asarray(a), jnp.asarray(b), jpol,
                                    dims) is None


def test_dp_over_model_context_declines(mesh):
    a, b = torch.from_numpy(_rand((256, 256), 8)), \
        torch.from_numpy(_rand((256, 256), 9))
    dims = (((1,), (0,)), ((), ()))
    pol = get_policy("tcec_bf16x6")
    q = torch.from_numpy(_rand((1, 128, 4, 64), 10))
    k = torch.from_numpy(_rand((1, 128, 2, 64), 11))
    with numerics.use(interpret=True):
        with ctx.use_mesh(mesh):
            assert dispatch.decide(a, b, pol, dims) is not None
        with ctx.use_mesh(mesh, ("data", "model")):
            assert dispatch.decide(a, b, pol, dims) is None
            assert not dispatch.attention_eligible(q, k, k,
                                                   policy="tcec_bf16x6")


def test_epilogue_fusion_declines_under_mesh(mesh):
    pol = get_policy("tcec_bf16x6")
    with numerics.use(interpret=True, fuse_epilogue=True):
        assert dispatch.epilogue_eligible(pol, device="cpu")
        with ctx.use_mesh(mesh):
            assert not dispatch.epilogue_eligible(pol, device="cpu")
    with jnumerics.use(**FORCED, fuse_epilogue=True):
        with jctx.use_mesh(_jax_mesh()):
            assert not jdispatch.epilogue_eligible(repro.get_policy(
                "tcec_bf16x6"))


def test_shmap_tuning_namespace_keys():
    """The per-shard keys are JAX's, ``backend/shmap/...``, and never the
    global namespace's (the card test tunes under a mesh for real)."""
    assert tuning.cache_key(1, 128, 128, 128, "tcec_bf16x6", "cpu",
                            namespace=shmap.NAMESPACE) == \
        jtuning.cache_key(1, 128, 128, 128, "tcec_bf16x6", "cpu",
                          namespace=jshmap.NAMESPACE) == \
        "cpu/shmap/tcec_bf16x6/b1_m128_n128_k128"
    assert tuning.attn_cache_key(1, 2, 4, 128, 256, 64, 64, "tcec_bf16x6",
                                 "cpu", True, shmap.NAMESPACE) \
        .startswith("cpu/shmap/attn/")
    assert tuning.paged_cache_key(1, 2, 4, 4, 8, 64, 64, "tcec_bf16x6",
                                  "cpu", shmap.NAMESPACE) == \
        jtuning.paged_cache_key(1, 2, 4, 4, 8, 64, 64, "tcec_bf16x6", "cpu",
                                jshmap.NAMESPACE)
    assert tuning.cache_key(1, 128, 128, 128, "tcec_bf16x6", "cpu") != \
        tuning.cache_key(1, 128, 128, 128, "tcec_bf16x6", "cpu",
                         namespace=shmap.NAMESPACE)


def test_mesh_dispatch_keys_the_local_tile():
    """A routed product is tuned at the plan's local shape (JAX's
    ``local``), keyed under the shmap namespace."""
    m = FakeMesh(data=1, model=4)
    for a, b in (((128, 128), (128, 128)), ((4, 64, 256), (4, 256, 129))):
        plan, jplan = shmap.matmul_plan(a, b, m), jshmap.matmul_plan(a, b, m)
        assert plan.local == jplan.local
        assert tuning.cache_key(*plan.local, "tcec_bf16x6", "cuda",
                                namespace=shmap.NAMESPACE).startswith(
            "cuda/shmap/tcec_bf16x6/")


def test_repro_shard_map_registered_and_round_trips(monkeypatch):
    var = numerics.ENV_VARS["REPRO_SHARD_MAP"]
    jvar = jnumerics.ENV_VARS["REPRO_SHARD_MAP"]
    assert (var.field, var.kind, var.default) == \
        (jvar.field, jvar.kind, jvar.default) == ("shard_map", "bool", True)
    assert numerics.NumericsConfig().shard_map is True
    assert numerics.NumericsConfig.from_env({"REPRO_SHARD_MAP": "0"}) \
        .shard_map is jnumerics.NumericsConfig.from_env(
            {"REPRO_SHARD_MAP": "0"}).shard_map is False
    monkeypatch.setenv("REPRO_SHARD_MAP", "0")
    assert not numerics.reload_env_defaults().shard_map
    monkeypatch.delenv("REPRO_SHARD_MAP")
    assert numerics.reload_env_defaults().shard_map


def test_attention_dispatch_under_mesh_routes_or_declines(mesh_1d):
    """JAX's ``test_attention.py`` mesh case: routed through the wrapper
    under a one-rank ``("model",)`` mesh, bitwise the unsharded kernel and
    within 1e-5 max|v| of JAX's; the knob and a model axis dividing
    neither Hkv nor S decline."""
    q = np.ones((1, 128, 4, 64), np.float32)
    k = _rand((1, 128, 2, 64), 12)
    v = _rand((1, 128, 2, 64), 13)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with jnumerics.use(**FORCED, attn_block=(128, 128)):
        with jctx.use_mesh(_jax_mesh(("model",))):
            jout = np.asarray(jdispatch.attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                policy="tcec_bf16x6"))
    with numerics.use(interpret=True):
        ref = dispatch.attention(tq, tk, tv, policy="tcec_bf16x6")
        with ctx.use_mesh(mesh_1d):
            n0 = shmap.counters()["attention"]
            out = dispatch.attention(tq, tk, tv, policy="tcec_bf16x6")
            assert out is not None
            assert shmap.counters()["attention"] == n0 + 1
            assert torch.equal(out, ref)
            with numerics.use(shard_map=False):
                assert not dispatch.attention_eligible(
                    tq, tk, tv, policy="tcec_bf16x6")
                assert dispatch.attention(tq, tk, tv,
                                          policy="tcec_bf16x6") is None
        with ctx.use_mesh(FakeMesh(model=3)):
            assert not dispatch.attention_eligible(tq, tk, tv,
                                                   policy="tcec_bf16x6")
    assert np.max(np.abs(out.numpy() - jout)) <= 1e-5 * np.abs(v).max()


def _paged_case(seed):
    rng = np.random.default_rng(seed)
    B, Hkv, rep, hd, ps, maxp, NP = 2, 2, 2, 64, 8, 4, 9
    q = rng.standard_normal((B, Hkv * rep, hd)).astype(np.float32)
    kp = rng.standard_normal((NP, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((NP, ps, Hkv, hd)).astype(np.float32)
    bt = (rng.permutation(8).reshape(B, maxp) + 1).astype(np.int32)
    lengths = np.asarray([25, 30], np.int32)
    return q, kp, vp, bt, lengths


def test_paged_dispatch_under_mesh_routes_or_declines(mesh_1d):
    """JAX's ``test_serving.py`` mesh case, with f32 pools so that JAX's
    and the port's inputs are the same bits."""
    q, kp, vp, bt, lengths = _paged_case(seed=15)
    with jnumerics.use(**FORCED):
        with jctx.use_mesh(_jax_mesh(("model",))):
            jout = np.asarray(jdispatch.attention_decode(
                *(jnp.asarray(x) for x in (q, kp, vp, bt, lengths)),
                policy="tcec_bf16x6"))
    t = [torch.from_numpy(x) for x in (q, kp, vp, bt, lengths)]
    with numerics.use(interpret=True):
        ref = dispatch.attention_decode(*t, policy="tcec_bf16x6")
        with ctx.use_mesh(mesh_1d):
            assert dispatch.attention_decode_eligible(
                t[0], t[1], t[2], policy="tcec_bf16x6")
            n0 = shmap.counters()["paged"]
            out = dispatch.attention_decode(*t, policy="tcec_bf16x6")
            assert out is not None and shmap.counters()["paged"] == n0 + 1
            assert torch.equal(out, ref)
            with numerics.use(shard_map=False):
                assert not dispatch.attention_decode_eligible(
                    t[0], t[1], t[2], policy="tcec_bf16x6")
        with ctx.use_mesh(FakeMesh(model=3)):
            assert not dispatch.attention_decode_eligible(
                t[0], t[1], t[2], policy="tcec_bf16x6")
    assert np.max(np.abs(out.numpy() - jout)) <= 1e-5 * np.abs(vp).max()


# ------------------------------------------------- engine and training

@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("qwen3-0.6b")
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config("qwen3-0.6b"), params


def test_engine_under_mesh_matches_unsharded_and_jax_greedy(smoke, mesh):
    """The engine under a one-rank mesh (pools laid out by ``_pool_spec``,
    parameters by ``param_specs``, kernel 3 through the wrapper) gives the
    port's unsharded engine's greedy tokens and JAX's engine's."""
    jcfg, jparams, cfg, params = smoke
    rng = np.random.default_rng(2)
    prompts = [list(rng.integers(0, cfg.vocab_size, 5)),
               list(rng.integers(0, cfg.vocab_size, 9))]
    with jnumerics.use(**FORCED):
        jout = JaxEngine(jcfg, jparams, max_slots=2).run(
            prompts, JaxSamplingParams(temperature=0.0, max_tokens=5))
    base = Engine(cfg, params, max_slots=2, device="cpu").run(
        prompts, SamplingParams(temperature=0.0, max_tokens=5))
    sharded = shd.shard_tree(params, shd.to_shardings(
        shd.param_specs(params, mesh, cfg), mesh))
    n0 = shmap.counters()["paged"]
    with ctx.use_mesh(mesh):
        eng = Engine(cfg, sharded, max_slots=2, device="cpu")
    out = eng.run(prompts, SamplingParams(temperature=0.0, max_tokens=5))
    assert eng.mesh is mesh and ctx.is_dtensor(eng.pools["dense_blocks"]["k"])
    assert shmap.counters()["paged"] > n0
    assert eng.stats()["decode_graph_reason"] == "cpu"
    assert [list(v) for v in out.values()] == \
        [list(v) for v in base.values()] == [list(v) for v in jout.values()]


def test_sharded_train_step_equals_unsharded_and_routes(smoke, mesh):
    """``make_sharded_train_step`` on a one-rank mesh: loss, metrics and
    every parameter and moment bitwise the unsharded step's, every product
    and attention call through the wrappers; JAX's unsharded loss within
    2^-13 relative (its sharded step fails on the CPU, a seed failure)."""
    jcfg, jparams, cfg, params = smoke
    opt = adamw.OptConfig(lr=1e-3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    ref, rmet = make_train_step(cfg, opt)(state, batch)
    step, sh, sharder = make_sharded_train_step(cfg, opt, mesh)
    shmap.reset_counters()
    new, met = step(shd.shard_tree(state, sh), sharder(batch))
    c = shmap.counters()
    assert c["matmul"] > 0 and c["attention"] > 0
    assert all(not ctx.is_dtensor(v) for v in met.values())
    assert torch.equal(met["loss"], rmet["loss"])
    for a, b in zip(tree_leaves(new), tree_leaves(ref)):
        assert torch.equal(ctx.full(a), b)
    with jnumerics.use(**FORCED):
        jloss, _ = jax_get_model(jcfg).loss_fn(
            jparams, {"tokens": jnp.asarray(toks),
                      "labels": jnp.asarray(np.roll(toks, -1, axis=1))})
    assert abs(float(met["loss"]) - float(jloss)) <= \
        2.0 ** -13 * abs(float(jloss))


def test_train_loop_under_mesh_resumes(smoke, mesh, tmp_path):
    """``train(mesh=)`` runs the sharded step, checkpoints whole, and a
    resumed run re-shards the checkpoint and replays to the same state as
    an uninterrupted unsharded run."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.loop import TrainLoopConfig, train
    _, _, cfg, _ = smoke
    opt = adamw.OptConfig(lr=1e-3)
    data = DataConfig(seed=0, global_batch=2, seq_len=32)
    quiet = dict(device="cpu", log=lambda m: None)
    ref, hist = train(cfg, opt, data, TrainLoopConfig(total_steps=2,
                                                      ckpt_every=100),
                      str(tmp_path / "ref"), **quiet)
    d = str(tmp_path / "mesh")
    shmap.reset_counters()
    train(cfg, opt, data, TrainLoopConfig(total_steps=1, ckpt_every=1), d,
          mesh=mesh, **quiet)
    assert shmap.counters()["attention"] > 0
    state, mhist = train(cfg, opt, data, TrainLoopConfig(total_steps=2,
                                                         ckpt_every=1), d,
                         mesh=mesh, **quiet)
    assert ctx.is_dtensor(state["params"]["embed"])
    assert [h["loss"] for h in mhist] == [hist[-1]["loss"]]
    for a, b in zip(tree_leaves(state), tree_leaves(ref)):
        assert torch.equal(ctx.full(a), b)


def test_elastic_reshard_restore(tmp_path, mesh):
    """JAX's elastic restart case: a checkpoint written unsharded restores
    onto a one-rank mesh with explicit shardings; JAX restores the same
    file to the same values."""
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from repro.checkpoint import manager as jckpt
    d = str(tmp_path)
    t = {"w": torch.arange(64.0).reshape(8, 8)}
    ckpt.save(d, 1, t)
    sh = {"w": shd.NamedSharding(mesh, P("data", None))}
    like = {"w": torch.empty((8, 8), device="meta")}
    r = ckpt.restore(d, 1, like, shardings=sh)
    assert ctx.is_dtensor(r["w"])
    assert tuple(r["w"].placements) == sh["w"].placements
    assert torch.equal(r["w"].full_tensor(), t["w"])
    jmesh = _jax_mesh(("data",))
    jr = jckpt.restore(d, 1, {"w": jax.ShapeDtypeStruct((8, 8), jnp.float32)},
                       shardings={"w": NamedSharding(jmesh, JP("data",
                                                               None))})
    np.testing.assert_array_equal(np.asarray(jr["w"]), t["w"].numpy())


# ------------------------------------------------------- compressed psum

def test_compressed_psum_error_feedback_equals_jax():
    """64 steps on one rank: every step's reduced values and residuals
    bitwise JAX's (``tests/test_distribution.py``'s run), and the
    error-feedback bound: the mean error is at most a quarter of plain bf16
    rounding's."""
    from functools import partial

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as JP

    from repro.parallel.collectives import compressed_psum as jpsum
    g = {"w": np.full((256,), 1.0 + 2.0 ** -12, np.float32)}
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("d",))

    @jax.jit
    @partial(shard_map, mesh=jmesh, in_specs=(JP(), JP()),
             out_specs=(JP(), JP()))
    def jone(gw, rw):
        red, nr = jpsum({"w": gw}, {"w": rw}, "d")
        return red["w"], nr["w"]

    tg = {"w": torch.from_numpy(g["w"])}
    res = zeros_like_residual(tg)
    jres = jnp.zeros((256,), jnp.float32)
    total = torch.zeros(256)
    for _ in range(64):
        red, res = compressed_psum(tg, res)
        jred, jres = jone(jnp.asarray(g["w"]), jres)
        assert np.array_equal(red["w"].numpy(), np.asarray(jred))
        assert np.array_equal(res["w"].numpy(), np.asarray(jres))
        total = total + red["w"]
    avg = total / 64
    err_fb = float((avg - tg["w"]).abs().max())
    err_plain = float((tg["w"].bfloat16().float() - tg["w"]).abs().max())
    assert err_fb <= err_plain / 4 + 1e-9


def test_mesh_stand_ins_and_meshes_read_alike(mesh):
    assert ctx.axis_names(mesh) == ("data", "model")
    assert ctx.axis_shape(mesh) == {"data": 1, "model": 1}
    assert shd.dp_axes(mesh) == ("data",)
    assert ctx.axis_shape(FakeMesh(pod=2, data=2, model=4)) == \
        {"pod": 2, "data": 2, "model": 4}
    assert ctx.clean_spec((8, 6), (("data", "model"), "model"),
                          FakeMesh(data=2, model=4)) == \
        (("data", "model"), None)
