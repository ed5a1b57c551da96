"""The port's split, policies, configs and pdot against the JAX package.

Pure-data parts are held bit for bit; products to the f32 SGEMM error
``|d| <= 8 * K * 2^-24 * (|A| @ |B|)``.  Also the port's two guards: it
imports neither ``jax`` nor ``repro``, and its entry points refuse to run
on the CPU unless asked to.
"""
import dataclasses
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.bridge import numpy_from_tensor, tensor_from_numpy  # noqa
from repro_torch.configs import (get_config, get_smoke_config,  # noqa: E402
                                 list_archs)
from repro_torch.configs.base import ModelConfig  # noqa: E402

# the packages re-export the function ``split`` over the module's name
jpol = importlib.import_module("repro.core.policy")
jsplit = importlib.import_module("repro.core.split")
tpol = importlib.import_module("repro_torch.core.policy")
tsplit = importlib.import_module("repro_torch.core.split")

ROOT = Path(__file__).resolve().parents[1]
U24 = 2.0 ** -24
NARROW = ["bfloat16", "float16", "float8_e4m3fn", "float8_e5m2"]


def _values(seed=0):
    """Normal values across many binades, plus signed zeros and values
    beyond the fp8 ranges (which the casts turn non-finite)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(512) * np.exp2(rng.integers(-20, 12, 512))
    extra = [0.0, -0.0, 470.0, 500.0, -6e4, 1e5, 3.3e38, 1e-30]
    return np.concatenate([x, extra]).astype(np.float32)


def _same_bits(t, j):
    """Bitwise equality of a torch tensor and a JAX array of the same
    narrow dtype (NaNs must sit at the same places)."""
    a = numpy_from_tensor(t, np.asarray(j).dtype)
    b = np.asarray(j)
    fa, fb = a.astype(np.float32), b.astype(np.float32)
    nan = np.isnan(fa)
    assert np.array_equal(nan, np.isnan(fb))
    assert np.array_equal(fa[~nan], fb[~nan])
    assert np.array_equal(np.signbit(fa[~nan]), np.signbit(fb[~nan]))


@pytest.mark.parametrize("dtype", NARROW)
def test_split_rn_bitwise_equal_to_jax(dtype):
    x = _values()
    bits = jsplit.MANTISSA_BITS[jnp.dtype(dtype)] + 1
    jparts = jsplit.split(jnp.asarray(x), jnp.dtype(dtype), 3, bits)
    tparts = tsplit.split(torch.from_numpy(x), getattr(torch, dtype), 3, bits)
    for t, j in zip(tparts, jparts):
        _same_bits(t, j)
    if dtype in ("bfloat16", "float16"):
        rec_t = tsplit.reconstruct(tparts, bits).numpy()
        rec_j = np.asarray(jsplit.reconstruct(jparts, bits))
        assert rec_t.tobytes() == rec_j.tobytes()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_split_rz_bitwise_equal_to_jax(dtype):
    x = _values(1)
    x = x[np.abs(x) < 6e4]                        # the f16 RZ analysis range
    jparts = jsplit.split(jnp.asarray(x), jnp.dtype(dtype), 2, 11, "rz")
    tparts = tsplit.split(torch.from_numpy(x), getattr(torch, dtype), 2, 11,
                          "rz")
    for t, j in zip(tparts, jparts):
        _same_bits(t, j)


def test_mantissa_bits_match():
    assert {str(k).replace("torch.", ""): v
            for k, v in tsplit.MANTISSA_BITS.items()} == \
        {jnp.dtype(k).name: v for k, v in jsplit.MANTISSA_BITS.items()}


@pytest.mark.parametrize("name", sorted(jpol.POLICIES))
def test_policy_fields_equal_jax(name):
    assert sorted(tpol.POLICIES) == sorted(jpol.POLICIES)
    j, t = jpol.POLICIES[name], tpol.POLICIES[name]
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.passes, t.groups, t.is_plain()) == \
        (j.passes, j.groups, j.is_plain())


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_keep_schedules_equal_jax(n):
    assert tpol.triangular_keep(n) == jpol.triangular_keep(n)
    assert tpol.full_keep(n) == jpol.full_keep(n)


def test_model_config_fields_equal_jax():
    """Every arch the port registers is the JAX package's, field for field
    (full and smoke), derived properties included."""
    assert [(f.name, f.default) for f in dataclasses.fields(ModelConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JaxModelConfig)]
    assert list_archs() == ["deepseek-v3-671b", "gemma-2b", "gemma2-9b",
                            "granite-moe-1b-a400m", "internvl2-2b",
                            "mamba2-130m", "qwen2.5-14b", "qwen3-0.6b",
                            "seamless-m4t-large-v2", "zamba2-1.2b"]
    for arch in list_archs():
        for port, ref in ((get_config, jax_get_config),
                          (get_smoke_config, jax_get_smoke)):
            cfg, jcfg = port(arch), ref(arch)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert (cfg.padded_vocab, cfg.moe_groups, cfg.mix_policy,
                    cfg.n_rep) == (jcfg.padded_vocab, jcfg.moe_groups,
                                   jcfg.mix_policy, jcfg.n_rep)
    assert get_config("qwen3-0.6b").padded_vocab == 151936
    assert get_config("granite-moe-1b-a400m").padded_vocab == 49280
    assert get_config("granite-moe-1b-a400m").moe_groups == 128
    assert get_config("seamless-m4t-large-v2").padded_vocab == 256256
    assert get_config("internvl2-2b").padded_vocab == 92672


@pytest.mark.parametrize("spec", ["ab,bc", "ab,bc->ac->a", "ab->b",
                                  "ab,bc,cd->ad", "aab,bc->ac", "ab,bc->ad",
                                  "ab,bc->a"])
def test_einsum_parse_errors_match_jax(spec):
    a, b = np.ones((2, 3), np.float32), np.ones((3, 4), np.float32)
    with pytest.raises(jpol.EinsumParseError):
        jpol.pdot(spec, jnp.asarray(a), jnp.asarray(b), "fp32")
    with pytest.raises(tpol.EinsumParseError):
        tpol.pdot(spec, torch.from_numpy(a), torch.from_numpy(b), "fp32")


@pytest.mark.parametrize("policy", ["tcec_bf16x3", "tcec_bf16x6",
                                    "tcec_bf16x10", "fp32", "bf16",
                                    "fp16_halfhalf", "tcec_fp8e4m3x6"])
def test_pdot_projection_matches_jax(policy):
    """The model projection einsum: kernel 1's plain version for the bf16
    split policies (where JAX takes its XLA term expansion), the term
    expansion / plain product for the others."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, 5, 48)).astype(np.float32)
    w = rng.uniform(-1, 1, (48, 3, 16)).astype(np.float32)
    ref = np.asarray(jpol.pdot("bsd,dhk->bshk", jnp.asarray(x),
                               jnp.asarray(w), policy))
    out = tpol.pdot("bsd,dhk->bshk", torch.from_numpy(x),
                    torch.from_numpy(w), policy).numpy()
    tol = 8 * 48 * U24 * np.einsum("bsd,dhk->bshk", np.abs(x).astype(
        np.float64), np.abs(w).astype(np.float64))
    assert out.shape == ref.shape and np.all(np.abs(out - ref) <= tol)


def test_policy_mm_and_bmm_match_jax():
    rng = np.random.default_rng(8)
    a = rng.uniform(-1, 1, (3, 20, 40)).astype(np.float32)
    b = rng.uniform(-1, 1, (3, 40, 12)).astype(np.float32)
    tol = 8 * 40 * U24 * (np.abs(a).astype(np.float64) @ np.abs(b))
    out = tpol.policy_bmm(torch.from_numpy(a), torch.from_numpy(b),
                          "tcec_bf16x6").numpy()
    ref = np.asarray(jpol.policy_bmm(jnp.asarray(a), jnp.asarray(b),
                                     "tcec_bf16x6"))
    assert np.all(np.abs(out - ref) <= tol)
    out = tpol.policy_mm(torch.from_numpy(a[0]), torch.from_numpy(b[0]),
                         "tcec_bf16x3").numpy()
    ref = np.asarray(jpol.policy_mm(jnp.asarray(a[0]), jnp.asarray(b[0]),
                                    "tcec_bf16x3"))
    assert np.all(np.abs(out - ref) <= tol[0])


def test_compensated_policy_is_not_ported_yet():
    """The compensated x9 policy is ported (``tests/test_torch_numerics.py``
    holds it against JAX): ``pdot`` under it gives the head of its
    unevaluated pair, and only a compensated policy gives a pair."""
    a = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (4, 4)).astype(np.float32))
    head, tail = tpol.tcec_dot_unevaluated(a, a, "tcec_bf16x9")
    assert torch.equal(tpol.pdot("ij,jk->ik", a, a, "tcec_bf16x9"), head)
    assert tail.shape == head.shape
    with pytest.raises(ValueError):
        tpol.tcec_dot_unevaluated(a, a, "tcec_bf16x6")


def test_bridge_keeps_f32_and_int_exact():
    for x in (np.random.default_rng(9).standard_normal(33).astype(np.float32),
              np.arange(7, dtype=np.int32)):
        t = tensor_from_numpy(x)
        assert numpy_from_tensor(t).tobytes() == x.tobytes()


# ------------------------------------------------------------------ guards

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_port_imports_neither_jax_nor_the_jax_package():
    pkg = ROOT / "src" / "repro_torch"
    files = sorted(pkg.rglob("*.py"))
    # the JAX-free modules of the JAX package have copies of their own here
    assert {"faults.py", "kernels/guard.py", "obs/__init__.py",
            "obs/metrics.py", "obs/trace.py", "obs/explain.py",
            "obs/numerics_health.py"} <= {
                f.relative_to(pkg).as_posix() for f in files}
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        hits = _IMPORT.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.serving import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("qwen3-0.6b")
    model = get_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError):
        model.init_paged_cache(4, 4)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError):
        Engine(cfg, params)
    with pytest.raises(RuntimeError):
        serve.generate(cfg, params, np.zeros((1, 4), np.int64), 2)
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    ssm = get_smoke_config("mamba2-130m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(ssm).init(0)
    ssm_params = get_model(ssm).init(0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(ssm).init_cache(1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.generate_dense(ssm, ssm_params, np.zeros((1, 4), np.int64), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-130m", "--smoke"])
    assert resolve_device("cpu").type == "cpu"
