"""The larger dense models against the JAX package, on the CPU: gemma-2b
(GeGLU, MQA, scaled embeddings, tied), gemma2-9b (local/global windows,
attention and final softcaps, sandwich norms) and qwen2.5-14b (QKV bias,
untied), with kernels 2 and 3 at their head dim of 256.

The smoke configs (2 layers, d_model 64, heads of 16; gemma2-9b's window
8), parameters from the JAX ``init`` bridged exactly.  The JAX side runs
under ``numerics.use(force=True, interpret=True, min_dim=0)`` as the
serving tests do; the port runs its kernels' plain versions.  Logits are
held to ``2^-13`` of their largest entry (f32 summation order), greedy
tokens and finish reasons must be equal; the kernels' plain versions to
``1e-5 max|v|`` of JAX's Pallas kernels in interpret mode, as in
``test_torch_kernels.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.tcec_attention import (  # noqa: E402
    tcec_attention as jax_tcec_attention)
from repro.kernels.tcec_paged_attention import (  # noqa: E402
    tcec_paged_attention as jax_tcec_paged_attention)
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import Engine as JaxEngine  # noqa: E402
from repro.serving import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_jax, tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import (tcec_attention,  # noqa: E402
                                 tcec_paged_attention)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model, layers, lm, mla, modules  # noqa
from repro_torch.serving import Engine, SamplingParams  # noqa: E402
from torch.multiprocessing.reductions import StorageWeakRef  # noqa
from torch.utils import _pytree as pytree  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

FORCED = dict(force=True, interpret=True, min_dim=0)
REL = 2.0 ** -13
ARCHS = ["gemma-2b", "gemma2-9b", "qwen2.5-14b"]


@functools.lru_cache(maxsize=None)
def _smoke(arch):
    """(JAX config, JAX params, port config, bridged params)."""
    jcfg = jax_smoke_config(arch)
    jparams = jax_get_model(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_smoke_config(arch), params


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.max(np.abs(out - ref))
    assert err <= rel * np.max(np.abs(ref)), err


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    """16 tokens: past gemma2-9b's smoke window of 8 on its local layer."""
    jcfg, jparams, cfg, params = _smoke(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    with numerics.use(**FORCED):
        ref = jax_get_model(jcfg).forward_logits(
            jparams, {"tokens": jnp.asarray(toks)})
    out = get_model(cfg).forward_logits(params, torch.from_numpy(toks))
    _close(out.numpy(), ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_equal_jax(arch):
    """Four slots, pages of 4; the 12- and 20-token prompts outrun
    gemma2-9b's window, so its local layers' paged decode masks by it."""
    jcfg, jparams, cfg, params = _smoke(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 12, 20, 9)]
    kw = dict(max_slots=4, num_pages=33, page_size=4)
    with numerics.use(**FORCED):
        jout = JaxEngine(jcfg, jparams, **kw).run(
            prompts, JaxSamplingParams(max_tokens=6))
    out = Engine(cfg, params, device="cpu", **kw).run(
        prompts, SamplingParams(max_tokens=6))
    assert {r: list(v) for r, v in out.items()} == \
        {r: list(v) for r, v in jout.items()}
    assert {r: v.finish_reason for r, v in out.items()} == \
        {r: v.finish_reason for r, v in jout.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_jax_generate(arch):
    jcfg, jparams, cfg, params = _smoke(arch)
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 10))
    with numerics.use(**FORCED):
        ref = np.asarray(jax_generate(jcfg, jparams, jnp.asarray(prompts), 6))
    out = serve.generate(cfg, params, prompts, 6, device="cpu")
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------- kernels at hd 256

def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# Kernel 2's plain version at head_dim 256 (32-key tiles, 16 at x10)
# against JAX's Pallas kernel: gemma-2b's MQA (8 query heads on one kv
# head) causal, gemma2-9b's softcap 50 with a window, x10 (the 16-key
# tiles), non-causal queries at the tail of the keys, and one tile (S 20,
# the normalize-first branch).
HD256_CASES = {
    "mqa-causal": dict(S=40, T=40, heads=(8, 1), causal=True, window=0,
                       softcap=None),
    "window-softcap": dict(S=40, T=40, heads=(4, 2), causal=True, window=13,
                           softcap=50.0),
    "x10-window-softcap": dict(S=40, T=40, heads=(4, 2), causal=True,
                               window=13, softcap=50.0,
                               policy="tcec_bf16x10"),
    "x3-causal": dict(S=40, T=40, heads=(8, 1), causal=True, window=0,
                      softcap=None, policy="tcec_bf16x3"),
    "non-causal-tail": dict(S=12, T=40, heads=(4, 2), causal=False, window=0,
                            softcap=None),
    "one-tile": dict(S=20, T=20, heads=(8, 1), causal=True, window=0,
                     softcap=50.0),
}


@pytest.mark.parametrize("case", sorted(HD256_CASES))
def test_attention_plain_at_hd_256_matches_jax_kernel(case):
    c = HD256_CASES[case]
    (H, Hkv), hd, S, T = c["heads"], 256, c["S"], c["T"]
    q = _normal((1, S, H, hd), 30)
    k = _normal((1, T, Hkv, hd), 31)
    v = _normal((1, T, Hkv, hd), 32)
    q_pos = np.arange(T - S, T, dtype=np.int32)
    k_pos = np.arange(T, dtype=np.int32)
    policy = c.get("policy", "tcec_bf16x6")
    kw = dict(policy=policy, causal=c["causal"], window=c["window"],
              softcap=c["softcap"])
    ref = np.asarray(jax_tcec_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), block=(128, 128), interpret=True, **kw))
    t = [torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)]
    out = tcec_attention.tcec_attention(*t, **kw).numpy()
    assert out.shape == ref.shape == (1, S, H, hd)
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(v))


def test_attention_refuses_head_dims_over_256():
    q = torch.randn(1, 4, 2, 260)
    k = torch.randn(1, 4, 1, 260)
    with pytest.raises(ValueError, match="256"):
        tcec_attention.tcec_attention(q, k, k)
    assert tcec_attention.key_tile(3, 256) == 32
    assert tcec_attention.key_tile(4, 256) == 16
    assert tcec_attention.key_tile(4, 128) == 32


def _paged_case(B, Hkv, rep, ps, maxp, seed, hd=256):
    rng = np.random.default_rng(seed)
    NP = 1 + B * maxp
    kp = jnp.asarray(rng.standard_normal((NP, ps, Hkv, hd)), jnp.bfloat16)
    vp = jnp.asarray(rng.standard_normal((NP, ps, Hkv, hd)), jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, hd)), jnp.float32)
    bt = jnp.asarray(
        rng.permutation(np.arange(1, NP)).reshape(B, maxp), jnp.int32)
    lengths = jnp.asarray(rng.integers(1, maxp * ps, B), jnp.int32)
    return q, kp, vp, bt, lengths.at[0].set(0)     # slot 0 empty


# Kernel 3's plain version at hd 256 against JAX's paged kernel: MQA at
# rep 8 (gemma-2b) and 2 kv heads at rep 2 (gemma2-9b), with a window and
# the softcap, at the chunk sizes the rule takes there (1 and 2 pages).
@pytest.mark.parametrize("rep,Hkv,window,softcap,C", [
    (8, 1, 0, None, 1), (8, 1, 9, 50.0, 2), (2, 2, 0, 50.0, 2),
    (2, 2, 13, None, 1)])
def test_paged_plain_at_hd_256_matches_jax_kernel(rep, Hkv, window, softcap,
                                                  C):
    q, kp, vp, bt, lengths = _paged_case(3, Hkv, rep, 8, 5,
                                         seed=rep + window + C)
    ref = np.asarray(jax_tcec_paged_attention(
        q, kp, vp, bt, lengths, window=window, softcap=softcap,
        pages_per_step=1, interpret=True))
    tq, tk, tv, tbt, tl = (tensor_from_numpy(np.asarray(x))
                           for x in (q, kp, vp, bt, lengths))
    out = tcec_paged_attention.tcec_paged_attention(
        tq, tk, tv, tbt, tl, window=window, softcap=softcap,
        pages_per_chunk=C).numpy()
    assert np.all(out[0] == 0.0)
    vmax = float(np.max(np.abs(np.asarray(vp, np.float32))))
    assert np.max(np.abs(out - ref)) <= 1e-5 * vmax


def test_chunk_pages_at_hd_256():
    """32 KB of bf16 K and V a chunk: 2 pages of 16 at hd 256, fewer where
    the slots' chunks would not give the card two blocks an SM."""
    cp = tcec_paged_attention.chunk_pages
    assert cp(4, 8, 320, 16, 256, 256) == 2       # gemma2-9b, 5000 tokens
    assert cp(4, 8, 40, 16, 256, 256) == 2
    assert cp(4, 1, 40, 16, 256, 256) == 1        # gemma-2b's one kv head
    assert cp(4, 8, 40, 16, 128, 128) == 4        # qwen3, as before
    assert cp(64, 8, 40, 64, 256, 256) == 1       # pages of 64: one a chunk
    assert cp(4, 8, 320, 16, 256, 128) == 2


# ------------------------------------------------------------- init

def _old_rule(monkeypatch):
    """The initializers before the memory plan: scaled copies of ``randn``
    and every layer tree built, then stacked."""
    def dense_init(gen, shape, fan_in=None, device=None):
        fan_in = fan_in if fan_in is not None else shape[0]
        return torch.randn(shape, generator=gen, device=device) * (
            1.0 / np.sqrt(max(fan_in, 1)))

    def embed_init(gen, shape, device=None):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def stack_init(init_fn, n):
        trees = [init_fn() for _ in range(n)]
        return modules.tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)

    for mod in (lm, layers, mla):
        monkeypatch.setattr(mod, "dense_init", dense_init)
    monkeypatch.setattr(lm, "embed_init", embed_init)
    monkeypatch.setattr(lm, "stack_init", stack_init)


@pytest.mark.parametrize("arch", ARCHS + ["granite-moe-1b-a400m",
                                          "deepseek-v3-671b"])
def test_stack_init_is_bitwise_the_stack_of_layer_trees(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    cfg = cfg.replace(n_layers=3 + cfg.first_dense_layers)
    new = lm.init(cfg, seed=5, device="cpu")
    with monkeypatch.context() as m:
        _old_rule(m)
        old = lm.init(cfg, seed=5, device="cpu")
    a, b = modules.tree_leaves(new), modules.tree_leaves(old)
    assert len(a) == len(b)
    assert all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))
    assert any(x.shape[0] == 3 for x in a)


class _LiveBytes(TorchDispatchMode):
    """The peak of the bytes that tensors made under the mode hold: each
    storage counted once, from the operation that made it until it is
    freed."""

    def __init__(self):
        super().__init__()
        self.live, self.now, self.peak = {}, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.now -= n
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta:
                st = t.untyped_storage()
                if st.data_ptr() not in self.live:
                    self.live[st.data_ptr()] = (StorageWeakRef(st),
                                                st.nbytes())
                    self.now += st.nbytes()
        self.peak = max(self.peak, self.now)
        return out


def test_stack_init_peak_is_the_weights_when_one_layer_outweighs_the_rest(
        monkeypatch):
    """deepseek-v3-671b's shape at smoke widths: one dense layer, then one
    MoE layer of 64 experts that outweighs the rest of the tree.  Each
    leaf is drawn into its slot, so the init holds no more than the
    weights and one leaf; stacking layer trees (or copying a layer in)
    holds that layer beside its stack."""
    cfg = get_smoke_config("deepseek-v3-671b").replace(
        n_layers=2, n_experts=64, mtp=False)
    with _LiveBytes() as mem:
        params = lm.init(cfg, seed=0, device="cpu")
    leaves = modules.tree_leaves(params)
    weights = sum(t.nbytes for t in leaves)
    moe = sum(t.nbytes for t in modules.tree_leaves(params["moe_blocks"]))
    assert moe > weights - moe                 # the MoE layer outweighs
    largest = max(max(t[0].nbytes for t in modules.tree_leaves(v))
                  if k.endswith("blocks") else v.nbytes
                  for k, v in params.items())
    assert weights <= mem.peak <= weights + largest
    with monkeypatch.context() as m, _LiveBytes() as old:
        _old_rule(m)
        lm.init(cfg, seed=0, device="cpu")
    assert old.peak > weights + largest        # the gate bites


def test_stack_init_takes_the_meta_device():
    cfg = get_smoke_config("gemma2-9b")
    params = lm.init(cfg, seed=0, device="meta")
    assert all(t.is_meta for t in modules.tree_leaves(params))
    assert modules.param_count(params) == modules.param_count(
        lm.init(cfg, seed=0, device="cpu"))
