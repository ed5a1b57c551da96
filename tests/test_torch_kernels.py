"""The port's three kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
kernels run in ``interpret=True`` mode.  Inputs are made with numpy from a
seed and go through both.  Tolerances are scaled to the f32 SGEMM error,
never a fixed atol:

  * products: ``|d| <= 8 * K * 2^-24 * (|A| @ |B|)`` elementwise;
  * attention outputs: ``|d| <= 1e-5 * max|v|`` (the output is a convex
    combination of the rows of v; the two sides differ only in f32
    summation order, ``exp`` rounding and the online-softmax block size).

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import tcec_matmul as jax_tcec_matmul  # noqa: E402
from repro.kernels.tcec_attention import (  # noqa: E402
    tcec_attention as jax_tcec_attention)
from repro.kernels.tcec_paged_attention import (  # noqa: E402
    tcec_paged_attention as jax_tcec_paged_attention)
from repro_torch.kernels import (dispatch, ops, tcec_attention,  # noqa: E402
                                 tcec_matmul, tcec_paged_attention)
from repro_torch.kernels.ref import (epilogue_ref, matmul_f64,  # noqa: E402
                                     tcec_bmm_ref, tcec_matmul_ref)

U24 = 2.0 ** -24


def _urand(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _gemm_tol(a, b):
    """8 K u (|A| @ |B|) in f64, broadcast like the product."""
    k = a.shape[-1]
    return 8 * k * U24 * (np.abs(a).astype(np.float64)
                          @ np.abs(b).astype(np.float64))


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ----------------------------------------------------------------- kernel 1

@pytest.mark.parametrize("policy", ["tcec_bf16x3", "tcec_bf16x6",
                                    "tcec_bf16x10"])
@pytest.mark.parametrize("shape", [(70, 50, 90), (3, 130, 200),
                                   (2, 40, 30, 60), (4, 70, 200),
                                   (1, 50, 90)])
def test_matmul_plain_matches_jax_kernel(policy, shape):
    """2-D and batched, ragged M/N/K (the JAX wrapper pads, the port's
    kernel masks), and decode-sized M (the kernel's skinny path)."""
    *bsh, m, n, k = shape
    a = _urand((*bsh, m, k), seed=m + k)
    b = _urand((*bsh, k, n), seed=n + k + 1)
    ref = np.asarray(jax_tcec_matmul(jnp.asarray(a), jnp.asarray(b),
                                     policy=policy, block=(128, 128, 128),
                                     interpret=True))
    out = ops.tcec_matmul(_t(a), _t(b), policy=policy).numpy()
    assert out.shape == ref.shape
    assert np.all(np.abs(out - ref) <= _gemm_tol(a, b))


@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "tanh"])
def test_matmul_epilogue_matches_jax_kernel(activation):
    m, n, k = 33, 47, 65
    a, b = _urand((m, k), 1), _urand((k, n), 2)
    bias = _urand((n,), 3)
    ref = np.asarray(jax_tcec_matmul(
        jnp.asarray(a), jnp.asarray(b), policy="tcec_bf16x6",
        block=(128, 128, 128), interpret=True, bias=jnp.asarray(bias),
        activation=activation, out_scale=0.5))
    out = ops.tcec_matmul(_t(a), _t(b), policy="tcec_bf16x6", bias=_t(bias),
                          activation=activation, out_scale=0.5).numpy()
    # the product error scaled by out_scale through a <= 1.2-Lipschitz
    # activation, plus a few ulps of the epilogue's own rounding
    tol = 1.2 * 0.5 * _gemm_tol(a, b) + 8 * U24 * np.abs(ref)
    assert np.all(np.abs(out - ref) <= tol)


def test_matmul_plain_is_the_oracle_function():
    a, b = _urand((2, 64, 96), 4), _urand((2, 96, 48), 5)
    out = tcec_matmul.tcec_matmul_plain(_t(a), _t(b), "tcec_bf16x6").numpy()
    ref = tcec_bmm_ref(_t(a), _t(b), "tcec_bf16x6").numpy()
    assert np.all(np.abs(out - ref) <= _gemm_tol(a, b))
    ref0 = tcec_matmul_ref(a[0], b[0], "tcec_bf16x6").numpy()
    assert np.array_equal(ref0, ref[0])
    bias = _urand((48,), 6)
    fused = tcec_matmul.tcec_matmul_plain(_t(a[0]), _t(b[0]), "tcec_bf16x6",
                                          bias=_t(bias), activation="silu",
                                          out_scale=2.0).numpy()
    unfused = epilogue_ref(out[0], bias, "silu", 2.0).numpy()
    assert np.array_equal(fused, unfused)


def test_matmul_x6_plain_reaches_f32_accuracy():
    """The paper's claim on the plain version: x6 is at least as close to
    the f64 product as an f32 SGEMM, within a factor of 2."""
    a, b = _urand((256, 512), 0), _urand((512, 128), 1)
    ref = matmul_f64(a, b)

    def resid(c):
        return np.linalg.norm(ref - c.astype(np.float64)) / np.linalg.norm(ref)

    r6 = resid(ops.tcec_matmul(_t(a), _t(b), policy="tcec_bf16x6").numpy())
    r32 = resid((_t(a) @ _t(b)).numpy())
    assert r6 <= 2 * r32


@pytest.mark.parametrize("policy", ["tcec_bf16x3", "tcec_bf16x6",
                                    "tcec_bf16x10"])
def test_matmul_plain_in_batch_slices_is_bitwise_the_whole(policy,
                                                          monkeypatch):
    """A batched B whose f32 terms pass ``PLAIN_CHUNK_BYTES`` is taken a
    slice of the batch at a time (a deepseek-v3-671b expert stack on the
    card): bit for bit the product taken whole, epilogue included, with a
    transposed B and a ragged last slice."""
    a = _t(_urand((7, 5, 96), 8))
    b = _t(_urand((7, 48, 96), 9)).transpose(-1, -2)
    bias = _t(_urand((48,), 10))
    kw = dict(bias=bias, activation="gelu", out_scale=0.5)
    whole = tcec_matmul.tcec_matmul_plain(a, b, policy, **kw)
    terms = tcec_matmul.get_policy(policy).n_splits
    calls = []
    plain = tcec_matmul._plain
    monkeypatch.setattr(tcec_matmul, "_plain", lambda a, b, pol: calls.append(
        b.shape[0]) or plain(a, b, pol))
    monkeypatch.setattr(tcec_matmul, "PLAIN_CHUNK_BYTES",
                        3 * terms * 4 * 96 * 48)
    sliced = tcec_matmul.tcec_matmul_plain(a, b, policy, **kw)
    assert calls == [3, 3, 1]
    assert torch.equal(sliced, whole)


def test_matmul_wrapper_takes_plain_version_only_on_cpu():
    before = tcec_matmul.launches
    a, b = _urand((8, 16), 6), _urand((16, 8), 7)
    out = ops.tcec_matmul(_t(a), _t(b))
    assert out.dtype == torch.float32 and out.shape == (8, 8)
    assert tcec_matmul.launches == before        # no kernel ran on the CPU
    with pytest.raises(ValueError):
        ops.tcec_matmul(_t(a), _t(a))             # contraction mismatch
    with pytest.raises(ValueError):
        ops.tcec_matmul(_t(a), _t(b), policy="fp32")   # not a split policy


# ----------------------------------------------------------------- kernel 2

ATTN_CASES = {
    "causal-gqa": dict(S=150, T=150, causal=True, window=0, softcap=None),
    "noncausal": dict(S=70, T=150, causal=False, window=0, softcap=None),
    "window": dict(S=150, T=150, causal=True, window=40, softcap=None),
    "softcap": dict(S=100, T=100, causal=True, window=0, softcap=30.0),
    "single-block": dict(S=20, T=20, causal=True, window=0, softcap=None),
    # exactly one key tile of the x6 kernel (64 keys): its normalize-first
    # branch against the JAX kernel's single-block one
    "one-tile": dict(S=64, T=64, causal=True, window=0, softcap=None),
    # x10 runs tiles of 32 keys: three, the last ragged
    "x10-tiles": dict(S=70, T=70, causal=True, window=40, softcap=20.0,
                      policy="tcec_bf16x10"),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_plain_matches_jax_kernel(case):
    c = ATTN_CASES[case]
    B, H, Hkv, hd = 2, 4, 2, 16
    S, T = c["S"], c["T"]
    q = _normal((B, S, H, hd), 10)
    k = _normal((B, T, Hkv, hd), 11)
    v = _normal((B, T, Hkv, hd), 12)
    q_pos = np.arange(T - S, T, dtype=np.int32)       # the query tail
    k_pos = np.arange(T, dtype=np.int32)
    policy = c.get("policy", "tcec_bf16x6")
    ref = np.asarray(jax_tcec_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), policy=policy, causal=c["causal"],
        window=c["window"], softcap=c["softcap"], block=(128, 128),
        interpret=True))
    out = tcec_attention.tcec_attention(
        _t(q), _t(k), _t(v), _t(q_pos), _t(k_pos), policy=policy,
        causal=c["causal"], window=c["window"], softcap=c["softcap"]).numpy()
    assert out.shape == ref.shape == (B, S, H, hd)
    assert np.max(np.abs(out - ref)) <= 1e-5 * np.max(np.abs(v))


def test_attention_skipped_blocks_match_visited_blocks():
    """Skipping a K/V tile that is masked for every (q, k) pair is exact:
    the plain version visits every tile, and a causal row whose first tile
    is wholly masked is wiped by alpha = 0 at its first live tile.  Rows at
    the edges of the 32-row query blocks and of the 64-key tiles."""
    B, S, H, Hkv, hd = 1, 160, 2, 1, 16
    q, k, v = (_normal((B, S, H, hd), 20), _normal((B, S, Hkv, hd), 21),
               _normal((B, S, Hkv, hd), 22))
    out = tcec_attention.tcec_attention(_t(q), _t(k), _t(v))
    # the same rows computed with the keys after each query cut away
    for row in (0, 31, 32, 63, 64, 95, 127, 128, 159):
        part = tcec_attention.tcec_attention(
            _t(q[:, row:row + 1]), _t(k[:, :row + 1]), _t(v[:, :row + 1]),
            q_pos=torch.tensor([row]))
        d = (out[:, row] - part[:, 0]).abs().max()
        assert float(d) <= 1e-5 * np.max(np.abs(v))


# ----------------------------------------------------------------- kernel 3

def _paged_case(B=3, Hkv=2, rep=4, hd=64, hdv=64, ps=8, maxp=5, seed=0):
    rng = np.random.default_rng(seed)
    NP = 1 + B * maxp
    kp = jnp.asarray(rng.standard_normal((NP, ps, Hkv, hd)), jnp.bfloat16)
    vp = jnp.asarray(rng.standard_normal((NP, ps, Hkv, hdv)), jnp.bfloat16)
    q = jnp.asarray(rng.standard_normal((B, Hkv * rep, hd)), jnp.float32)
    bt = jnp.asarray(
        rng.permutation(np.arange(1, NP)).reshape(B, maxp), jnp.int32)
    lengths = jnp.asarray(rng.integers(1, maxp * ps, B), jnp.int32)
    return q, kp, vp, bt, lengths


def _port(*arrays):
    from repro_torch.bridge import tensor_from_numpy
    return [tensor_from_numpy(np.asarray(x)) for x in arrays]


@pytest.mark.parametrize("window", [0, 5, 13])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_plain_matches_jax_kernel(window, g):
    q, kp, vp, bt, lengths = _paged_case(seed=10 + window)
    lengths = lengths.at[0].set(0)                  # an empty slot
    ref = np.asarray(jax_tcec_paged_attention(
        q, kp, vp, bt, lengths, window=window, pages_per_step=g,
        interpret=True))
    tq, tk, tv, tbt, tl = _port(q, kp, vp, bt, lengths)
    out = tcec_paged_attention.tcec_paged_attention(
        tq, tk, tv, tbt, tl, window=window).numpy()
    assert out.shape == ref.shape
    assert np.all(out[0] == 0.0)                    # length 0 -> zeros
    vmax = float(np.max(np.abs(np.asarray(vp, np.float32))))
    assert np.max(np.abs(out - ref)) <= 1e-5 * vmax


def test_paged_plain_ignores_stale_garbage_in_recycled_pages():
    """Masking is a select: non-finite stale data past a slot's length —
    in later pages and inside its current page — never reaches a sum."""
    q, kp, vp, bt, lengths = _paged_case(B=2, maxp=3, seed=13)
    short = jnp.asarray([3, 5], jnp.int32)          # well inside page 0
    ref = np.asarray(jax_tcec_paged_attention(q, kp, vp, bt, short,
                                              pages_per_step=1,
                                              interpret=True))
    tq, tk, tv, tbt, tl = _port(q, kp, vp, bt, short)
    clean = tcec_paged_attention.tcec_paged_attention(tq, tk, tv, tbt, tl)
    p0, p2 = int(bt[0, 0]), int(bt[0, 2])
    tk[p2], tv[p2] = float("inf"), float("nan")     # a later page
    tk[p0, 3:], tv[p0, 3:] = float("nan"), float("inf")   # the page's tail
    dirty = tcec_paged_attention.tcec_paged_attention(tq, tk, tv, tbt, tl)
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)
    vmax = float(np.max(np.abs(np.asarray(vp, np.float32))))
    assert np.max(np.abs(clean.numpy() - ref)) <= 1e-5 * vmax


@pytest.mark.parametrize("window", [0, 5, 13])
@pytest.mark.parametrize("C", [1, 2, "maxp"])
def test_paged_chunked_plain_matches_jax_kernel(window, C):
    """The plain version with the kernel's chunks (C pages each, a partial
    per chunk, combined in chunk order) against the JAX kernel."""
    q, kp, vp, bt, lengths = _paged_case(seed=20 + window)
    lengths = lengths.at[1].set(0)                  # an empty slot
    C = bt.shape[1] if C == "maxp" else C
    ref = np.asarray(jax_tcec_paged_attention(
        q, kp, vp, bt, lengths, window=window, pages_per_step=1,
        interpret=True))
    tq, tk, tv, tbt, tl = _port(q, kp, vp, bt, lengths)
    out = tcec_paged_attention.tcec_paged_attention(
        tq, tk, tv, tbt, tl, window=window, pages_per_chunk=C).numpy()
    assert np.all(out[1] == 0.0)
    vmax = float(np.max(np.abs(np.asarray(vp, np.float32))))
    assert np.max(np.abs(out - ref)) <= 1e-5 * vmax


@pytest.mark.parametrize("C", [1, 2])
def test_paged_chunked_plain_softcap_matches_jax_kernel(C):
    q, kp, vp, bt, lengths = _paged_case(seed=31)
    ref = np.asarray(jax_tcec_paged_attention(
        q, kp, vp, bt, lengths, window=7, softcap=30.0, pages_per_step=1,
        interpret=True))
    tq, tk, tv, tbt, tl = _port(q, kp, vp, bt, lengths)
    out = tcec_paged_attention.tcec_paged_attention(
        tq, tk, tv, tbt, tl, window=7, softcap=30.0,
        pages_per_chunk=C).numpy()
    vmax = float(np.max(np.abs(np.asarray(vp, np.float32))))
    assert np.max(np.abs(out - ref)) <= 1e-5 * vmax


def test_paged_plain_ignores_stale_garbage_across_chunks():
    """The stale-garbage check at C 2: non-finite data in a dead page of a
    live chunk, in a dead chunk and in the current page's tail."""
    q, kp, vp, bt, lengths = _paged_case(B=2, maxp=3, seed=13)
    short = jnp.asarray([3, 5], jnp.int32)          # well inside page 0
    ref = np.asarray(jax_tcec_paged_attention(q, kp, vp, bt, short,
                                              pages_per_step=1,
                                              interpret=True))
    tq, tk, tv, tbt, tl = _port(q, kp, vp, bt, short)
    kw = dict(pages_per_chunk=2)
    clean = tcec_paged_attention.tcec_paged_attention(tq, tk, tv, tbt, tl,
                                                      **kw)
    p0, p1, p2 = (int(bt[0, j]) for j in range(3))
    tk[p1], tv[p1] = float("nan"), float("inf")     # dead page, live chunk
    tk[p2], tv[p2] = float("inf"), float("nan")     # a dead chunk
    tk[p0, 3:], tv[p0, 3:] = float("nan"), float("inf")   # the page's tail
    dirty = tcec_paged_attention.tcec_paged_attention(tq, tk, tv, tbt, tl,
                                                      **kw)
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)
    vmax = float(np.max(np.abs(np.asarray(vp, np.float32))))
    assert np.max(np.abs(clean.numpy() - ref)) <= 1e-5 * vmax


def test_paged_chunk_rule():
    """chunk_pages at qwen3-0.6b's decode (4 slots, 8 kv heads, 40 pages of
    16, hd 128): 4 pages, 32 KB of K and V, 320 blocks, of which the engine's
    lengths keep about 200 live; every chunk it picks stays within the
    budget, and small tables get smaller chunks to fill the card."""
    tp = tcec_paged_attention
    assert tp.chunk_pages(4, 8, 40, 16, 128, 128) == 4
    live = tp.live_chunks(torch.tensor([520, 520, 208, 208]), 40, 16, 4)
    assert live.shape == (4, 10)
    assert int(live.sum()) * 8 == 208             # phase 2's decode row
    live = tp.live_chunks(torch.tensor([520, 520, 208, 64]), 40, 16, 4)
    assert int(live.sum()) * 8 == 184             # the engine's 4 slots
    for B, Hkv, maxp, ps, hd in [(4, 8, 40, 16, 128), (32, 8, 64, 16, 128),
                                 (1, 8, 40, 16, 128), (64, 2, 30, 64, 128),
                                 (64, 2, 30, 8, 64), (64, 2, 300, 1, 16)]:
        C = tp.chunk_pages(B, Hkv, maxp, ps, hd, hd)
        assert 1 <= C <= maxp
        assert 2 * C * ps * 2 * hd <= tp.KV_BUDGET or C == 1
        assert C * ps <= max(tp.CHUNK_TOKENS, ps)
        nblocks = B * Hkv * -(-maxp // C)
        assert nblocks >= 2 * tp.SMS or C == 1
    assert tp.chunk_pages(1, 8, 40, 16, 128, 128) == 1
    # windows and empty slots: exactly the chunks holding a valid token
    ln = torch.tensor([0, 1, 64, 65, 300])
    live = tp.live_chunks(ln, 20, 16, 4, window=100)
    for b, n in enumerate(ln.tolist()):
        want = [any(max(0, n - 100) <= pos < n
                    for pos in range(c * 64, (c + 1) * 64)) for c in range(5)]
        assert live[b].tolist() == want


def _attention_direct(q, k, v, dtype):
    """Causal GQA attention computed directly in ``dtype`` (no split)."""
    S, hd, rep = q.shape[1], q.shape[3], q.shape[2] // k.shape[2]
    qs = q.to(dtype).transpose(1, 2)
    ks = k.to(dtype).repeat_interleave(rep, 2).transpose(1, 2)
    vs = v.to(dtype).repeat_interleave(rep, 2).transpose(1, 2)
    s = qs @ ks.transpose(-1, -2) / hd ** 0.5
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -np.inf)
    return (torch.softmax(s, -1) @ vs).transpose(1, 2)


def _paged_direct(q, kp, vp, bt, lengths, dtype):
    """Paged decode attention computed directly in ``dtype`` (no split)."""
    ps, hkv, hd = kp.shape[1:]
    rep = q.shape[1] // hkv
    outs = []
    for b, n in enumerate(lengths.tolist()):
        pages = bt[b, :-(-n // ps)].long()
        k = kp[pages].reshape(-1, hkv, hd)[:n].to(dtype)
        v = vp[pages].reshape(-1, hkv, hd)[:n].to(dtype)
        s = torch.einsum("hd,thd->ht", q[b].to(dtype),
                         k.repeat_interleave(rep, 1)) / hd ** 0.5
        outs.append(torch.einsum("ht,thd->hd", torch.softmax(s, -1),
                                 v.repeat_interleave(rep, 1)))
    return torch.stack(outs)


@pytest.mark.parametrize("kernel", ["attention", "paged"])
def test_f32_accuracy_gate_separates_x6_from_x3(kernel):
    """The gate chip_smoke.py holds kernels 2 and 3 to: residual against
    f64 at most 2x that of the same function computed in f32.  The x6 plain
    version passes it; x3 (one scale group fewer) does not."""
    g = torch.Generator().manual_seed(5)
    if kernel == "attention":
        q = torch.randn(1, 208, 4, 128, generator=g)
        k, v = (torch.randn(1, 208, 2, 128, generator=g) for _ in range(2))
        args = (q, k, v)
        run, direct = tcec_attention.tcec_attention_plain, _attention_direct
    else:
        nslots, maxp = 4, 40
        kp, vp = (torch.randn(1 + nslots * maxp, 16, 2, 128,
                              generator=g).bfloat16() for _ in range(2))
        q = torch.randn(nslots, 4, 128, generator=g)
        bt = (torch.randperm(nslots * maxp, generator=g) + 1).reshape(
            nslots, maxp).to(torch.int32)
        lengths = torch.tensor([520, 520, 208, 208], dtype=torch.int32)
        args = (q, kp, vp, bt, lengths)
        run = tcec_paged_attention.tcec_paged_attention_plain
        direct = _paged_direct
    ref = direct(*args, torch.float64)

    def resid(x):
        return float(torch.linalg.norm(ref - x.double())
                     / torch.linalg.norm(ref))

    r32 = resid(direct(*args, torch.float32))
    assert resid(run(*args, policy="tcec_bf16x6")) <= 2 * r32
    assert resid(run(*args, policy="tcec_bf16x3")) > 2 * r32


# ----------------------------------------------------------------- dispatch

def test_dispatch_routes_split_policies_and_declines_the_rest():
    import dataclasses
    from repro_torch.core import get_policy
    from repro_torch.core.policy import full_keep
    assert dispatch.eligible_policy(get_policy("tcec_bf16x6"))
    assert dispatch.eligible_policy(get_policy("tcec_bf16x10"))
    for name in ("fp32", "bf16", "fp16_halfhalf", "tcec_fp8e4m3x6",
                 "tcec_bf16x9"):
        assert not dispatch.eligible_policy(get_policy(name))
    # a bf16 schedule the kernels do not take is declined, not routed to a
    # wrapper that would raise
    full = dataclasses.replace(get_policy("tcec_bf16x6"), name="bf16_full",
                               keep=full_keep(3))
    assert not dispatch.eligible_policy(full)
    x = torch.randn(4, 8)
    assert dispatch.maybe_dispatch(x, x.T, full,
                                   (((1,), (0,)), ((), ()))) is None
    q = torch.randn(1, 8, 2, 16)
    assert dispatch.attention(q, q, q, policy="fp32") is None


def test_use_plain_scope_sends_calls_to_the_plain_versions():
    a, b = _urand((2, 5, 24), 30), _urand((24, 3, 8), 31)
    dims = (((2,), (0,)), ((), ()))
    from repro_torch.core.policy import get_policy
    pol = get_policy("tcec_bf16x6")
    routed = dispatch.maybe_dispatch(_t(a), _t(b), pol, dims)
    assert routed.shape == (2, 5, 3, 8)
    assert not dispatch.plain_active()
    with dispatch.use_plain():
        assert dispatch.plain_active()
        plain = dispatch.maybe_dispatch(_t(a), _t(b), pol, dims)
    assert not dispatch.plain_active()
    assert torch.equal(routed, plain)


def test_use_plain_scope_reaches_other_threads():
    """The scope is process-wide: a CUDA backward runs on autograd's worker
    thread, and its products must see the scope the caller entered."""
    import threading
    seen = []

    def probe():
        seen.append(dispatch.plain_active())

    with dispatch.use_plain():
        with dispatch.use_plain():
            t = threading.Thread(target=probe)
            t.start()
            t.join()
        assert dispatch.plain_active()
    t = threading.Thread(target=probe)
    t.start()
    t.join()
    assert seen == [True, False]
    assert not dispatch.plain_active()
