"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips on a machine without a CUDA
card; it imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances as in ``test_torch_kernels.py``: ``8 K 2^-24 (|A| @ |B|)`` for
products, ``1e-5 max|v|`` for attention outputs.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import numerics  # noqa: E402
from repro_torch.kernels import (ops, tcec_attention,  # noqa: E402
                                 tcec_matmul, tcec_paged_attention, tuning)

U24 = 2.0 ** -24
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """The autotuner (tune "auto": it measures on the card) writes to a
    file of this run, never to the home directory; process-wide, since a
    CUDA backward runs on autograd's worker thread."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_TUNE_CACHE",
              str(tmp_path_factory.mktemp("tune") / "tcec_autotune.json"))
    numerics.reload_env_defaults()
    yield
    mp.undo()
    numerics.reload_env_defaults()


# M up to 64 takes the decode path, a block for each group of 8 slots (M
# 1, 4 and 8 fill one group, 9, 16, 17 and 64 take two or more); 65 and 130
# take the wgmma path (one ragged 128-row tile, or two).  test_matmul_paths
# checks that 64 is the source's threshold.  B's rows start 16 bytes apart,
# so that both paths copy in masked 16-byte chunks, when its row length is
# a multiple of 4: for (N, K) = (72, 300) in both layouts (N ragged to 16
# and 64, K to 64 and 128), for (70, 300) only as B^T; (45, 90) is copied
# element by element.  No N or K is a multiple of 16, 64 or 128.
@pytest.mark.parametrize("policy", ["tcec_bf16x3", "tcec_bf16x6",
                                    "tcec_bf16x10"])
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 17, 64, 65, 130])
@pytest.mark.parametrize("N,K", [(72, 300), (70, 300), (45, 90)])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("batch", [None, 2])
def test_matmul_matches_plain(dev, policy, M, N, K, trans_b, batch):
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    bsh = () if batch is None else (batch,)
    a = torch.rand(*bsh, M, K, generator=g, device=dev) * 2 - 1
    if trans_b:      # B read in place as the transpose of a (.., N, K)
        b = (torch.rand(*bsh, N, K, generator=g, device=dev) * 2 - 1)
        b = b.transpose(-1, -2)
    else:
        b = torch.rand(*bsh, K, N, generator=g, device=dev) * 2 - 1
    bias = torch.rand(N, generator=g, device=dev)
    before = tcec_matmul.launches
    out = ops.tcec_matmul(a, b, policy, bias=bias, activation="silu")
    assert tcec_matmul.launches == before + 1
    ref = tcec_matmul.tcec_matmul_plain(a, b, policy, bias=bias,
                                        activation="silu")
    tol = 1.2 * 8 * K * U24 * (a.abs() @ b.abs()) + 8 * U24 * ref.abs()
    assert bool(((out - ref).abs() <= tol).all())
    out = ops.tcec_matmul(a, b, policy)
    ref = tcec_matmul.tcec_matmul_plain(a, b, policy)
    assert bool(((out - ref).abs() <= 8 * K * U24 * (a.abs() @ b.abs())).all())


def test_matmul_paths(dev):
    # the threshold is read from the CUDA source (the library's own query
    # agrees); the M of test_matmul_matches_plain sit on both sides of it
    import ctypes
    from repro_torch.kernels import _build
    m = tcec_matmul.skinny_max()
    fn = _build.library("tcec_matmul").tcec_matmul_skinny_max
    fn.restype = ctypes.c_int
    assert m == fn() == 64
    assert tcec_matmul.path(m) == "skinny"
    assert tcec_matmul.path(m + 1) == "wgmma"
    blocks, per_sm = tcec_matmul.grid(1024, 1024)
    assert blocks == 8 * 16 and per_sm >= 1
    # path S: a block for each 16 weight rows and each group of 8 slots
    assert tcec_matmul.grid(9, 1000)[0] == 2 * 63
    # a forced path's grid is its tile's (tcec_matmul.tiles(), read from
    # the source): path S past the threshold, path W below it
    for M in (4, 65, 1024):
        for name, p in (("skinny", 0), ("wgmma", 1)):
            bm, bn, _ = tcec_matmul.tiles()[name]
            assert tcec_matmul.grid(M, 1000, 2, path=p)[0] == \
                -(-M // bm) * -(-1000 // bn) * 2


# Forced paths at M the rule never gives them: path S past 64 (more groups
# of 8 slots, more blocks a weight band) and path W below 65 (ragged rows
# masked), at the shapes of test_matmul_matches_plain, both layouts.
@pytest.mark.parametrize("policy", ["tcec_bf16x3", "tcec_bf16x6",
                                    "tcec_bf16x10"])
@pytest.mark.parametrize("M", [1, 4, 17, 64, 65, 130, 1024])
@pytest.mark.parametrize("path", ["skinny", "wgmma"])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("batch", [None, 2])
def test_matmul_forced_path_matches_plain(dev, policy, M, path, trans_b,
                                          batch):
    N, K = 72, 300
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    bsh = () if batch is None else (batch,)
    a = torch.rand(*bsh, M, K, generator=g, device=dev) * 2 - 1
    b = (torch.rand(*bsh, N, K, generator=g, device=dev) * 2 - 1).mT \
        if trans_b else torch.rand(*bsh, K, N, generator=g, device=dev) * 2 - 1
    bias = torch.rand(N, generator=g, device=dev)
    tile = tcec_matmul.tiles()[path]
    before = tcec_matmul.launches, tcec_matmul.epilogue_launches["gelu"]
    out = ops.tcec_matmul(a, b, policy, bias=bias, activation="gelu",
                          block=tile)
    assert (tcec_matmul.launches, tcec_matmul.epilogue_launches["gelu"]) \
        == (before[0] + 1, before[1] + 1)
    ref = tcec_matmul.tcec_matmul_plain(a, b, policy, bias=bias,
                                        activation="gelu")
    tol = 1.2 * 8 * K * U24 * (a.abs() @ b.abs()) + 8 * U24 * ref.abs()
    assert bool(((out - ref).abs() <= tol).all())
    out = ops.tcec_matmul(a, b, policy, block=tile)
    ref = tcec_matmul.tcec_matmul_plain(a, b, policy)
    assert bool(((out - ref).abs() <= 8 * K * U24 * (a.abs() @ b.abs()))
                .all())
    # the path the rule by M gives is the launch without a tile, bitwise
    if tcec_matmul.path(M) == path:
        assert torch.equal(out, ops.tcec_matmul(a, b, policy))


def test_matmul_wrapper_raises_instead_of_falling_back(dev):
    a = torch.ones(4, 8, device=dev)
    with pytest.raises(TypeError):
        ops.tcec_matmul(a.double(), a.double().T)
    with pytest.raises(ValueError):
        ops.tcec_matmul(a.T.contiguous().T, a.T)     # a not contiguous


# MLA's absorbed decode reads per-head views of a weight stored (r, h, k)
# (r the kv rank): w_uk's ``bshk,rhk->bshr`` takes B (h, k, r) with batch
# stride k and columns h k apart (trans_b), w_uv's ``bshr,rhk->bshk`` B
# (h, r, k) with rows h k apart; on path S (M 4, the engine's slots) and
# path W (M 130).  (512, 16, 128) is full width's rank and head dim at 16
# of the 128 heads; (90, 6, 45) is ragged and not 16-byte aligned.
@pytest.mark.parametrize("policy", ["tcec_bf16x3", "tcec_bf16x6",
                                    "tcec_bf16x10"])
@pytest.mark.parametrize("M", [4, 130])
@pytest.mark.parametrize("weight", ["w_uk", "w_uv"])
@pytest.mark.parametrize("r,h,k", [(512, 16, 128), (90, 6, 45)])
def test_matmul_reads_per_head_views_in_place(dev, policy, M, weight, r, h,
                                              k):
    g = torch.Generator(device=dev).manual_seed(M + r + k)
    w = torch.randn(r, h, k, generator=g, device=dev) * r ** -0.5
    b = w.permute(1, 2, 0) if weight == "w_uk" else w.permute(1, 0, 2)
    assert tcec_matmul.b_layout(b) == ((1, k, h * k) if weight == "w_uk"
                                       else (0, k, h * k))
    a = torch.randn(h, M, b.shape[1], generator=g, device=dev)
    before = tcec_matmul.launches
    out = ops.tcec_matmul(a, b, policy)
    assert tcec_matmul.launches == before + 1
    ref = tcec_matmul.tcec_matmul_plain(a, b.contiguous(), policy)
    K = b.shape[1]
    assert bool(((out - ref).abs() <= 8 * K * U24 * (a.abs() @ b.abs()))
                .all())


def test_matmul_refuses_b_without_a_contiguous_dimension(dev):
    a = torch.randn(2, 4, 8, device=dev)
    b = torch.randn(2, 8, 32, device=dev)[..., ::2]      # strides 256, 32, 2
    assert tcec_matmul.b_layout(b) is None
    before = tcec_matmul.launches
    with pytest.raises(ValueError):
        tcec_matmul.launch(a, b)
    assert tcec_matmul.launches == before
    # dispatch copies such a B first, so a contraction still runs kernel 1
    from repro_torch.core import pdot
    out = pdot("gmk,gkn->gmn", a, b, "tcec_bf16x6")
    assert tcec_matmul.launches == before + 1
    ref = tcec_matmul.tcec_matmul_plain(a, b.contiguous())
    assert bool(((out - ref).abs() <= 8 * 8 * U24 * (a.abs() @ b.abs()))
                .all())


# Kernel 1 as the MoE layers call it: granite-moe-1b-a400m's expert products
# as one batch of 32, M = groups x capacity of the engine's decode step and
# prefills (4, 20, 40 on path S; 144, 320 on path W), the gate and up
# products (K 1024, N 512) and the down product (K 512, N 1024).
@pytest.mark.parametrize("M", [4, 20, 40, 144, 320])
@pytest.mark.parametrize("K,N", [(1024, 512), (512, 1024)])
def test_matmul_expert_batch_matches_plain(dev, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M + K)
    a = torch.randn(32, M, K, generator=g, device=dev)
    b = torch.randn(32, K, N, generator=g, device=dev) * K ** -0.5
    before = tcec_matmul.launches
    out = ops.tcec_matmul(a, b, "tcec_bf16x6")
    assert tcec_matmul.launches == before + 1
    ref = tcec_matmul.tcec_matmul_plain(a, b, "tcec_bf16x6")
    assert bool(((out - ref).abs() <= 8 * K * U24 * (a.abs() @ b.abs())).all())


# S = 150 and 100 are multiples of neither key tile (64 keys, 32 at x10);
# S = 20 and 64 are one tile (the normalize-first branch); the non-causal
# case has its queries at the tail of a longer key sequence.  Heads are
# (H, Hkv, head_dim): 16/4 heads give 16 positions a block, one kv head a
# block gives 64, and head dims below 128 are zero-padded in the kernel
# (at 64 the second warpgroup's output columns are all padding).
@pytest.mark.parametrize("policy,S,T,causal,window,softcap,heads", [
    ("tcec_bf16x3", 150, 150, True, 0, None, (16, 8, 128)),
    ("tcec_bf16x6", 150, 150, True, 0, None, (16, 8, 128)),
    ("tcec_bf16x10", 150, 150, True, 0, None, (16, 8, 128)),
    ("tcec_bf16x6", 20, 20, True, 0, None, (16, 8, 128)),
    ("tcec_bf16x6", 64, 64, True, 0, None, (16, 8, 128)),
    ("tcec_bf16x6", 200, 200, True, 64, None, (16, 8, 128)),
    ("tcec_bf16x6", 100, 100, True, 0, 30.0, (16, 8, 128)),
    ("tcec_bf16x10", 100, 100, True, 40, 30.0, (16, 8, 128)),
    ("tcec_bf16x6", 70, 150, False, 0, None, (16, 8, 128)),
    ("tcec_bf16x6", 150, 150, True, 0, None, (16, 4, 64)),
    ("tcec_bf16x10", 100, 100, True, 0, None, (16, 4, 64)),
    ("tcec_bf16x6", 150, 150, True, 0, None, (4, 4, 96)),
    ("tcec_bf16x3", 70, 150, False, 0, None, (4, 4, 96)),
    # the enc-dec family's cross-attention: one query row against the
    # memory at decode, and a decoder longer than a short memory
    ("tcec_bf16x6", 1, 512, False, 0, None, (16, 16, 64)),
    ("tcec_bf16x6", 200, 64, False, 0, None, (16, 16, 64))])
def test_attention_matches_plain(dev, policy, S, T, causal, window, softcap,
                                 heads):
    H, Hkv, hd = heads
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(2, S, H, hd, generator=g, device=dev)
    k = torch.randn(2, T, Hkv, hd, generator=g, device=dev)
    v = torch.randn(2, T, Hkv, hd, generator=g, device=dev)
    q_pos = torch.arange(T - S, T, device=dev)
    kw = dict(policy=policy, causal=causal, window=window, softcap=softcap)
    before = tcec_attention.launches
    out = tcec_attention.tcec_attention(q, k, v, q_pos, **kw)
    assert tcec_attention.launches == before + 1
    ref = tcec_attention.tcec_attention_plain(q, k, v, q_pos, **kw)
    assert float((out - ref).abs().max()) <= 1e-5 * float(v.abs().max())


def test_attention_takes_strided_views(dev):
    # the kernel reads the model layout; the entry copies only what is not
    # contiguous f32 in that layout
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 16, 90, 128, generator=g, device=dev).transpose(1, 2)
    kv = torch.randn(2, 90, 2, 8, 128, generator=g, device=dev)
    k, v = kv[:, :, 0], kv[:, :, 1].bfloat16()
    out = tcec_attention.tcec_attention(q, k, v)
    ref = tcec_attention.tcec_attention_plain(q, k, v)
    assert float((out - ref).abs().max()) <= 1e-5 * float(v.abs().max())


def test_attention_wrapper_raises_instead_of_falling_back(dev):
    q = torch.randn(1, 8, 2, 18, device=dev)     # head_dim not a multiple of 4
    k = torch.randn(1, 8, 1, 18, device=dev)
    with pytest.raises(ValueError):
        tcec_attention.tcec_attention(q, k, k)


@pytest.mark.parametrize("window", [0, 20])
def test_paged_attention_matches_plain(dev, window):
    g = torch.Generator(device=dev).manual_seed(window)
    B, Hkv, rep, hd, ps, maxp = 4, 8, 2, 128, 16, 6
    NP = 1 + B * maxp
    kp = torch.randn(NP, ps, Hkv, hd, generator=g, device=dev).bfloat16()
    vp = torch.randn(NP, ps, Hkv, hd, generator=g, device=dev).bfloat16()
    q = torch.randn(B, Hkv * rep, hd, generator=g, device=dev)
    bt = (torch.randperm(NP - 1, generator=g, device=dev) + 1).reshape(
        B, maxp).to(torch.int32)
    lengths = torch.tensor([0, 1, 40, 96], dtype=torch.int32, device=dev)
    out = tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, lengths,
                                                     window=window)
    ref = tcec_paged_attention.tcec_paged_attention_plain(
        q, kp, vp, bt, lengths, window=window)
    assert bool((out[0] == 0).all())
    assert float((out - ref).abs().max()) <= 1e-5 * float(
        vp.float().abs().max())


def _paged_inputs(dev, lengths, Hkv, rep, hd, hdv, ps, maxp, seed):
    """Pools with one spare page beyond the slots' tables (page 0, never
    listed), a random table and q."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    NP = 1 + B * maxp
    kp = torch.randn(NP, ps, Hkv, hd, generator=g, device=dev).bfloat16()
    vp = torch.randn(NP, ps, Hkv, hdv, generator=g, device=dev).bfloat16()
    q = torch.randn(B, Hkv * rep, hd, generator=g, device=dev)
    bt = (torch.randperm(NP - 1, generator=g, device=dev) + 1).reshape(
        B, maxp).to(torch.int32)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, ln


# Kernel against plain at the same C (pages a chunk): the lengths sit on the
# edges of a page and of a chunk (0, 1, ps, C ps - 1, C ps, C ps + 1 and the
# whole table), windows cut across a chunk edge, maxp 1 normalises before
# P.V, C 2 at pages of 64 takes 107 KB of shared memory at x10 (above the
# 48 KB default), head dims not a multiple of 8 take the element-wise
# gather, and two cases cap the scores (softcap 30).  Each case runs twice:
# the two outputs are bitwise equal.
@pytest.mark.parametrize("policy,ps,C,maxp,rep,hd,hdv,window,softcap", [
    ("tcec_bf16x6", 16, 4, 10, 2, 128, 128, 0, None),
    ("tcec_bf16x6", 16, 4, 10, 2, 128, 128, 50, None),
    ("tcec_bf16x3", 8, 8, 9, 1, 64, 64, 0, None),
    ("tcec_bf16x3", 8, 3, 9, 1, 64, 64, 30, None),
    ("tcec_bf16x10", 64, 2, 3, 8, 128, 128, 0, None),
    ("tcec_bf16x6", 64, 1, 3, 8, 128, 128, 100, None),
    ("tcec_bf16x6", 16, 1, 1, 2, 128, 128, 0, None),
    ("tcec_bf16x10", 16, 3, 7, 8, 64, 64, 20, None),
    ("tcec_bf16x6", 16, 2, 4, 2, 36, 20, 0, None),
    ("tcec_bf16x6", 16, 4, 10, 2, 128, 128, 0, 30.0),
    ("tcec_bf16x10", 8, 3, 9, 4, 64, 64, 30, 30.0)])
def test_paged_attention_chunks_match_plain(dev, policy, ps, C, maxp, rep, hd,
                                            hdv, window, softcap):
    n = C * ps
    lengths = sorted({0, 1, ps, n - 1, n, n + 1, maxp * ps} - {-1})
    lengths = [min(x, maxp * ps) for x in lengths]
    q, kp, vp, bt, ln = _paged_inputs(dev, lengths, 2, rep, hd, hdv, ps, maxp,
                                      seed=ps + C + maxp + window)
    kw = dict(policy=policy, window=window, softcap=softcap,
              pages_per_chunk=C)
    before = tcec_paged_attention.launches
    out = tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, ln, **kw)
    assert tcec_paged_attention.launches == before + 1   # one a call
    again = tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, ln, **kw)
    ref = tcec_paged_attention.tcec_paged_attention_plain(q, kp, vp, bt, ln,
                                                          **kw)
    assert torch.equal(out, again)
    assert bool((out[ln <= 0] == 0).all())
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-5 * float(
        vp.float().abs().max())


@pytest.mark.parametrize("C", [1, 2, 4])
def test_paged_attention_ignores_stale_pages(dev, C):
    """NaN and Inf in pages no slot lists, in listed pages past a slot's
    length and in the tail of a slot's last page leave the output as it
    was, bit for bit."""
    ps, maxp = 16, 6
    lengths = [0, 5, 40, 70]
    q, kp, vp, bt, ln = _paged_inputs(dev, lengths, 8, 2, 128, 128, ps, maxp,
                                      seed=C)
    kw = dict(window=0, pages_per_chunk=C)
    clean = tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, ln, **kw)
    kp[0], vp[0] = float("nan"), float("inf")         # listed by no slot
    for row, n in zip(bt.tolist(), lengths):
        used = -(-n // ps)
        for page in row[used:]:                       # past the length
            kp[page], vp[page] = float("inf"), float("nan")
        if used and n % ps:                           # the last page's tail
            kp[row[used - 1], n % ps:] = float("nan")
            vp[row[used - 1], n % ps:] = float("-inf")
    dirty = tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, ln, **kw)
    assert bool(torch.isfinite(dirty).all())
    assert torch.equal(dirty, clean)


def test_paged_wrapper_raises_instead_of_falling_back(dev):
    q, kp, vp, bt, ln = _paged_inputs(dev, [5], 1, 2, 64, 64, 16, 2, seed=0)
    with pytest.raises(TypeError):                    # f32 pools
        tcec_paged_attention.tcec_paged_attention(q, kp.float(), vp.float(),
                                                  bt, ln)
    with pytest.raises(ValueError):                   # rep 9
        tcec_paged_attention.tcec_paged_attention(q.repeat(1, 9, 1)[:, :9],
                                                  kp, vp, bt, ln)


# ----------------------------------------------------- the decode program

def _smoke_engine(dev, maxp=66):
    """The engine at the smoke config (2 layers, 2 kv heads, head dim 16)
    on the card, pages of 4 tokens.  66 table columns make kernel 3 take
    chunks of 2 pages (8 tokens), so the combine pass runs too."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serving import Engine
    cfg = get_smoke_config("qwen3-0.6b")
    params = get_model(cfg).init(seed=0, device=dev)
    assert tcec_paged_attention.chunk_pages(4, cfg.n_kv_heads, maxp, 4,
                                            cfg.head_dim) == 2
    return Engine(cfg, params, max_slots=4, num_pages=65, page_size=4,
                  max_pages_per_slot=maxp, device=dev)


def _check_replays(eng, monkeypatch) -> list:
    """From now on, hold every replayed step of ``eng`` against eager
    ``_decode_and_sample`` on a copy of the same state: logits, guard bits,
    tokens and the pools after the step bitwise equal.  Returns the list to
    which each compared step appends whether it sampled."""
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.serving import engine as em
    B, maxp = eng.max_slots, eng.max_pages_per_slot
    dev = eng.device
    launch = em._DecodeGraph.launch
    sampled_steps = []

    def checked(self, staged, sample):
        pools = tree_map(torch.clone, eng.pools)
        v = em._input_views(staged.to(dev), B, maxp)
        out, done = launch(self, staged, sample)
        done.synchronize()
        toks, finite, logits = em._decode_and_sample(
            eng.params, pools, v["block_tables"], v["lengths"],
            v["next_tok"], v["temps"], v["topks"], v["topps"],
            v["uniforms"], model=eng.model, cfg=eng.cfg)
        assert torch.equal(logits, self.logits)
        assert out[0].tolist() == finite.long().tolist()
        assert out[1].tolist() == toks.tolist()
        for a, b in zip(tree_leaves(pools), tree_leaves(eng.pools)):
            assert torch.equal(a, b)
        sampled_steps.append(sample)
        return out, done

    monkeypatch.setattr(em._DecodeGraph, "launch", checked)
    return sampled_steps


def test_decode_graph_replay_bitwise_equals_eager(dev, monkeypatch):
    """Every replayed step against eager ``_decode_and_sample`` on a copy
    of the same state: logits, guard bits, tokens and the pools after the
    step are bitwise equal.  Over 12 steps the lengths cross page (4) and
    chunk (8) boundaries, greedy and sampled slots share steps (and the
    last steps are all greedy: the sampler graph is skipped), a slot
    finishes and stays empty for two steps, and a new request takes it."""
    import numpy as np
    from repro_torch.serving import SamplingParams
    eng = _smoke_engine(dev)
    sampled_steps = _check_replays(eng, monkeypatch)
    rng = np.random.default_rng(0)
    V = eng.cfg.vocab_size
    for n, kw in ((6, dict(max_tokens=13)),
                  (13, dict(max_tokens=5, temperature=0.8, top_k=20,
                            top_p=0.9, seed=1)),
                  (3, dict(max_tokens=3)),
                  (21, dict(max_tokens=7, temperature=1.1, seed=2))):
        eng.add_request(rng.integers(0, V, n), SamplingParams(**kw))
    for step in range(12):
        if step == 4:        # slot 2 has been empty since step 2
            eng.add_request(rng.integers(0, V, 9), SamplingParams(
                max_tokens=6, temperature=0.7, top_p=0.5, seed=3))
        eng.step()
    stats = eng.stats()
    assert stats["decode_steps"] == stats["graph_replays"] == 12
    assert len(sampled_steps) == 12
    assert True in sampled_steps and False in sampled_steps
    assert stats["sampler_replays"] == sum(sampled_steps)
    assert all(r.finish_reason == "length" for r in eng.results().values())


def test_decode_graph_counts_launches(dev):
    """Each replay adds 7L + 1 to kernel 1's count and L to kernel 3's;
    the capture adds nothing, the eager warm-up one step's worth."""
    from repro_torch.serving import SamplingParams
    eng = _smoke_engine(dev)
    L = eng.cfg.n_layers
    for n in (5, 7):          # one prefill of two prompts padded to 8
        eng.add_request(list(range(1, n + 1)), SamplingParams(max_tokens=6))
    mods = (tcec_matmul, tcec_attention, tcec_paged_attention)
    before = [m.launches for m in mods]
    eng.step()                    # prefill, warm-up, capture, one replay
    stats = eng.stats()
    assert stats["prefills"] == 1 and stats["decode_warmups"] == 1
    assert stats["graph_replays"] == 1 and stats["capture_s"] > 0
    assert [m.launches - n for m, n in zip(mods, before)] == [
        (7 * L + 1) * 3, L, 2 * L]
    for _ in range(3):
        before = [m.launches for m in mods]
        eng.step()
        assert [m.launches - n for m, n in zip(mods, before)] == [
            7 * L + 1, 0, L]


def test_decode_graph_non_finite_slot_fails_only_that_slot(dev):
    """NaN in one slot's cached K makes only that slot's guard bit false:
    it finishes with ``error``, the others run to their length.  This holds
    for dense configs only: in a MoE layer the one-hot dispatch and combine
    products carry ``0 * NaN`` into every slot of the routing group, as the
    JAX package does."""
    from repro_torch.serving import SamplingParams
    eng = _smoke_engine(dev)
    rids = [eng.add_request(list(range(1, n + 1)), SamplingParams(
        max_tokens=5, temperature=0.0 if i else 0.9, seed=i))
        for i, n in enumerate((7, 9, 12))]
    eng.step()
    bad = eng._requests[rids[1]]
    eng.pools["dense_blocks"]["k"][0, bad.pages[0], 2] = float("nan")
    out = eng.run()
    assert out[rids[1]].finish_reason == "error"
    assert len(out[rids[1]]) == 2         # the tokens from before the NaN
    for r in (rids[0], rids[2]):
        assert out[r].finish_reason == "length" and len(out[r]) == 5
    assert eng.stats()["numerics_errors"] == 1


# ------------------------------------------------------------- training

def test_policy_function_keeps_the_forward_and_runs_kernel_1(dev):
    """With autograd the forward's bits are those without it; the backward
    launches kernel 1 twice, and its gradients are the bits of the same
    products called directly."""
    from repro_torch.core import pdot, policy_mm
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(70, 300, generator=g, device=dev)
    b = torch.randn(300, 72, generator=g, device=dev)
    plain = policy_mm(a, b, "tcec_bf16x6")
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = policy_mm(ta, tb, "tcec_bf16x6")
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    go = torch.randn(70, 72, generator=g, device=dev)
    before = tcec_matmul.launches
    out.backward(go)
    assert tcec_matmul.launches - before == 2
    assert torch.equal(ta.grad, pdot("mn,kn->mk", go, b, "tcec_bf16x6"))
    assert torch.equal(tb.grad, pdot("mk,mn->kn", a, go, "tcec_bf16x6"))


def test_train_step_through_kernels_matches_plain(dev):
    """One train step of the smoke model through kernels 1 and 2 against the
    same step under ``dispatch.use_plain()``: 34L + 3 kernel-1 and 2L
    kernel-2 launches, and none on the plain side (its backward runs on
    autograd's worker thread, which must see the scope too); loss and gradient norm within 1e-5 relative, the new
    parameters within 1e-6 of their scale (eps 1 keeps the update smooth in
    the gradient)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, device_batch
    from repro_torch.kernels import dispatch
    from repro_torch.launch.step import make_train_step
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves
    from repro_torch.optim import adamw
    cfg = get_smoke_config("qwen3-0.6b")
    L = cfg.n_layers
    opt = adamw.OptConfig(lr=1e-3, warmup_steps=1, eps=1.0)
    params = get_model(cfg).init(0, device=dev)
    state = {"params": params, "opt": adamw.init_state(params, opt)}
    batch = device_batch(cfg, DataConfig(global_batch=4, seq_len=16), 0, dev)
    step = make_train_step(cfg, opt)
    before = (tcec_matmul.launches, tcec_attention.launches)
    new, met = step(state, batch)
    assert (tcec_matmul.launches - before[0],
            tcec_attention.launches - before[1]) == (34 * L + 3, 2 * L)
    before = (tcec_matmul.launches, tcec_attention.launches)
    with dispatch.use_plain():
        pnew, pmet = step(state, batch)
    assert (tcec_matmul.launches, tcec_attention.launches) == before
    for k in ("loss", "grad_norm"):
        assert abs(float(met[k]) - float(pmet[k])) <= 1e-5 * abs(
            float(pmet[k]))
    for a, b in zip(tree_leaves(new["params"]), tree_leaves(pnew["params"])):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-3)


# ------------------------------------------------------------------ MoE

@pytest.mark.parametrize("B,S", [(2, 512), (4, 1)])
def test_moe_layer_through_kernels_matches_plain(dev, monkeypatch, B, S):
    """One granite-moe-1b-a400m MoE layer at full width, on identical
    inputs, through the kernels and under ``dispatch.use_plain()``: the
    router and the bf16 dispatch and combine products are plain products on
    both sides, so the routes are bitwise equal; the kernel side launches
    kernel 1 three times (gate, up, down), the plain side never; the output
    is within 2^-8 of its largest entry (the combine product rounds the
    experts' outputs to bf16) and the aux term equal."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers
    from repro_torch.models.modules import generator
    cfg = get_config("granite-moe-1b-a400m")
    p = layers.moe_init(generator(0, dev), cfg, dev)
    x = torch.randn(B, S, cfg.d_model, generator=generator(1, dev),
                    device=dev)
    seen, route = [], layers.moe_route
    monkeypatch.setattr(layers, "moe_route",
                        lambda *a: seen.append(route(*a)) or seen[-1])
    with torch.no_grad():
        n0 = tcec_matmul.launches
        y, aux = layers.moe(p, x, cfg)
        n1 = tcec_matmul.launches
        with dispatch.use_plain():
            py, paux = layers.moe(p, x, cfg)
    assert (n1 - n0, tcec_matmul.launches - n1) == (3, 0)
    for k in ("topi", "pos", "keep"):
        assert torch.equal(seen[0][k], seen[1][k])
    assert torch.equal(aux, paux)
    assert bool(torch.isfinite(y).all())
    assert float((y - py).abs().max()) <= 2.0 ** -8 * float(py.abs().max())


def test_moe_decode_graph_replays_and_counts(dev, monkeypatch):
    """granite-moe-1b-a400m cut to 2 layers at full widths: the first three
    replayed decode steps are bitwise equal to eager (greedy and sampled
    slots); then, without the eager comparison (which launches kernels of
    its own), a step launches kernel 1 2 x 7 + 1 times (q, k, v, o, the
    three expert products, the unembed) and kernel 3 twice."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, SamplingParams
    cfg = get_config("granite-moe-1b-a400m").replace(n_layers=2)
    params = get_model(cfg).init(0, device=dev)
    L = cfg.n_layers
    eng = Engine(cfg, params, max_slots=4, num_pages=1 + 4 * 6,
                 page_size=16, max_pages_per_slot=6, device=dev)
    sampled_steps = _check_replays(eng, monkeypatch)
    rng = np.random.default_rng(0)
    for n, kw in ((40, {}), (17, dict(temperature=0.8, top_k=50, seed=1)),
                  (33, {}), (5, dict(temperature=1.0, seed=2))):
        eng.add_request(rng.integers(0, cfg.vocab_size, n),
                        SamplingParams(max_tokens=7, **kw))
    for _ in range(3):            # prefills, warm-up, capture; replays
        eng.step()
    monkeypatch.undo()
    assert len(sampled_steps) == 3 and all(sampled_steps)
    mods = (tcec_matmul, tcec_attention, tcec_paged_attention)
    for _ in range(3):
        before = [m.launches for m in mods]
        eng.step()
        assert [m.launches - n for m, n in zip(mods, before)] == [
            7 * L + 1, 0, L]
    out = eng.run()
    assert all(len(v) == 7 and v.finish_reason == "length"
               for v in out.values())
    stats = eng.stats()
    assert stats["graph_replays"] == stats["decode_steps"] == 6


# --------------------------------------------------- SSM and hybrid

# Kernel 1 as the SSD chunk products call it at mamba2-130m's 2 x 512 (chunks
# of 256, 24 heads of 64, state 128): y_intra a batch of B G r = 48 with N
# 64, the chunk state a batch of 2 whose A is the transpose of a
# contiguous (K, M) tensor (the entry copies it, as _canonicalize does), the
# scores a batch of 2 at K 128; and zamba2-1.2b's w_cat at decode (K 4096).
@pytest.mark.parametrize("batch,M,K,N,trans_a", [
    (48, 256, 256, 64, False), (2, 128, 256, 1536, True),
    (2, 256, 128, 256, False), (None, 4, 4096, 2048, False)])
def test_matmul_ssd_products_match_plain(dev, batch, M, K, N, trans_a):
    g = torch.Generator(device=dev).manual_seed(M + K + N)
    bsh = () if batch is None else (batch,)
    a = (torch.randn(*bsh, K, M, generator=g, device=dev).transpose(-1, -2)
         if trans_a else torch.randn(*bsh, M, K, generator=g, device=dev))
    b = torch.randn(*bsh, K, N, generator=g, device=dev) * K ** -0.5
    before = tcec_matmul.launches
    out = ops.tcec_matmul(a.contiguous(), b, "tcec_bf16x6")
    assert tcec_matmul.launches == before + 1
    ref = tcec_matmul.tcec_matmul_plain(a, b, "tcec_bf16x6")
    assert bool(((out - ref).abs() <= 8 * K * U24 * (a.abs() @ b.abs())).all())


def _ssm_smoke(dev, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    return cfg, model, model.init(seed=0, device=dev)


def _launches():
    return [m.launches for m in (tcec_matmul, tcec_attention,
                                 tcec_paged_attention)]


# Launches of one forward at 2 x 32 (two chunks of 16) and one decode step:
# mamba2 (2 layers) 6 projections a layer + 4 chunk products a chunk + the
# unembed; zamba2 (5 Mamba layers, the shared block applied twice) adds 9
# products and one kernel-2 launch an application of the shared block.
@pytest.mark.parametrize("arch,forward,step", [
    ("mamba2-130m", [(6 + 4 * 2) * 2 + 1, 0, 0], [6 * 2 + 1, 0, 0]),
    ("zamba2-1.2b", [14 * 5 + 9 * 2 + 1, 2, 0], [6 * 5 + 9 * 2 + 1, 0, 0])])
def test_ssm_families_through_kernels_match_plain(dev, arch, forward, step):
    """The smoke models' ``forward_logits`` at 2 x 32 and three decode
    steps through the kernels against ``dispatch.use_plain()``: logits
    within 1e-5 of their largest entry, the launch counts above on the
    kernel side, none on the plain side."""
    from repro_torch.kernels import dispatch
    cfg, model, params = _ssm_smoke(dev, arch)
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    with torch.no_grad():
        n0 = _launches()
        fast = model.forward_logits(params, toks)
        n1 = _launches()
        with dispatch.use_plain():
            plain = model.forward_logits(params, toks)
        assert _launches() == n1
        assert [b - a for a, b in zip(n0, n1)] == forward
        assert float((fast - plain).abs().max()) <= 1e-5 * float(
            plain.abs().max())
        caches = [model.init_cache(2, 4, device=dev) for _ in range(2)]
        for i in range(3):
            n0 = _launches()
            fast, _ = model.decode_step(params, caches[0], toks[:, i], i)
            n1 = _launches()
            with dispatch.use_plain():
                plain, _ = model.decode_step(params, caches[1], toks[:, i], i)
            assert [b - a for a, b in zip(n0, n1)] == step
            assert _launches() == n1
            assert float((fast - plain).abs().max()) <= 1e-5 * float(
                plain.abs().max())


def test_ssd_chunked_matches_recurrence_on_the_card(dev):
    """mamba2's smoke model: the last position's logits of a 48-token
    ``forward_logits`` (three chunks) against ``decode_step`` fed the same
    tokens one at a time, within 1e-4 of their largest entry."""
    cfg, model, params = _ssm_smoke(dev, "mamba2-130m")
    toks = torch.randint(0, cfg.vocab_size, (2, 48),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev)
    with torch.no_grad():
        chunked = model.forward_logits(params, toks)[:, -1]
        cache = model.init_cache(2, 48, device=dev)
        for i in range(48):
            step, cache = model.decode_step(params, cache, toks[:, i], i)
    assert float((chunked - step).abs().max()) <= 1e-4 * float(
        step.abs().max())


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b",
                                  "qwen3-0.6b", "seamless-m4t-large-v2",
                                  "internvl2-2b"])
def test_generate_dense_on_the_card(dev, arch):
    """Greedy ``generate_dense`` through the kernels equals the same loop
    under ``dispatch.use_plain()`` (the smoke models' argmax margins are
    far above the kernels' f32 differences); qwen3 takes the prefill
    branch."""
    import numpy as np
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve
    cfg, _, params = _ssm_smoke(dev, arch)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 8))
    out = serve.generate_dense(cfg, params, prompts, 6, device=dev)
    with dispatch.use_plain():
        plain = serve.generate_dense(cfg, params, prompts, 6, device=dev)
    assert out.shape == (3, 6)
    np.testing.assert_array_equal(out, plain)


# Launches of the smoke models (2 layers; seamless 2 encoder layers): a
# forward of 2 x 24 tokens (seamless against 2 x 40 frames, internvl2 after
# 8 patches): kernel 1 runs the frontend projection or the projector's two
# products, 7 products an encoder or decoder-only layer, 11 a seamless
# decoder layer (self q, k, v, o; cross q, o and the memory's k, v; the
# MLP's three) and the unembed; kernel 2 once a self-attention and once a
# cross-attention.  A seamless decode step: 9 products a decoder layer (the
# memory's K/V come from the cross cache) + the unembed, kernel 2 once a
# layer (the cross-attention, one query row); internvl2's is lm's, 7L + 1.
@pytest.mark.parametrize("arch,forward,step", [
    ("seamless-m4t-large-v2", [1 + 7 * 2 + 11 * 2 + 1, 2 + 2 * 2, 0],
     [9 * 2 + 1, 2, 0]),
    ("internvl2-2b", [2 + 7 * 2 + 1, 2, 0], [7 * 2 + 1, 0, 0])])
def test_encdec_and_vlm_through_kernels_match_plain(dev, arch, forward,
                                                    step):
    """The smoke models' ``forward_logits`` and, from one cache state
    (seamless: after ``prefill_cross``, copied), three decode steps through
    the kernels against ``dispatch.use_plain()``: logits within 1e-5 of
    their largest entry, the launch counts above on the kernel side, none
    on the plain side."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.modules import tree_map
    cfg, model, params = _ssm_smoke(dev, arch)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=g, device=dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn(2, 40, cfg.frontend_dim, generator=g,
                                      device=dev)
    else:
        batch["patches"] = torch.randn(2, cfg.n_frontend_tokens,
                                       cfg.frontend_dim, generator=g,
                                       device=dev)
    with torch.no_grad():
        n0 = _launches()
        fast = model.forward_logits(params, batch)
        n1 = _launches()
        with dispatch.use_plain():
            plain = model.forward_logits(params, batch)
        assert _launches() == n1
        assert [b - a for a, b in zip(n0, n1)] == forward
        assert float((fast - plain).abs().max()) <= 1e-5 * float(
            plain.abs().max())
        kw = {"mem_len": 40} if cfg.family == "audio" else {}
        cache = model.init_cache(2, 4, device=dev, **kw)
        if cfg.family == "audio":
            n0 = _launches()
            model.module.prefill_cross(params, batch["frames"], cfg, cache)
            assert [b - a for a, b in zip(n0, _launches())] == [
                1 + 7 * 2 + 2 * 2, 2, 0]
        caches = [cache, tree_map(torch.clone, cache)]
        toks = batch["tokens"]
        for i in range(3):
            n0 = _launches()
            fast, _ = model.decode_step(params, caches[0], toks[:, i], i)
            n1 = _launches()
            with dispatch.use_plain():
                plain, _ = model.decode_step(params, caches[1], toks[:, i], i)
            assert [b - a for a, b in zip(n0, n1)] == step
            assert _launches() == n1
            assert float((fast - plain).abs().max()) <= 1e-5 * float(
                plain.abs().max())


# ------------------------------------------ the paper's numerics (x9, Fig. 11)

def test_x9_on_the_card_matches_x9_on_the_cpu(dev):
    """The compensated x9 policy runs its TwoSum loop in plain PyTorch on
    the card (no kernel, no launch): the same IEEE f32 operations in the
    same order as on the CPU, so the unevaluated pair is bitwise the CPU's;
    ``policy_mm`` gives its head."""
    from repro_torch.core import policy_mm
    from repro_torch.core.matgen import urand
    from repro_torch.core.policy import tcec_dot_unevaluated
    a = torch.from_numpy(urand((48, 200), seed=3))
    b = torch.from_numpy(urand((200, 40), seed=4))
    before = tcec_matmul.launches
    head, tail = tcec_dot_unevaluated(a.to(dev), b.to(dev), "tcec_bf16x9")
    cpu_head, cpu_tail = tcec_dot_unevaluated(a, b, "tcec_bf16x9")
    assert torch.equal(head.cpu(), cpu_head)
    assert torch.equal(tail.cpu(), cpu_tail)
    assert torch.equal(policy_mm(a.to(dev), b.to(dev), "tcec_bf16x9"), head)
    assert tcec_matmul.launches == before


def test_blocked_attention_gradients_match_mha_at_8192(dev):
    """``_FusedSDPA``'s recompute backward at S = T = 8192 (small heads)
    goes through ``blocked_attention`` once (its products on kernel 1) and
    gives the gradients of an ``mha`` backward on the same q, k, v under
    ``dispatch.use_plain()`` (1e-3 of each gradient's largest entry,
    chip_smoke.py phase 7b's tolerance)."""
    from types import SimpleNamespace
    from repro_torch.kernels import dispatch
    from repro_torch.models import layers
    g = torch.Generator(device=dev).manual_seed(8192)
    S, H, Hkv, hd = 8192, 4, 2, 32
    q, k, v = (torch.randn(1, S, h, hd, generator=g, device=dev)
               for h in (H, Hkv, Hkv))
    cot = torch.randn(1, S, H, hd, generator=g, device=dev)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    calls = []
    fn = layers.blocked_attention

    def counted(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    layers.blocked_attention = counted
    try:
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        layers._FusedSDPA.apply(*qkv, pos, pos, "tcec_bf16x6", None, True,
                                0).backward(cot)
    finally:
        layers.blocked_attention = fn
    assert len(calls) == 1
    cfg = SimpleNamespace(mix_policy="tcec_bf16x6", attn_softcap=None)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    before = tcec_matmul.launches
    with dispatch.use_plain():
        layers.mha(*ref, cfg, pos, pos, True, 0).backward(cot)
    assert tcec_matmul.launches == before
    for t, r in zip(qkv, ref):
        assert float((t.grad - r.grad).abs().max()) <= 1e-3 * float(
            r.grad.abs().max())


def test_kernel_1_within_theory_bound_on_fig11_type3(dev):
    """One Fig. 11 Type 3 product (exponents -35..-15) through kernel 1
    under x6: its Eq. (7) residual against f64 is within
    ``theory.policy_error_bound`` and at most twice f32 SGEMM's."""
    from repro_torch.core import theory
    from repro_torch.core.matgen import exp_rand
    a = torch.from_numpy(exp_rand((512, 1024), -35, -15, seed=4)).to(dev)
    b = torch.from_numpy(exp_rand((1024, 384), -35, -15, seed=5)).to(dev)
    before = tcec_matmul.launches
    out = ops.tcec_matmul(a, b, "tcec_bf16x6")
    assert tcec_matmul.launches == before + 1
    ref = a.double() @ b.double()

    def resid(c):
        return float(torch.linalg.norm(ref - c.double())
                     / torch.linalg.norm(ref))

    assert resid(out) <= theory.policy_error_bound("tcec_bf16x6", 1024,
                                                   e_lo=-35)
    assert resid(out) <= 2 * resid(a @ b)


# ------------------------------------------------ head_dim 256 (the gemmas)

# Kernel 2's instantiation for head dims padded to 256 (32 keys a tile, 16
# at x10, a block for each 128-wide half of the output columns) against its
# plain version: every policy, a window and a softcap, ragged S (100, 150
# are multiples of neither tile), one tile (S 20: the normalize-first
# branch), non-causal queries at the tail of longer keys, MQA at 8 query
# heads (gemma-2b), GQA 16/8 (gemma2-9b), and head dims between the two
# instantiations (hd 192 with hdv 128, hd 96 with hdv 200).  GQA ratios that
# do not divide the block's 64 rows leave padding rows (rep 5: qwen2.5-14b's
# 40/8 heads of 128; rep 3 at 256).
@pytest.mark.parametrize("policy,S,T,causal,window,softcap,heads", [
    ("tcec_bf16x3", 150, 150, True, 0, None, (8, 1, 256, 256)),
    ("tcec_bf16x6", 150, 150, True, 0, None, (8, 1, 256, 256)),
    ("tcec_bf16x10", 150, 150, True, 0, None, (8, 1, 256, 256)),
    ("tcec_bf16x6", 20, 20, True, 0, None, (8, 1, 256, 256)),
    ("tcec_bf16x10", 16, 16, True, 0, None, (8, 1, 256, 256)),
    ("tcec_bf16x6", 200, 200, True, 64, 50.0, (16, 8, 256, 256)),
    ("tcec_bf16x3", 100, 100, True, 40, 50.0, (16, 8, 256, 256)),
    ("tcec_bf16x10", 100, 100, True, 40, 50.0, (16, 8, 256, 256)),
    ("tcec_bf16x6", 70, 150, False, 0, None, (16, 8, 256, 256)),
    ("tcec_bf16x10", 1, 150, False, 0, None, (8, 1, 256, 256)),
    ("tcec_bf16x6", 150, 150, True, 0, None, (12, 4, 256, 256)),
    ("tcec_bf16x6", 150, 150, True, 0, None, (40, 8, 128, 128)),
    ("tcec_bf16x10", 100, 100, True, 30, None, (40, 8, 128, 128)),
    ("tcec_bf16x6", 150, 150, True, 0, None, (16, 8, 192, 128)),
    ("tcec_bf16x6", 100, 100, True, 0, None, (16, 8, 96, 200))])
def test_attention_head_dim_256_matches_plain(dev, policy, S, T, causal,
                                              window, softcap, heads):
    H, Hkv, hd, hdv = heads
    g = torch.Generator(device=dev).manual_seed(S + hd)
    q = torch.randn(2, S, H, hd, generator=g, device=dev)
    k = torch.randn(2, T, Hkv, hd, generator=g, device=dev)
    v = torch.randn(2, T, Hkv, hdv, generator=g, device=dev)
    q_pos = torch.arange(T - S, T, device=dev)
    kw = dict(policy=policy, causal=causal, window=window, softcap=softcap)
    before = tcec_attention.launches
    out = tcec_attention.tcec_attention(q, k, v, q_pos, **kw)
    assert tcec_attention.launches == before + 1
    again = tcec_attention.tcec_attention(q, k, v, q_pos, **kw)
    ref = tcec_attention.tcec_attention_plain(q, k, v, q_pos, **kw)
    assert out.shape == (2, S, H, hdv)
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= 1e-5 * float(v.abs().max())


def test_attention_refuses_head_dims_over_256(dev):
    q = torch.randn(1, 8, 2, 260, device=dev)
    k = torch.randn(1, 8, 1, 260, device=dev)
    before = tcec_attention.launches
    with pytest.raises(ValueError):
        tcec_attention.tcec_attention(q, k, k)
    with pytest.raises(ValueError):           # hdv over 256 alone
        tcec_attention.tcec_attention(q[..., :256], k[..., :256], k)
    with pytest.raises(ValueError):           # and no plain path either
        tcec_attention.tcec_attention_plain(q, k, k)
    assert tcec_attention.launches == before


# Kernel 3 at hd 256 against its plain version at the same C: gemma-2b's
# MQA (rep 8, one kv head) and gemma2-9b's 16/8 heads, every policy, a
# window that cuts across chunks and the softcap 50, C 1 and 2 (the rule's
# choices at pages of 16), maxp 1 (normalise first), and hd 256 with hdv
# 128.
@pytest.mark.parametrize("policy,ps,C,maxp,rep,hd,hdv,window,softcap", [
    ("tcec_bf16x6", 16, 2, 10, 8, 256, 256, 0, None),
    ("tcec_bf16x3", 16, 1, 10, 8, 256, 256, 0, None),
    ("tcec_bf16x10", 16, 2, 10, 8, 256, 256, 20, 50.0),
    ("tcec_bf16x6", 16, 2, 10, 2, 256, 256, 50, 50.0),
    ("tcec_bf16x10", 16, 1, 7, 2, 256, 256, 0, None),
    ("tcec_bf16x6", 16, 1, 1, 8, 256, 256, 0, None),
    ("tcec_bf16x6", 8, 3, 9, 4, 256, 128, 30, None)])
def test_paged_attention_head_dim_256_matches_plain(dev, policy, ps, C, maxp,
                                                    rep, hd, hdv, window,
                                                    softcap):
    n = C * ps
    lengths = sorted({0, 1, ps, n - 1, n, n + 1, maxp * ps})
    lengths = [min(x, maxp * ps) for x in lengths]
    q, kp, vp, bt, ln = _paged_inputs(dev, lengths, 2, rep, hd, hdv, ps, maxp,
                                      seed=hd + C + maxp + window)
    kw = dict(policy=policy, window=window, softcap=softcap,
              pages_per_chunk=C)
    before = tcec_paged_attention.launches
    out = tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, ln, **kw)
    assert tcec_paged_attention.launches == before + 1
    again = tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, ln, **kw)
    ref = tcec_paged_attention.tcec_paged_attention_plain(q, kp, vp, bt, ln,
                                                          **kw)
    assert torch.equal(out, again)
    assert bool((out[ln <= 0] == 0).all())
    assert float((out - ref).abs().max()) <= 1e-5 * float(
        vp.float().abs().max())


def test_paged_attention_refuses_head_dims_over_256(dev):
    q, kp, vp, bt, ln = _paged_inputs(dev, [5], 1, 2, 264, 264, 16, 2, seed=0)
    before = tcec_paged_attention.launches
    with pytest.raises(ValueError):
        tcec_paged_attention.tcec_paged_attention(q, kp, vp, bt, ln)
    assert tcec_paged_attention.launches == before


def test_init_peak_is_weights_and_one_layer(dev):
    """``stack_init`` fills each leaf's stack layer by layer: the peak of a
    4-layer qwen2.5-14b at full width stays within its weights + one layer
    + its largest leaf (stacking a list of trees would hold the stacks
    twice)."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.modules import tree_leaves
    cfg = get_config("qwen2.5-14b").replace(n_layers=4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = get_model(cfg).init(seed=0, device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    weights = sum(t.nbytes for t in tree_leaves(params))
    layer = [t[0] for t in tree_leaves(params["dense_blocks"])]
    # the largest leaf: the embedding or unembedding, or one layer's slice
    # of a stacked leaf
    largest = max(t.nbytes for t in layer + [params["embed"],
                                            params["unembed"]])
    assert weights <= peak <= weights + sum(t.nbytes for t in layer) + largest
    del params
    torch.cuda.empty_cache()


# ------------------------------------------------------------ the tuner

def test_tuner_measures_outside_the_launch_counts(dev, tmp_path):
    """A miss under "force" times both paths of kernel 1 on the call's own
    operands (4 launches each, counted in ``tuning.measure_launches``, not
    in ``launches``), persists the winner, and the call runs on it; the next
    call of the bucket measures nothing."""
    from repro_torch.core.policy import policy_mm
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(48, 1024, generator=g, device=dev)
    b = torch.randn(1024, 3072, generator=g, device=dev)
    cache = tmp_path / "t.json"
    with numerics.use(tune="force", tune_cache=str(cache)):
        before = tcec_matmul.launches, tuning.measure_launches
        out = policy_mm(a, b, "tcec_bf16x6")
        assert tcec_matmul.launches == before[0] + 1
        assert tuning.measure_launches == before[1] + 2 * (1 + tuning.REPS)
        policy_mm(a[:40], b, "tcec_bf16x6")          # the same bucket
        assert tuning.measure_launches == before[1] + 2 * (1 + tuning.REPS)
    import json
    [(key, entry)] = json.loads(cache.read_text())["entries"].items()
    assert key == "cuda/tcec_bf16x6/b1_m64_n3072_k1024"
    assert entry["source"] == "measured"
    assert torch.equal(out, ops.tcec_matmul(a, b, "tcec_bf16x6",
                                            block=entry["block"]))
    # "off" is the rule by M, bit for bit, whatever the file holds
    with numerics.use(tune="off", tune_cache=str(cache)):
        assert torch.equal(policy_mm(a, b, "tcec_bf16x6"),
                           ops.tcec_matmul(a, b, "tcec_bf16x6"))


def test_tuner_never_measures_during_capture(dev, tmp_path):
    """A miss while a CUDA graph is captured takes the rule by M, is not
    persisted, and is counted; the replay equals the eager launch on that
    path."""
    from repro_torch.core.policy import policy_mm
    g = torch.Generator(device=dev).manual_seed(6)
    a = torch.randn(24, 512, generator=g, device=dev)
    b = torch.randn(512, 1536, generator=g, device=dev)
    cache = tmp_path / "t.json"
    with numerics.use(tune="force", tune_cache=str(cache)):
        policy_mm(a[:1], b[:, :8], "tcec_bf16x6")    # build, warm up
        torch.cuda.synchronize()
        before = tuning.measure_launches, tuning.capture_misses
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = policy_mm(a, b, "tcec_bf16x6")
        graph.replay()
        torch.cuda.synchronize()
    assert tuning.measure_launches == before[0]
    assert tuning.capture_misses == before[1] + 1
    assert "m32_n1536_k512" not in (cache.read_text() if cache.exists()
                                    else "")
    assert torch.equal(out, ops.tcec_matmul(a, b, "tcec_bf16x6"))


def test_paged_tuner_measures_outside_the_launch_counts(dev, tmp_path):
    cfg = numerics.active().replace(tune="force",
                                    tune_cache=str(tmp_path / "t.json"))
    before = tcec_paged_attention.launches, tuning.measure_launches
    c, meta = tuning.autotune_paged(4, 2, 2, 66, 4, 16, 16, "tcec_bf16x6",
                                    cfg=cfg, device=dev)
    cands = tuning.paged_candidate_blocks(66, 4, 2, 16, 16, "tcec_bf16x6")
    assert meta["source"] == "measured" and c in cands
    assert tcec_paged_attention.launches == before[0]
    assert tuning.measure_launches == before[1] + len(cands) * (
        1 + tuning.REPS)


def test_engine_pin_holds_while_the_ambient_config_changes(dev):
    """The smoke engine pinned to ``fuse_epilogue``: its prefills keep the
    gate's silu in kernel 1's epilogue (L a forward) while an ambient
    ``use(enabled=False)`` is entered mid-serve, and its replays keep
    counting L; every request finishes."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, SamplingParams
    cfg = get_smoke_config("qwen3-0.6b")
    params = get_model(cfg).init(seed=0, device=dev)
    L = cfg.n_layers
    eng = Engine(cfg, params, max_slots=2, num_pages=33, page_size=4,
                 device=dev, numerics_config=numerics.NumericsConfig(
                     fuse_epilogue=True))
    eng.add_request(list(range(1, 8)), SamplingParams(max_tokens=6))
    eng.step()                           # prefill, warm-up, capture, replay
    with numerics.use(enabled=False):
        eng.add_request(list(range(3, 9)), SamplingParams(max_tokens=4))
        before = (tcec_matmul.launches,
                  tcec_matmul.epilogue_launches["silu"])
        eng.step()                       # a prefill and one replay
        assert (tcec_matmul.launches - before[0],
                tcec_matmul.epilogue_launches["silu"] - before[1]) == (
            2 * (7 * L + 1), 2 * L)
        out = eng.run()
    assert all(v.finish_reason == "length" for v in out.values())
