"""The port's autotuner (``repro_torch.kernels.tuning``) on the CPU, with an
injected ``measure``: the JAX package's tuner tests (``test_dispatch.py``'s
cache roundtrip, reuse from a fresh cache and from another process, the
heuristic not persisted, the candidates within the budget;
``test_numerics.py``'s explicit config, tune modes, per-path caches), and
the port's own rules: kernel 1's two tiles read from the CUDA source, the M
buckets of decode and of a 2 x 32 prefill apart, ``tune="off"`` reading no
cache, a corrupt or old-version file read as a miss, kernel 3's
candidates within the C entry's shared-memory rule.  Measurement on the
card, and none while a graph is captured, are card tests
(``tests/test_torch_cuda.py``).
"""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch import numerics  # noqa: E402
from repro_torch.kernels import (dispatch, ops, tcec_matmul,  # noqa: E402
                                 tcec_paged_attention, tuning)

ROOT = Path(__file__).resolve().parents[1]
S_TILE, W_TILE = (8, 16, 128), (128, 64, 64)


@pytest.fixture(autouse=True)
def _auto():
    """JAX's default tune mode, which its tuner tests assume (the port's
    default is "off": ``repro_torch/numerics.py``)."""
    with numerics.use(tune="auto"):
        yield


def _prefer(tile):
    calls = []

    def measure(block):
        calls.append(tuple(block))
        return 1.0 if tuple(block) == tile else 2.0
    return measure, calls


def test_tiles_and_threshold_read_from_the_source():
    src = (ROOT / "src/repro_torch/csrc/tcec_matmul.cu").read_text()
    assert "constexpr int SKINNY_MAX_M = 64;" in src
    assert "constexpr int BM = 128, BN = 64, BK = 64;" in src
    assert tcec_matmul.skinny_max() == 64
    assert tcec_matmul.tiles() == {"skinny": S_TILE, "wgmma": W_TILE}
    assert tcec_matmul.block_path(S_TILE) == 0
    assert tcec_matmul.block_path(list(W_TILE)) == 1
    with pytest.raises(ValueError, match="two tiles"):
        tcec_matmul.block_path((128, 128, 128))
    a, b = torch.rand(8, 16), torch.rand(16, 8)
    with pytest.raises(ValueError, match="two tiles"):
        ops.tcec_matmul(a, b, block=(128, 128, 128))
    assert torch.equal(ops.tcec_matmul(a, b, block=S_TILE),
                       ops.tcec_matmul(a, b))


@pytest.mark.parametrize("M", [1, 4, 17, 63, 64, 65, 130, 1024])
def test_heuristic_is_the_rule_by_m(M):
    assert tuning.heuristic_block(M, 3072, 1024, "tcec_bf16x6") == \
        tcec_matmul.tiles()[tcec_matmul.path(M)]
    cands = tuning.candidate_blocks(M, 3072, 1024, "tcec_bf16x6")
    assert cands[0] == tuning.heuristic_block(M, 3072, 1024, "tcec_bf16x6")
    assert set(cands) <= set(tcec_matmul.tiles().values())
    assert (S_TILE in cands) == (M <= tuning.SKINNY_CANDIDATE_MAX)
    assert W_TILE in cands


def test_buckets_separate_what_the_paths_separate():
    key = lambda M: tuning.cache_key(1, M, 3072, 1024, "tcec_bf16x6",
                                     "cuda")
    assert key(4) != key(64)          # decode (4 slots) vs a 2 x 32 prefill
    assert key(64) != key(65)         # the rule's threshold
    assert key(33) == key(64) and key(65) == key(128)
    assert tuning.shape_bucket(2, 4, 3000, 1000) == (2, 4, 3072, 1024)
    assert tuning.shape_bucket(1, 1, 1, 1) == (1, 1, 128, 128)
    for M in range(1, 300):           # a bucket never straddles the rule
        lo = tuning.shape_bucket(1, M, 1, 1)[1] // 2 + 1
        assert tcec_matmul.path(lo) == tcec_matmul.path(M)


def test_autotune_cache_roundtrip(tmp_path):
    measure, calls = _prefer(W_TILE)     # path W where the rule says S
    path = str(tmp_path / "tune.json")
    cache = tuning.BlockCache(path=path)
    blk1, meta1 = tuning.autotune(1, 32, 512, 512, "tcec_bf16x6",
                                  measure=measure, cache=cache)
    assert meta1["source"] == "measured" and blk1 == W_TILE
    assert sorted(calls) == sorted([S_TILE, W_TILE])
    assert meta1["timings"] == {str(list(W_TILE)): 1.0,
                                str(list(S_TILE)): 2.0}
    blk2, meta2 = tuning.autotune(1, 32, 512, 512, "tcec_bf16x6",
                                  measure=measure, cache=cache)
    assert blk2 == blk1 and meta2["source"] == "cache" and len(calls) == 2
    # 17 rows, N 500 and K 400 lie in the bucket of 32 x 512 x 512
    blk3, meta3 = tuning.autotune(1, 17, 500, 400, "tcec_bf16x6",
                                  measure=measure, cache=cache)
    assert blk3 == blk1 and meta3["source"] == "cache"
    cache2 = tuning.BlockCache(path=path)
    blk4, meta4 = tuning.autotune(1, 32, 512, 512, "tcec_bf16x6",
                                  measure=measure, cache=cache2)
    assert blk4 == blk1 and meta4["source"] == "cache" and len(calls) == 2
    data = json.loads(Path(path).read_text())
    assert data["version"] == tuning.CACHE_VERSION
    [(key, entry)] = data["entries"].items()
    assert key == "cpu/tcec_bf16x6/b1_m32_n512_k512"
    assert entry == {"block": list(W_TILE), "ms": 1.0, "source": "measured"}


def test_a_near_tie_keeps_the_heuristic(tmp_path):
    """A candidate replaces the rule by M only when it is faster by more
    than ``MARGIN``: a 5 % win keeps the heuristic, a 20 % win takes it."""
    cache = tuning.BlockCache(path=str(tmp_path / "tune.json"))
    for M, rule, other in ((4, S_TILE, W_TILE), (200, W_TILE, S_TILE)):
        for gain, want in ((0.05, rule), (0.2, other)):
            blk, meta = tuning.autotune(
                1, M, 512, 512 + int(gain * 1000), "tcec_bf16x6",
                cache=cache, measure=lambda b, r=rule, g=gain:
                1.0 if b == r else 1.0 - g)
            assert meta["source"] == "measured" and blk == want, (M, gain)
    c, _ = tuning.autotune_paged(4, 8, 2, 40, 16, 128, 128, "tcec_bf16x6",
                                 cache=cache,
                                 measure=lambda g: 0.95 if g == 8 else 1.0)
    assert c == 4                 # chunk_pages's C: 8 won by only 5 %


def test_autotune_reuse_across_processes(tmp_path):
    path = str(tmp_path / "tune.json")
    blk, _ = tuning.autotune(1, 200, 256, 256, "tcec_bf16x3",
                             measure=_prefer(S_TILE)[0],
                             cache=tuning.BlockCache(path=path))
    assert blk == S_TILE
    code = (
        "import sys\n"
        "sys.path.insert(0, 'src')\n"
        "from repro_torch import numerics\n"
        "from repro_torch.kernels import tuning\n"
        f"cache = tuning.BlockCache(path={path!r})\n"
        "def measure(b):\n"
        "    raise AssertionError('remeasured')\n"
        "blk, meta = tuning.autotune(1, 200, 256, 256, 'tcec_bf16x3',\n"
        "    measure=measure, cache=cache,\n"
        "    cfg=numerics.active().replace(tune='auto'))\n"
        "print('SOURCE', meta['source'], tuple(blk))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(ROOT), timeout=300)
    assert f"SOURCE cache {S_TILE}" in r.stdout, (r.stdout, r.stderr)


def test_heuristic_fallback_not_persisted_nor_kept(tmp_path):
    path = tmp_path / "tune.json"
    cache = tuning.BlockCache(path=str(path))
    with numerics.use(tune="off"):
        blk, meta = tuning.autotune(1, 1024, 1024, 1024, "tcec_bf16x6",
                                    cache=cache)
    assert meta["source"] == "heuristic" and blk == W_TILE
    assert not path.exists()
    # auto on the CPU does not measure; the answer is not kept in memory
    auto = numerics.active().replace(tune="auto")
    blk, meta = tuning.autotune(1, 4, 1024, 1024, "tcec_bf16x6", cache=cache,
                                cfg=auto)
    assert meta["source"] == "heuristic" and blk == S_TILE
    assert not cache._mem and not path.exists()


def test_tune_off_reads_no_cache(tmp_path):
    """A divergence from JAX, whose "off" still reads the cache: the port's
    "off" is the rule by M, bit for bit, whatever the file holds."""
    cache = tuning.BlockCache(path=str(tmp_path / "tune.json"))
    blk, _ = tuning.autotune(1, 4, 1024, 1024, "tcec_bf16x6",
                             measure=_prefer(W_TILE)[0], cache=cache)
    assert blk == W_TILE
    off = numerics.active().replace(tune="off")
    blk, meta = tuning.autotune(1, 4, 1024, 1024, "tcec_bf16x6", cache=cache,
                                cfg=off)
    assert blk == S_TILE and meta["source"] == "heuristic"
    auto = numerics.active().replace(tune="auto")
    blk, meta = tuning.autotune(1, 4, 1024, 1024, "tcec_bf16x6", cache=cache,
                                cfg=auto)
    assert blk == W_TILE and meta["source"] == "cache"


@pytest.mark.parametrize("content", [
    "{not json", json.dumps({"version": 0, "entries": {
        "cpu/tcec_bf16x6/b1_m4_n1024_k1024": {"block": [128, 64, 64],
                                              "ms": 1.0}}}),
    json.dumps({"version": 1, "entries": {
        "cpu/tcec_bf16x6/b1_m4_n1024_k1024": {"block": "corrupt"}}}),
    json.dumps({"version": 1, "entries": {
        "cpu/tcec_bf16x6/b1_m4_n1024_k1024": {"block": [8, -16, 128],
                                              "ms": 1.0}}}),
    json.dumps([1, 2]),
])
def test_corrupt_or_old_file_reads_as_a_miss(tmp_path, content):
    path = tmp_path / "tune.json"
    path.write_text(content)
    measure, calls = _prefer(S_TILE)
    blk, meta = tuning.autotune(1, 4, 1024, 1024, "tcec_bf16x6",
                                measure=measure,
                                cache=tuning.BlockCache(path=str(path)))
    assert meta["source"] == "measured" and blk == S_TILE and len(calls) == 2
    assert json.loads(path.read_text())["version"] == tuning.CACHE_VERSION


def test_valid_entry():
    assert tuning.valid_entry({"block": [8, 16, 128], "ms": 0.5})
    assert tuning.valid_entry({"block": [4], "ms": None})
    for bad in (None, [], {"block": [1, 2, 3, 4]}, {"block": [1.0]},
                {"block": [1], "ms": "x"}, {"block": [True]}):
        assert not tuning.valid_entry(bad)


def test_explicit_cfg_governs_tuning(tmp_path):
    ambient_cache = str(tmp_path / "ambient.json")
    cfg_cache = str(tmp_path / "explicit.json")
    cfg = numerics.active().replace(tune="off", tune_cache=cfg_cache)
    with numerics.use(tune="force", tune_cache=ambient_cache):
        assert not tuning._should_measure(cfg)
        assert tuning.cache_path(cfg) == cfg_cache
        assert tuning.get_cache(cfg).path == cfg_cache
        _, meta = tuning.autotune(1, 256, 256, 256, "tcec_bf16x6", cfg=cfg)
        assert meta["source"] == "heuristic"
    assert not Path(ambient_cache).exists()


def test_tuning_honors_tune_mode():
    with numerics.use(tune="off"):
        assert not tuning._should_measure(device="cuda")
    with numerics.use(tune="force"):
        assert tuning._should_measure(device="cpu")
    with numerics.use(tune="auto"):
        assert tuning._should_measure(device="cuda")
        assert not tuning._should_measure(device="cpu")


def test_force_on_the_cpu_times_the_plain_version(tmp_path):
    path = tmp_path / "tune.json"
    with numerics.use(tune="force", tune_cache=str(path)):
        blk, meta = tuning.autotune(1, 8, 64, 64, "tcec_bf16x6")
    assert meta["source"] == "measured" and blk in (S_TILE, W_TILE)
    assert set(meta["timings"]) == {str(list(S_TILE)), str(list(W_TILE))}
    assert "cpu/tcec_bf16x6/b1_m8_n128_k128" in json.loads(
        path.read_text())["entries"]
    assert tuning.measure_launches == 0     # the CPU launches no kernel


def test_tune_cache_path_scoped_by_context(tmp_path):
    p = str(tmp_path / "ctx_tune.json")
    with numerics.use(tune_cache=p):
        assert tuning.cache_path() == p
        assert tuning.get_cache().path == p
    assert tuning.cache_path() == numerics.ENV_VARS["REPRO_TUNE_CACHE"] \
        .default


def test_get_cache_is_per_path(tmp_path):
    c1 = numerics.active().replace(tune_cache=str(tmp_path / "a.json"))
    c2 = numerics.active().replace(tune_cache=str(tmp_path / "b.json"))
    a1, a2 = tuning.get_cache(c1), tuning.get_cache(c2)
    assert a1 is not a2
    assert tuning.get_cache(c1) is a1 and tuning.get_cache(c2) is a2


def test_config_block_overrides_the_tuner():
    with numerics.use(block=(8, 16, 128)):
        assert dispatch.tuned_block(1024, 1024, 1024, "tcec_bf16x6") == \
            S_TILE
    assert dispatch.tuned_block(1024, 1024, 1024, "tcec_bf16x6") == W_TILE


# ---------------------------------------------------- kernels 2 and 3

def test_attention_has_one_tile_a_head_dim(tmp_path):
    for policy, hd, tile in [("tcec_bf16x6", 128, (64, 64)),
                             ("tcec_bf16x10", 128, (64, 32)),
                             ("tcec_bf16x6", 256, (64, 32)),
                             ("tcec_bf16x10", 192, (64, 16))]:
        assert tuning.attn_candidate_blocks(512, 512, 2, hd, hd, policy) == \
            [tile]
        assert tuning.get_attention_block(2, 8, 2, 512, 512, hd, hd,
                                          policy) == tile
    measure, calls = _prefer((64, 64))
    cache = tuning.BlockCache(path=str(tmp_path / "t.json"))
    blk, meta = tuning.autotune_attention(2, 8, 2, 512, 512, 128, 128,
                                          "tcec_bf16x6", measure=measure,
                                          cache=cache)
    assert blk == (64, 64) and meta["source"] == "measured"
    assert calls == [(64, 64)]
    q, k = torch.rand(1, 16, 4, 32), torch.rand(1, 16, 2, 32)
    with numerics.use(attn_block=(64, 64)):
        dispatch.attention(q, k, k, policy="tcec_bf16x6")
    with numerics.use(attn_block=(128, 128)), \
            pytest.raises(ValueError, match="one tile"):
        dispatch.attention(q, k, k, policy="tcec_bf16x6")


def test_paged_candidates_within_the_entry_rule(tmp_path):
    src = (ROOT / "src/repro_torch/csrc/tcec_paged_attention.cu").read_text()
    smem = int(re.search(r"constexpr int SMEM_MAX = (\d+);", src).group(1))
    assert smem == tcec_paged_attention.SMEM_MAX
    # qwen3's decode: 8 kv heads of 2, hd 128, 40 pages of 16
    cands = tuning.paged_candidate_blocks(40, 16, 2, 128, 128, "tcec_bf16x6")
    assert cands == [16, 8, 4, 2, 1]
    assert tcec_paged_attention.smem_bytes(32, 16, 2, 128, 128, 3) > smem
    for maxp, rep, hd, pol in [(40, 2, 128, "tcec_bf16x6"),
                               (320, 2, 256, "tcec_bf16x10"),
                               (3, 8, 256, "tcec_bf16x6"),
                               (64, 8, 64, "tcec_bf16x3")]:
        ns = tcec_matmul.get_policy(pol).n_splits
        for c in tuning.paged_candidate_blocks(maxp, 16, rep, hd, hd, pol):
            assert c <= maxp
            assert tcec_paged_attention.takes_chunk(c, maxp, 16, rep, hd,
                                                    hd, ns)
    assert tuning.paged_heuristic_block(4, 8, 40, 16, 128, 128) == \
        tcec_paged_attention.chunk_pages(4, 8, 40, 16, 128, 128) == 4
    measure, calls = _prefer((2,))
    cache = tuning.BlockCache(path=str(tmp_path / "t.json"))
    c, meta = tuning.autotune_paged(4, 8, 2, 40, 16, 128, 128, "tcec_bf16x6",
                                    measure=lambda g: 1.0 if g == 2 else 2.0,
                                    cache=cache)
    assert c == 2 and meta["source"] == "measured"
    c, meta = tuning.autotune_paged(4, 8, 2, 40, 16, 128, 128, "tcec_bf16x6",
                                    cache=cache,
                                    cfg=numerics.active().replace(tune="auto"))
    assert c == 2 and meta["source"] == "cache"
    off = numerics.active().replace(tune="off")
    assert tuning.get_paged_block(4, 8, 2, 40, 16, 128, 128, "tcec_bf16x6",
                                  cfg=off) == 4
    key = tuning.paged_cache_key(4, 8, 2, 40, 16, 128, 128, "tcec_bf16x6",
                                 "cpu")
    assert key in json.loads((tmp_path / "t.json").read_text())["entries"]


def test_dispatch_calls_the_tuner_only_where_the_kernel_launches(
        monkeypatch):
    calls = []
    monkeypatch.setattr(tuning, "get_block",
                        lambda *a, **k: calls.append(a) or W_TILE)
    from repro_torch.core.policy import policy_mm
    policy_mm(torch.rand(8, 16), torch.rand(16, 8), "tcec_bf16x6")
    assert calls == []            # a CPU operand runs the plain version
