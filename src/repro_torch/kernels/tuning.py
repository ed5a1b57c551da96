"""Measured tile choice for the port's kernels: the counterpart of the JAX
package's ``repro/kernels/tuning.py``, with the H100's candidates in place
of the TPU's ``VMEM_BUDGET``.

* Kernel 1 (``tcec_matmul``) has two compiled tiles, each a path
  (``tcec_matmul.tiles()``): path W ``(128, 64, 64)`` and path S ``(8, 16,
  128)``.  The tuner measures both for a product's shape bucket and keeps
  the faster; its heuristic is the rule by M (path S up to
  ``tcec_matmul.skinny_max()``), which is what a launch without a tile
  takes.  Path S is a candidate up to M :data:`SKINNY_CANDIDATE_MAX`: it
  reads its weight band once for each 8 rows, so above 512 rows (64 passes
  over the weight) one of its launches at the unembedding's K takes
  seconds.
* Kernel 2 (``tcec_attention``) has one tile for each instantiation (64
  query rows by ``tcec_attention.key_tile`` keys), so there is nothing to
  measure: :func:`get_attention_block` returns it, and an injected
  ``measure`` runs the protocol as in JAX.
* Kernel 3 (``tcec_paged_attention``) takes C, its pages per chunk:
  candidates C in (1, 2, 4, 8, 16, 32) up to the block table's width, and
  only those the C entry accepts (``tcec_paged_attention.takes_chunk``, its
  shared-memory rule); the heuristic is ``chunk_pages``.

Winners persist to a JSON file with JAX's schema (``{"version": 1,
"entries": {key: {"block", "ms", "source"}}}``) behind an in-memory LRU,
keyed by ``(device type, policy, shape bucket)``.  The file is
``NumericsConfig.tune_cache``; ``tune`` is "auto" (measure where the
operands lie on the card), "force" (also on the CPU, where the plain
version is timed) or "off" (the port's default: ``numerics.py`` says
why).

Divergences from JAX, pinned by ``tests/test_torch_tuning.py``:

* :func:`shape_bucket` rounds M up to a power of two, not to 128, so that
  the buckets separate what the paths separate (decode's M 4 and a 2 x 32
  prefill's M 64 apart); N and K go to multiples of 128.
* ``tune="off"`` reads no cache: it is the hand rules, bit for bit.
* A heuristic answer is not kept, in memory or on disk: a later call that
  may measure, measures.
* Nothing is measured while the current stream captures a CUDA graph
  (a synchronize would break the capture): such a miss takes the
  heuristic, is not persisted, and is counted in :data:`capture_misses`.
  The engine's eager warm-up step, which has the capture's shapes, fills
  the cache first.
* Measurements launch the kernels through their uncounted ``enqueue``
  entries: :data:`measure_launches` counts them, and the kernels'
  ``launches`` stay the main path's.  Kernel 1 is timed on the call's own
  operands, into one scratch output freed before the call's own, so a
  measurement adds no weight copy and no peak; kernel 3 on inputs of its
  shape (full lengths), as JAX's tuner does.
* A candidate is timed on the device alone (its launches queued behind a
  sleeping kernel: the host's launch cost, the same for every candidate
  and tens of microseconds, would otherwise decide between small
  products), and replaces the heuristic only when it is faster by more
  than :data:`MARGIN`, so that where two paths take the same time the
  choice does not follow the timing noise from run to run.  (On the H100,
  CUDA events around single launches read 0.02-0.04 ms for smoke-sized
  products on either path: the host's launch cost, not the kernel's.)
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict

import torch

from repro_torch import faults, numerics
from repro_torch.core.policy import get_policy
from . import tcec_attention as _ta
from . import tcec_matmul as _tm
from . import tcec_paged_attention as _tp

CACHE_VERSION = 1
SKINNY_CANDIDATE_MAX = 512
PAGED_CANDIDATE_STEPS = (1, 2, 4, 8, 16, 32)
REPS = 5
MARGIN = 0.1            # a candidate beats the heuristic by more than 10 %
SLEEP_CYCLES = 5_000_000   # ~2.5 ms: outlasts the host's enqueue of REPS

# the process's measurements: launches, capture-time misses, and the
# timings (ms) of every candidate, by (cache file, key)
measure_launches = 0
capture_misses = 0
measured: dict[tuple[str, str], dict[str, float]] = {}


def cache_path(cfg=None) -> str:
    return (cfg or numerics.active()).tune_cache


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


def _pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def shape_bucket(B: int, M: int, N: int, K: int) -> tuple[int, int, int, int]:
    """``(batch, M to the next power of two, N and K to multiples of
    128)``: two products in one bucket take one tile."""
    return (max(1, B), _pow2(M), _round_up(N, 128), _round_up(K, 128))


def heuristic_block(M: int, N: int, K: int,
                    policy_name: str) -> tuple[int, int, int]:
    """The rule by M: path S's tile up to ``skinny_max()``, else path W's
    (what a launch without a tile takes)."""
    return _tm.tiles()[_tm.path(M)]


def candidate_blocks(M: int, N: int, K: int,
                     policy_name: str) -> list[tuple[int, int, int]]:
    """The tiles the tuner measures for M's bucket, the heuristic's first:
    path W always, path S up to :data:`SKINNY_CANDIDATE_MAX` rows."""
    t = _tm.tiles()
    out = [t["wgmma"]]
    if _pow2(M) <= SKINNY_CANDIDATE_MAX:
        out.append(t["skinny"])
    first = heuristic_block(M, N, K, policy_name)
    return sorted(out, key=lambda b: b != first)


def valid_entry(entry) -> bool:
    """Schema check for one cache entry: ``{"block": [1-3 positive ints],
    "ms": None | number, ...}``.  A corrupt or stale entry reads as a
    miss."""
    if not isinstance(entry, dict):
        return False
    block = entry.get("block")
    if not isinstance(block, (list, tuple)) or not 1 <= len(block) <= 3:
        return False
    if not all(type(v) is int and v > 0 for v in block):
        return False
    ms = entry.get("ms")
    return ms is None or isinstance(ms, (int, float))


class BlockCache:
    """On-disk JSON cache of measured tiles with an in-memory LRU in front.
    Entries failing :func:`valid_entry` read as misses."""

    def __init__(self, path: str | None = None, capacity: int = 256):
        self.path = path or cache_path()
        self.capacity = capacity
        self._mem: OrderedDict[str, dict] = OrderedDict()
        self._disk: dict[str, dict] | None = None   # loaded lazily
        self._dirty: set[str] = set()               # keys THIS process wrote

    def _read_file(self) -> dict[str, dict]:
        try:
            with open(self.path) as f:
                data = json.load(f)
            if data.get("version") == CACHE_VERSION:
                return dict(data.get("entries", {}))
        except (OSError, ValueError, AttributeError):
            pass   # absent or corrupt file == empty cache
        return {}

    def _load_disk(self) -> dict[str, dict]:
        if self._disk is None:
            self._disk = self._read_file()
        return self._disk

    def _flush(self):
        # merge-on-write: re-read the file and overlay only the keys this
        # process measured (last writer wins per key, not per file)
        ours = self._load_disk()
        fresh = self._read_file()
        for key in self._dirty:
            if key in ours:
                fresh[key] = ours[key]
        fresh.update({k: v for k, v in ours.items() if k not in fresh})
        self._disk = fresh
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": fresh}, f, indent=1)
        os.replace(tmp, self.path)   # atomic: readers see the old or new

    def get(self, key: str) -> dict | None:
        if key in self._mem:
            self._mem.move_to_end(key)
            entry = self._mem[key]
        else:
            entry = self._load_disk().get(key)
        if entry is not None:
            if faults.poke("tuning.cache") is not None:
                entry = {"block": "corrupt"}   # injected corruption
            if not valid_entry(entry):
                # a corrupt entry is a miss: dropped from both views, so
                # the tuner re-derives (and re-persists) it
                self._mem.pop(key, None)
                self._load_disk().pop(key, None)
                return None
            if key not in self._mem:
                self._put_mem(key, entry)
        return entry

    def _put_mem(self, key: str, entry: dict):
        self._mem[key] = entry
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)

    def put(self, key: str, entry: dict, persist: bool):
        self._put_mem(key, entry)
        if persist:
            self._load_disk()[key] = entry
            self._dirty.add(key)
            self._flush()


_caches: dict[str, BlockCache] = {}


def get_cache(cfg=None) -> BlockCache:
    """One shared BlockCache per path."""
    path = cache_path(cfg)
    cache = _caches.get(path)
    if cache is None:
        cache = _caches[path] = BlockCache(path=path)
    return cache


def _ns(backend: str, namespace: str | None) -> str:
    return backend if namespace is None else f"{backend}/{namespace}"


def cache_key(B: int, M: int, N: int, K: int, policy_name: str,
              backend: str, namespace: str | None = None) -> str:
    b, m, n, k = shape_bucket(B, M, N, K)
    return f"{_ns(backend, namespace)}/{policy_name}/b{b}_m{m}_n{n}_k{k}"


# ------------------------------------------------------------- measurement

def _device(device) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _should_measure(cfg=None, device=None) -> bool:
    """Whether a miss is measured: never under "off", always under
    "force", under "auto" where the operands lie on the card."""
    mode = (cfg or numerics.active()).tune
    if mode == "off":
        return False
    if mode == "force":
        return True
    return _device(device).type == "cuda"


def _capturing(device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _time_ms(fn, device, reps: int = REPS) -> float:
    """``fn``'s time after one warm-up: on the card the mean of ``reps``
    runs on the device alone (CUDA events around launches queued behind a
    sleeping kernel), on the CPU the best of ``reps`` on the host clock."""
    global measure_launches
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        measure_launches += 1 + reps
        return start.elapsed_time(end) / reps
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _matmul_measure(a, b, policy_name: str, reps: int):
    """``block -> ms`` of kernel 1 on the operands ``a``, ``b`` (a CUDA
    launch on the tile's path into one scratch output; on the CPU the plain
    version, which has no tiles)."""
    out = []

    def measure(block):
        if not a.is_cuda:
            return _time_ms(lambda: _tm.tcec_matmul_plain(a, b, policy_name),
                            a.device, reps)
        if not out:
            out.append(a.new_empty((*a.shape[:-1], b.shape[-1])))
        p = _tm.block_path(block)
        return _time_ms(lambda: _tm.enqueue(a, b, policy_name, path=p,
                                            out=out[0]), a.device, reps)
    return measure


def _autotune_protocol(key: str, heuristic, candidates, measure,
                       cache: BlockCache, max_candidates: int | None,
                       read_cache: bool = True) -> tuple[tuple, dict]:
    """The cache/measure/persist protocol behind every tuner: a cache hit;
    else the heuristic when ``measure()`` (a thunk, called on a miss only)
    gives None (neither kept nor persisted); else a sweep of the
    candidates with the ``block -> ms`` it gives, whose winner (the
    heuristic's block unless another beats it by more than
    :data:`MARGIN`) is persisted.  ``read_cache`` False (``tune="off"``)
    skips the cache."""
    if read_cache:
        hit = cache.get(key)
        if hit is not None:
            return tuple(hit["block"]), {**hit, "source": "cache"}
    measure = measure()
    if measure is None:
        block = tuple(heuristic())
        return block, {"block": list(block), "ms": None,
                       "source": "heuristic"}
    cands = candidates()
    if max_candidates:
        cands = cands[:max_candidates]
    timings = {tuple(blk): measure(blk) for blk in cands}
    block = min(timings, key=timings.get)
    first = tuple(heuristic())
    if first in timings and timings[block] > (1 - MARGIN) * timings[first]:
        block = first
    entry = {"block": list(block), "ms": timings[block], "source": "measured"}
    cache.put(key, entry, persist=True)
    measured[cache.path, key] = {str(list(k)): v for k, v in timings.items()}
    return block, {**entry, "timings": dict(measured[cache.path, key])}


def _resolve_measure(measure, cfg, device, make, candidates):
    """A thunk giving the measure of a miss: the injected one, else a real
    one where the tune mode allows, more than one candidate exists, and no
    graph is being captured (such a miss is counted)."""
    def resolve():
        global capture_misses
        if measure is not None or len(candidates()) < 2 \
                or not _should_measure(cfg, device):
            return measure
        if _capturing(device):
            capture_misses += 1
            return None
        return make()
    return resolve


def autotune(B: int, M: int, N: int, K: int, policy_name: str, *,
             measure=None, cache: BlockCache | None = None, reps: int = REPS,
             max_candidates: int | None = None, cfg=None,
             namespace: str | None = None, operands=None, device=None
             ) -> tuple[tuple[int, int, int], dict]:
    """Pick kernel 1's tile for ``(B, M, N, K)`` under ``policy_name``.

    Returns ``(block, meta)``, ``meta["source"]`` one of "cache",
    "measured" (persisted) or "heuristic".  ``measure`` is injectable
    (``block -> ms``); else a miss is measured where :func:`_should_measure`
    allows, on ``operands`` ``(a, b)`` when given (the dispatcher's
    canonical operands) or on random ones of the shape."""
    cfg = cfg or numerics.active()
    dev = _device(operands[0].device if operands is not None else device)

    def make():
        if operands is not None:
            a, b = operands
        else:
            bsh = (B,) if B > 1 else ()
            a = torch.rand(*bsh, M, K, device=dev)
            b = torch.rand(*bsh, K, N, device=dev)
        return _matmul_measure(a, b, policy_name, reps)

    def cands():
        return candidate_blocks(M, N, K, policy_name)

    return _autotune_protocol(
        cache_key(B, M, N, K, policy_name, dev.type, namespace),
        heuristic=lambda: heuristic_block(M, N, K, policy_name),
        candidates=cands,
        measure=_resolve_measure(measure, cfg, dev, make, cands),
        cache=cache or get_cache(cfg), max_candidates=max_candidates,
        read_cache=cfg.tune != "off")


def get_block(M: int, N: int, K: int, policy_name: str, batch: int = 1,
              cfg=None, namespace: str | None = None,
              operands=None) -> tuple[int, int, int]:
    """The dispatch-facing entry: the tuned tile, else the heuristic's."""
    block, _ = autotune(batch, M, N, K, policy_name, cfg=cfg,
                        namespace=namespace, operands=operands)
    return block


# ----------------------------------------------------- attention namespace

def attn_candidate_blocks(S: int, T: int, rep: int, hd: int, hdv: int,
                          policy_name: str) -> list[tuple[int, int]]:
    """Kernel 2's one tile at these head dims: ``(64 query rows, key
    tile)``."""
    pol = get_policy(policy_name)
    return [(_ta.ROWS, _ta.key_tile(pol.n_splits, max(hd, hdv)))]


def attn_heuristic_block(S: int, T: int, rep: int, hd: int, hdv: int,
                         policy_name: str) -> tuple[int, int]:
    return attn_candidate_blocks(S, T, rep, hd, hdv, policy_name)[0]


def attn_cache_key(B: int, Hkv: int, rep: int, S: int, T: int, hd: int,
                   hdv: int, policy_name: str, backend: str,
                   causal: bool = True, namespace: str | None = None) -> str:
    s, t = _round_up(S, 128), _round_up(T, 128)
    d, dv = _round_up(hd, 128), _round_up(hdv, 128)
    return (f"{_ns(backend, namespace)}/attn/{policy_name}/"
            f"b{max(1, B)}_h{max(1, Hkv)}_r{rep}_s{s}_t{t}_d{d}_v{dv}"
            f"_c{int(causal)}")


def autotune_attention(B: int, Hkv: int, rep: int, S: int, T: int, hd: int,
                       hdv: int, policy_name: str, *, causal: bool = True,
                       measure=None, cache: BlockCache | None = None,
                       max_candidates: int | None = None, cfg=None,
                       namespace: str | None = None, device=None
                       ) -> tuple[tuple[int, int], dict]:
    """Kernel 2's analogue of :func:`autotune`: the same protocol and
    file.  With one candidate nothing is measured unless ``measure`` is
    injected."""
    cfg = cfg or numerics.active()
    return _autotune_protocol(
        attn_cache_key(B, Hkv, rep, S, T, hd, hdv, policy_name,
                       _device(device).type, causal, namespace),
        heuristic=lambda: attn_heuristic_block(S, T, rep, hd, hdv,
                                               policy_name),
        candidates=lambda: attn_candidate_blocks(S, T, rep, hd, hdv,
                                                 policy_name),
        measure=lambda: measure, cache=cache or get_cache(cfg),
        max_candidates=max_candidates, read_cache=cfg.tune != "off")


def get_attention_block(B: int, Hkv: int, rep: int, S: int, T: int, hd: int,
                        hdv: int, policy_name: str, causal: bool = True,
                        cfg=None, namespace: str | None = None,
                        device=None) -> tuple[int, int]:
    block, _ = autotune_attention(B, Hkv, rep, S, T, hd, hdv, policy_name,
                                  causal=causal, cfg=cfg,
                                  namespace=namespace, device=device)
    return block


# ------------------------------------------------------- paged namespace

def paged_candidate_blocks(maxp: int, ps: int, rep: int, hd: int, hdv: int,
                           policy_name: str) -> list[int]:
    """C in (1, 2, 4, 8, 16, 32) up to ``maxp`` that the C entry takes,
    largest first."""
    ns = get_policy(policy_name).n_splits
    out = [c for c in PAGED_CANDIDATE_STEPS
           if c <= max(1, maxp) and _tp.takes_chunk(c, maxp, ps, rep, hd,
                                                    hdv, ns)]
    return sorted(out, reverse=True) or [1]


def paged_heuristic_block(B: int, Hkv: int, maxp: int, ps: int, hd: int,
                          hdv: int) -> int:
    """``chunk_pages``: what kernel 3 takes without a C."""
    return _tp.chunk_pages(B, Hkv, maxp, ps, hd, hdv)


def paged_cache_key(B: int, Hkv: int, rep: int, maxp: int, ps: int, hd: int,
                    hdv: int, policy_name: str, backend: str,
                    namespace: str | None = None) -> str:
    d, dv = _round_up(hd, 128), _round_up(hdv, 128)
    return (f"{_ns(backend, namespace)}/paged/{policy_name}/"
            f"b{max(1, B)}_h{max(1, Hkv)}_r{rep}_p{max(1, maxp)}_ps{ps}"
            f"_d{d}_v{dv}")


def _paged_measure(B, Hkv, rep, maxp, ps, hd, hdv, policy_name, device,
                   reps: int):
    """``C -> ms`` of kernel 3 on inputs of the shape: random query and
    bf16 pools, every slot at the table's full length (the plain version on
    the CPU)."""
    g = torch.Generator(device=device).manual_seed(0)
    NP = max(2, B * maxp + 1)
    q = torch.rand(B, Hkv * rep, hd, generator=g, device=device)
    kp = torch.rand(NP, ps, Hkv, hd, generator=g, device=device).bfloat16()
    vp = torch.rand(NP, ps, Hkv, hdv, generator=g, device=device).bfloat16()
    bt = (torch.arange(B * maxp, device=device, dtype=torch.int32)
          .reshape(B, maxp) % (NP - 1) + 1)
    lens = torch.full((B,), maxp * ps, dtype=torch.int32, device=device)
    run = _tp.enqueue if device.type == "cuda" \
        else _tp.tcec_paged_attention_plain

    def measure(c):
        return _time_ms(lambda: run(q, kp, vp, bt, lens, policy=policy_name,
                                    pages_per_chunk=c), device, reps)
    return measure


def autotune_paged(B: int, Hkv: int, rep: int, maxp: int, ps: int, hd: int,
                   hdv: int, policy_name: str, *, measure=None,
                   cache: BlockCache | None = None, reps: int = REPS,
                   max_candidates: int | None = None, cfg=None,
                   namespace: str | None = None, device=None
                   ) -> tuple[int, dict]:
    """Kernel 3's analogue of :func:`autotune`: C per slot count, kv
    heads, table width and page size.  Entries store C as a one-element
    ``block``, so the schema stays uniform."""
    cfg = cfg or numerics.active()
    dev = _device(device)

    def cands():
        return [(c,) for c in paged_candidate_blocks(maxp, ps, rep, hd, hdv,
                                                     policy_name)]

    def make():
        return _paged_measure(B, Hkv, rep, maxp, ps, hd, hdv, policy_name,
                              dev, reps)

    resolve = _resolve_measure(measure, cfg, dev, make, cands)

    def per_block():
        real = resolve()
        return None if real is None else (lambda blk: real(blk[0]))

    block, meta = _autotune_protocol(
        paged_cache_key(B, Hkv, rep, maxp, ps, hd, hdv, policy_name,
                        dev.type, namespace),
        heuristic=lambda: (paged_heuristic_block(B, Hkv, maxp, ps, hd,
                                                 hdv),),
        candidates=cands, measure=per_block,
        cache=cache or get_cache(cfg), max_candidates=max_candidates,
        read_cache=cfg.tune != "off")
    return block[0], meta


def get_paged_block(B: int, Hkv: int, rep: int, maxp: int, ps: int, hd: int,
                    hdv: int, policy_name: str, cfg=None,
                    namespace: str | None = None, device=None) -> int:
    """Dispatch-facing entry for kernel 3's C."""
    c, _ = autotune_paged(B, Hkv, rep, maxp, ps, hd, hdv, policy_name,
                          cfg=cfg, namespace=namespace, device=device)
    return c
