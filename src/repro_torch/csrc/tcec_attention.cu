// TCEC flash attention (prefill) for Hopper: softmax(QK^T / sqrt(hd)) V
// with causal, window and tanh softcap, both products built from bf16 term
// products and each held in f32 in one accumulator per scale group.
//
// Replaces the TPU kernel src/repro/kernels/tcec_attention.py::_attn_kernel
// (helpers _tcec_product and _pv_parts), launched there by
// tcec_attention_pallas.
//
// What bounds it on the H100: operations.  A policy with P kept term
// products runs P bf16 products for QK^T and P for P.V over the causal half
// of the (S, T) pairs; Q, K, V and the output cross device memory once per
// block of 64 query rows.  At 2 x 512 tokens, 16/8 heads, head_dim 128 and
// x6 that is 13 us of tensor-core work against 7.5 us of bytes.
//
// The design:
//  * One block per (batch x kv head, 128 output columns, 64 query rows =
//    rep heads x floor(64 / rep) positions; rows past rep of them are
//    padding when rep does not divide 64), so GQA reads each K/V tile once
//    for all rep query heads.  The kernel is instantiated for head dims
//    padded to 128 and to 256 (the larger of hd and hdv); at 256 a block
//    computes all of QK^T and P.V for one 128-wide half of the output
//    columns, so the scores are computed once for each half.
//    The operands are in the model's layout, q (B, S, Hkv rep, hd), k and v
//    (B, T, Hkv, hd[v]), out (B, S, Hkv rep, hdv), so nothing is transposed
//    around the kernel: a block reads its rows with the head stride.
//    The q-block index is the slow grid axis and runs backwards: the
//    heaviest causal blocks (the last positions, which visit the most key
//    tiles) launch first and the light ones fill the tail of the last wave.
//  * Warp-specialized, 384 threads: a producer warpgroup (setmaxnreg 40)
//    and two consumer warpgroups (setmaxnreg 232), handing over each tile's
//    K terms and V terms through named barriers (in / read).
//  * The producer walks the live K/V tiles (a tile that the causal mask or
//    the window kills for every (q, k) pair is skipped: exact, it adds no
//    mass), copies each f32 tile in halves with cp.async into two staging
//    buffers, one half ahead of the split, and splits each half into its
//    bf16 terms in shared memory once per block.  The terms never reach
//    device memory.  K and V terms are both stored with the keys as rows:
//    K-major for QK^T, MN-major (the transpose bit) for P.V.
//  * Consumer warpgroup w computes the scores of keys w BKV / 2.. of the
//    tile for all 64 rows (m64n(BKV / 2)k16) and owns output columns 64 w..
//    of the block's 128 in P.V (m64n64k16).  Every wgmma is one k16 step of one
//    term product, issued with scale-d = 0, and its fragment is added with
//    round-to-nearest f32 adds into the accumulator of its scale group (the
//    paper's rule: no tensor-core chain runs across k16 steps or term
//    products).  Two fragments alternate, so that one wgmma runs while the
//    other is added.  The scores fold their scale groups smallest-first
//    (s = part_g + s 2^-s), one group partial live at a time.
//  * The online softmax runs in registers, in wgmma's accumulator layout,
//    with quad shuffles along each row; the two key halves' row maxima meet
//    in shared memory under a named barrier, and each warpgroup keeps its
//    share of the row sum until the end.  The P.V accumulators (one per
//    scale group) are rescaled in registers.
//  * P.V takes A = the P terms: the warpgroup's own key half straight from
//    registers (the scores' accumulator layout is the register A-fragment
//    layout, two f32 to one bf16x2), the other half from shared memory,
//    where the other warpgroup wrote the same words.  Splitting the scores
//    by key half instead of computing all of them in both warpgroups saves
//    a third of the tensor-core work.  With 16 keys a tile (x10 at head
//    dim 256) a key half is 8 keys, less than a k16 step: both warpgroups
//    then take all of P from shared memory.
//  * With a single K/V tile the probabilities are normalized before P.V,
//    the JAX kernel's single-block order of operations.
//
// The budget (H100: 227 KB of shared memory a block, 64K registers an SM),
// 64 query rows, 128 output columns a block; one block per SM:
//   shared memory  Q, K, V and P terms, two f32 half tiles, small state
//     head dims padded to 128:
//     x3  (2 terms, 64 keys):  32 + 32 + 32 + 16 + 33 + 2 KB = 147 KB
//     x6  (3 terms, 64 keys):  48 + 48 + 48 + 24 + 33 + 2 KB = 203 KB
//     x10 (4 terms, 32 keys):  64 + 32 + 32 + 16 + 17 + 1 KB = 162 KB
//     (64 keys at x10 would need 259 KB);
//     padded to 256 (Q and K 256 wide, V 128, staging rows of 260):
//     x3  (2 terms, 32 keys):  64 + 32 + 16 +  8 + 33 + 1 KB = 154 KB
//     x6  (3 terms, 32 keys):  96 + 48 + 24 + 12 + 33 + 1 KB = 214 KB
//     x10 (4 terms, 16 keys): 128 + 32 + 16 +  8 + 16 + 1 KB = 201 KB
//     (x6 at 64 keys would need 327 KB, x10 at 32 keys 275 KB).
//   registers  consumers 232 a thread: the P.V accumulators, 32 per scale
//     group (96 at x6, 128 at x10), two 32-register wgmma fragments, and
//     during QK^T the folded scores and one group partial, BKV / 4 each
//     (fewer at 256: its tiles hold half the keys); the Q split goes 4
//     items (32 values) at a time; the producer 40: one item (8 values and
//     their terms) at a time.
//     (40 x 128 + 232 x 256 is the block's 168 a thread at launch.)
#include <climits>
#include <cstdint>
#include <type_traits>

#include "tcec_common.cuh"
#include "tcec_sm90.cuh"

namespace {

using namespace sm90;

constexpr int ROWS = 64;               // query rows per block (rep * positions)
constexpr int OUTW = 128;              // output columns per block
constexpr int HDMAX = 256;             // the largest padded head dim
constexpr int PRODUCER = 128;          // threads of the producer warpgroup
constexpr int CONSUMERS = 256;         // threads of the two consumer warpgroups
constexpr int THREADS = PRODUCER + CONSUMERS;
// named barriers: the tile's K terms are in / read, its V terms are in /
// read, the consumers among themselves, the producers among themselves
enum : int { B_KFULL = 1, B_KEMPTY, B_VFULL, B_VEMPTY, B_CONS, B_PROD };
// Registers a thread after the rebalancing.  setmaxnreg moves registers
// within what the block was launched with, 168 a thread (65,536 / 384,
// rounded down to a multiple of 8): asking for more hangs the consumers.
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(PRODUCER * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                  THREADS * (65536 / THREADS / 8 * 8),
              "the registers the block is launched with");
constexpr float LOG2E = 1.4426950408889634f;

// The layout for NS terms and head dims padded to HDP (128 or 256).
template <int NS, int HDP>
struct Tile {
  static_assert(HDP == 128 || HDP == 256, "head dims padded to 128 or 256");
  // keys per K/V tile: 64 (32 at x10) at 128, half that at 256
  static constexpr int BKV = (HDP == 128 ? 64 : 32) / (NS == 4 ? 2 : 1);
  static constexpr int HALF = BKV / 2;             // keys of one warpgroup's scores
  static constexpr int LDF = HDP + 4;              // f32 staging row (conflict-free reads)
  static constexpr int Q_TERM = ROWS * HDP * 2;    // bytes of one bf16 term
  static constexpr int K_TERM = BKV * HDP * 2;
  static constexpr int V_TERM = OUTW * BKV * 2;
  static constexpr int P_TERM = ROWS * BKV * 2;
  static constexpr int Q_SBO = HDP / 8 * 128;      // 8-row group strides
  static constexpr int K_SBO = HDP / 8 * 128;
  // V is MN-major (keys as rows, like K): 8-column groups 128 bytes apart,
  // 8-key groups OUTW / 8 core matrices apart
  static constexpr int V_SBO = 128, V_LBO = OUTW / 8 * 128;
  static constexpr int P_SBO = BKV / 8 * 128;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + NS * Q_TERM;
  static constexpr size_t v = k + NS * K_TERM;
  static constexpr size_t p = v + NS * V_TERM;
  static constexpr size_t stage = p + NS * P_TERM;     // two f32 half tiles
  static constexpr size_t kpos = stage + 4 * BKV * LDF;  // two tiles' k_pos
  static constexpr size_t info = kpos + 4 * 2 * BKV;   // two tiles' index, keys, full
  static constexpr size_t red = info + 4 * 2 * 4;      // row max, row sum, per wg
  static constexpr size_t walk = red + 4 * 4 * ROWS;   // the producer's next tile
  static constexpr size_t bytes = walk + 16;
  static_assert(bytes <= 232448, "227 KB of shared memory a block");
};

// Issue the cp.async copies of nk f32 rows of the given width (at most RW),
// ld floats apart in device memory, into a staging tile of rows LDF floats
// apart (rows past the end are not copied; the split reads zeros for
// them).  Thread t of N copies 16-byte chunk t % (RW / 4) of rows
// t / (RW / 4) + N / (RW / 4) i.
template <int N, int RW, int LDF>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int row0, int nk, int width,
                                          long long ld, int tid) {
  constexpr int CH = RW / 4;
  const int ch = tid % CH;
  if (4 * ch < width)
    for (int r = tid / CH; r < nk; r += N / CH)
      cp_async16(dst + r * LDF + 4 * ch, src + (row0 + r) * ld + 4 * ch);
}

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The causal / window test of one K/V tile against the block's queries
// (positions qmin .. qmax): live if some (q, k) pair is kept, full if every
// pair is (then the tile needs no mask).
struct Span {
  int qmin, qmax, causal, window;
  __device__ bool live(int kmin, int kmax) const {
    return (!causal || qmax >= kmin) && (window <= 0 || qmin - kmax < window);
  }
  __device__ bool full(int kmin, int kmax) const {
    return (!causal || qmin >= kmax) && (window <= 0 || qmax - kmin < window);
  }
};

// This lane's share of the min and max key position of tile kb.
template <int BKV>
__device__ __forceinline__ void tile_keys(int kb, int nkb, int T,
                                          const int* __restrict__ k_pos,
                                          int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  if (kb >= nkb) return;
  const int col0 = kb * BKV, nk = min(BKV, T - col0);
#pragma unroll
  for (int c = lane; c < BKV; c += 32) {
    if (c < nk) {
      const int p = k_pos[col0 + c];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
}

// The first live tile at or after kb, whose lanes' key bounds (lo, hi) are
// already loaded, and whether it is full; one warp, nkb if none.
template <int BKV>
__device__ __forceinline__ int next_live(int kb, int lo, int hi, int nkb, int T,
                         const int* __restrict__ k_pos, const Span& span,
                         int lane, bool& full) {
  for (; kb < nkb; ++kb) {
    lo = warp_min_int(lo);
    hi = warp_max_int(hi);
    if (span.live(lo, hi)) {
      full = T - kb * BKV >= BKV && span.full(lo, hi);
      return kb;
    }
    tile_keys<BKV>(kb + 1, nkb, T, k_pos, lane, lo, hi);
  }
  full = false;
  return nkb;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------- the kernel

// The producer warpgroup: walks the live K/V tiles and stages each in
// halves of BKV / 2 rows (K first, then V) through two f32 buffers, with
// cp.async one half ahead of the split; splits each half into its bf16
// terms once the consumers are done with the previous tile's terms.
template <int NS, int HDP>
__device__ __forceinline__ void produce(unsigned char* smem, const float* k,
                                        const float* v, const int* q_pos,
                                        const int* k_pos, int Hkv, int rep,
                                        int S, int T, int hd, int hdv,
                                        int causal, int window, float scale) {
  using L = Tile<NS, HDP>;
  const int tid = threadIdx.x;
  const int bq = ROWS / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;   // as the consumers
  // this block's kv head in k (B, T, Hkv, hd) and v (B, T, Hkv, hdv), and
  // its 128 output columns: V's columns col0.. (col0 + vw)
  const int ncol = HDP == OUTW ? 1 : (hdv + OUTW - 1) / OUTW;
  const int bh = blockIdx.x / ncol, vcol0 = blockIdx.x % ncol * OUTW;
  const int vw = min(OUTW, hdv - vcol0);
  const long long kv0 = (bh / Hkv * (long long)T * Hkv + bh % Hkv);
  k += kv0 * hd;
  v += kv0 * hdv + vcol0;
  const int nq = min(bq, S - q0);
  constexpr int BKV = L::BKV, HB = BKV / 2, LDF = L::LDF;
  constexpr int KCG = HDP / 8, VCG = OUTW / 8;        // 8-column groups
  static_assert(HB * VCG / PRODUCER >= 1, "every producer thread has an item");
  float* stage = reinterpret_cast<float*>(smem + L::stage);
  int* kpos_s = reinterpret_cast<int*>(smem + L::kpos);
  int* info = reinterpret_cast<int*>(smem + L::info);
  int* walk = reinterpret_cast<int*>(smem + L::walk);
  const int warp = tid >> 5, lane = tid & 31;
  const int nkb = (T + BKV - 1) / BKV;
  Span span{0, 0, causal, window};
  // one cp.async group: half h of tile t of K (with the keys' positions,
  // for the n-th tile) or of V, into staging buffer h
  auto copy_half = [&](bool is_k, int t, int h, int n) {
    if (t < nkb) {
      const int col0 = t * BKV, nk = min(BKV, T - col0);
      float* dst = stage + h * HB * LDF;
      const int nr = min(HB, nk - h * HB);
      if (is_k)
        copy_rows<PRODUCER, HDP, LDF>(dst, k, col0 + h * HB, nr, hd,
                                      (long long)Hkv * hd, tid);
      else
        copy_rows<PRODUCER, OUTW, LDF>(dst, v, col0 + h * HB, nr, vw,
                                       (long long)Hkv * hdv, tid);
      if (n >= 0 && tid < nk)
        cp_async4(kpos_s + (n & 1) * BKV + tid, k_pos + col0 + tid);
    }
    cp_async_commit();
  };
  // K or V terms of half h (rows = keys, CG 8-column groups; K-major for
  // K, MN-major for V): item (key c, 8 columns c8), c % 8 fastest, so each
  // 8 threads store one 128-byte core matrix
  auto split_rows = [&](auto cg, size_t region, int term_bytes, int h, int nk,
                        int width) {
    constexpr int CG = decltype(cg)::value;
    constexpr int ITEMS = HB * CG / PRODUCER;   // per thread and half
    const float* sb = stage + h * HB * LDF;
#pragma unroll 1
    for (int it = 0; it < ITEMS; ++it) {
      const int idx = tid + PRODUCER * it;
      const int cl = idx / (8 * CG) * 8 + (idx & 7), c8 = (idx >> 3) % CG;
      const int c = h * HB + cl;
      float x[8];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = c < nk && 8 * c8 + 4 * e < width;
        const float4 t = in ? *reinterpret_cast<const float4*>(sb + cl * LDF + 8 * c8 + 4 * e)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        x[4 * e] = t.x; x[4 * e + 1] = t.y; x[4 * e + 2] = t.z; x[4 * e + 3] = t.w;
      }
      uint4 t[NS];
      split8<NS>(x, scale, t);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        *reinterpret_cast<uint4*>(smem + region + i * term_bytes +
                                  core_offset(c, c8, CG)) = t[i];
    }
  };
  auto split_k = [&](int h, int nk) {
    split_rows(std::integral_constant<int, KCG>(), L::k, L::K_TERM, h, nk, hd);
  };
  auto split_v = [&](int h, int nk) {
    split_rows(std::integral_constant<int, VCG>(), L::v, L::V_TERM, h, nk, vw);
  };

  // Each step below waits for the half copied during the step before,
  // lets the copy of the next half go into the other buffer (free once
  // every producer thread passed the barrier), and splits.
  //
  // The first K tile goes in flight at once, before the walk: tile 0, the
  // first live tile of every causal prefill block.  Warp 0's loads for the
  // walk (the block's query positions, its first two live tiles) are
  // issued first and resolved after the first half is split.
  int lo = INT_MAX, hi = INT_MIN, lo0, hi0, lo1, hi1;
  if (warp == 0) {
    for (int i = lane; i < nq; i += 32) {
      lo = min(lo, q_pos[q0 + i]);
      hi = max(hi, q_pos[q0 + i]);
    }
    tile_keys<BKV>(0, nkb, T, k_pos, lane, lo0, hi0);
    tile_keys<BKV>(1, nkb, T, k_pos, lane, lo1, hi1);
  }
  copy_half(true, 0, 0, 0);
  copy_half(true, 0, 1, -1);
  cp_async_wait<1>();
  bar_sync(B_PROD, PRODUCER);
  split_k(0, min(BKV, T));
  if (warp == 0) {
    span.qmin = warp_min_int(lo);
    span.qmax = warp_max_int(hi);
    bool f0, f1;
    const int t0 = next_live<BKV>(0, lo0, hi0, nkb, T, k_pos, span, lane, f0);
    if (t0 != 0) tile_keys<BKV>(t0 + 1, nkb, T, k_pos, lane, lo1, hi1);
    const int t1 = next_live<BKV>(t0 + 1, lo1, hi1, nkb, T, k_pos, span, lane, f1);
    if (lane == 0) {
      walk[0] = t0;
      walk[1] = f0;
      walk[2] = t1;
      walk[3] = f1;
    }
  }
  cp_async_wait<0>();
  bar_sync(B_PROD, PRODUCER);   // K, second half; the walk
  int cur = walk[0], nxt = walk[2];
  const bool full = walk[1];
  bool nfull = walk[3];
  if (cur >= nkb) {   // no live tile: tell the consumers
    if (tid == 0) info[0] = -1;
    bar_arrive(B_KFULL, THREADS);
    return;
  }
  if (cur != 0) {   // the guess was wrong: split the right tile
    copy_half(true, cur, 0, 0);
    copy_half(true, cur, 1, -1);
    cp_async_wait<1>();
    bar_sync(B_PROD, PRODUCER);
    split_k(0, min(BKV, T - cur * BKV));
    cp_async_wait<0>();
    bar_sync(B_PROD, PRODUCER);
  }
  int nk = min(BKV, T - cur * BKV);
  copy_half(false, cur, 0, -1);
  split_k(1, nk);
  if (tid == 0) {
    info[0] = cur;
    info[1] = nk;
    info[2] = full;
  }
  fence_async_smem();
  bar_arrive(B_KFULL, THREADS);

  for (int n = 0;; ++n) {
    // V of tile n (cur); warp 0 loads the keys of the tile after the next
    if (warp == 0) tile_keys<BKV>(nxt + 1, nkb, T, k_pos, lane, lo, hi);
    cp_async_wait<0>();
    bar_sync(B_PROD, PRODUCER);   // V, first half
    copy_half(false, cur, 1, -1);
    if (n > 0) bar_sync(B_VEMPTY, THREADS);   // the consumers' P.V is done
    split_v(0, nk);
    if (warp == 0) {
      bool f;
      const int nn = next_live<BKV>(nxt + 1, lo, hi, nkb, T, k_pos, span, lane, f);
      if (lane == 0) {
        walk[0] = nn;
        walk[1] = f;
      }
    }
    cp_async_wait<0>();
    bar_sync(B_PROD, PRODUCER);   // V, second half; the walk
    copy_half(true, nxt, 0, n + 1);
    const int nn = walk[0];
    const bool nnf = walk[1];
    split_v(1, nk);
    fence_async_smem();
    bar_arrive(B_VFULL, THREADS);
    int* inf = info + 4 * ((n + 1) & 1);
    if (nxt >= nkb) {   // no more tiles: tell the consumers
      cp_async_wait<0>();
      bar_sync(B_KEMPTY, THREADS);
      if (tid == 0) inf[0] = -1;
      bar_arrive(B_KFULL, THREADS);
      bar_sync(B_VEMPTY, THREADS);
      return;
    }
    // K of tile n + 1 (nxt)
    nk = min(BKV, T - nxt * BKV);
    cp_async_wait<0>();
    bar_sync(B_PROD, PRODUCER);   // K, first half, and the positions
    copy_half(true, nxt, 1, -1);
    bar_sync(B_KEMPTY, THREADS);   // the consumers' scores of tile n are done
    split_k(0, nk);
    cp_async_wait<0>();
    bar_sync(B_PROD, PRODUCER);   // K, second half
    copy_half(false, nxt, 0, -1);
    split_k(1, nk);
    if (tid == 0) {
      inf[0] = nxt;
      inf[1] = nk;
      inf[2] = nfull;
    }
    fence_async_smem();
    bar_arrive(B_KFULL, THREADS);
    cur = nxt;
    nxt = nn;
    nfull = nnf;
  }
}

// Register layout of an m64nN accumulator in warpgroup thread t (warp
// w = t / 32 % 4, lane l): element 4 i + 2 h + c sits at row 16 w + l / 4
// + 8 h, column 8 i + 2 (l % 4) + c.
template <int NS, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
tcec_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ q_pos,
                      const int* __restrict__ k_pos, float* __restrict__ out,
                      int Hkv, int rep, int S, int T, int hd, int hdv,
                      int causal, int window, float softcap, float sm_denom,
                      float scale, float inv) {
  using L = Tile<NS, HDP>;
  constexpr int BKV = L::BKV, HALF = L::HALF;
  constexpr int NH = HALF / 2;      // score registers per thread
  constexpr int KQ = HDP / 16;      // k16 steps of QK^T
  constexpr int KV = BKV / 16;      // k16 steps of P.V
  constexpr int KH = KV / 2;        // ... of which from this warpgroup's P
  constexpr int CG = HDP / 8;       // 8-column groups of Q
  extern __shared__ __align__(128) unsigned char smem[];
  // Nothing is computed before the roles split: a value live across
  // setmaxnreg would be spilled.
  if (threadIdx.x < PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce<NS, HDP>(smem, k, v, q_pos, k_pos, Hkv, rep, S, T, hd, hdv,
                     causal, window, scale);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int bq = ROWS / rep;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * bq;   // heaviest first
  // this block's (batch, kv head) and its output columns col0..
  const int ncol = HDP == OUTW ? 1 : (hdv + OUTW - 1) / OUTW;
  const int bh = blockIdx.x / ncol, col0 = blockIdx.x % ncol * OUTW;
  // this block's query rows in q (B, S, H, hd) and out (B, S, H, hdv), H =
  // Hkv rep: row r < rep bq is head hkv rep + r / bq at position q0 + r % bq
  const long long qrow0 =
      (bh / Hkv * (long long)S + q0) * Hkv * rep + bh % Hkv * rep;
  const long long qld = (long long)Hkv * rep;   // rows from one position to the next
  const int nq = min(bq, S - q0);
  const bool single = T <= BKV;
  const int tid = threadIdx.x - PRODUCER, warp = tid >> 5, lane = tid & 31;
  const int wg = tid >> 7;           // keys wg * HALF.. of the scores,
                                     // output columns 64 wg.. of P.V
  const int* kpos_s = reinterpret_cast<const int*>(smem + L::kpos);
  const int* info = reinterpret_cast<const int*>(smem + L::info);
  float* red = reinterpret_cast<float*>(smem + L::red);
  const uint32_t sbase = smem_addr(smem);

  // this thread's two accumulator rows and their query positions
  const int row0 = (warp & 3) * 16 + (lane >> 2), row1 = row0 + 8;
  const int qp0 = q_pos[q0 + min(row0 % bq, nq - 1)];
  const int qp1 = q_pos[q0 + min(row1 % bq, nq - 1)];

  // Q terms: item (row r, 8 columns c8), r % 8 fastest.  Row r is head
  // r / bq of the group at position q0 + r % bq; rows past the end and the
  // padding rows are zeros.  Four items at a time: every load of a batch
  // is issued before its first split.
  constexpr int QITEMS = ROWS * HDP / 8 / CONSUMERS, QB = 4;
#pragma unroll 1
  for (int b0 = 0; b0 < QITEMS; b0 += QB) {
    float qx[QB][8];
#pragma unroll
    for (int it = 0; it < QB; ++it) {
      const int idx = tid + CONSUMERS * (b0 + it);
      const int r = idx / (8 * CG) * 8 + (idx & 7), c8 = (idx >> 3) % CG;
      const int rr = r / bq, qi = r % bq;
      const float* src = q + (qrow0 + qi * qld + rr) * hd + 8 * c8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (qi < nq && rr < rep && 8 * c8 + 4 * h < hd)
          t = *reinterpret_cast<const float4*>(src + 4 * h);
        qx[it][4 * h] = t.x; qx[it][4 * h + 1] = t.y; qx[it][4 * h + 2] = t.z; qx[it][4 * h + 3] = t.w;
      }
    }
#pragma unroll
    for (int it = 0; it < QB; ++it) {
      const int idx = tid + CONSUMERS * (b0 + it);
      const int r = idx / (8 * CG) * 8 + (idx & 7), c8 = (idx >> 3) % CG;
      uint4 t[NS];
      split8<NS>(qx[it], scale, t);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        *reinterpret_cast<uint4*>(smem + L::q + i * L::Q_TERM +
                                  core_offset(r, c8, CG)) = t[i];
    }
  }
  fence_async_smem();
  bar_sync(B_CONS, CONSUMERS);   // the Q terms

  const int t4 = lane & 3;
  const float rdenom = 1.0f / sm_denom;

  float acc[NS][32];
#pragma unroll
  for (int g = 0; g < NS; ++g)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[g][e] = 0.0f;
  float f0[32], f1[32];   // wgmma fragments
#pragma unroll
  for (int e = 0; e < 32; ++e) f0[e] = f1[e] = 0.0f;
  // running max (both warpgroups hold the same) and this warpgroup's share
  // of the running sum, for rows row0 and row1
  float m0 = tcec::NEG_INF, m1 = tcec::NEG_INF, l0 = 0.0f, l1 = 0.0f;

  for (int n = 0;; ++n) {
    bar_sync(B_KFULL, THREADS);   // this tile's K terms are in
    const int* inf = info + 4 * (n & 1);
    if (inf[0] < 0) break;
    const int nk = inf[1];
    const bool full = inf[2];
    const int* kp_s = kpos_s + (n & 1) * BKV;

    // scores of this warpgroup's HALF keys, folding the scale groups
    // smallest-first: s = part_g + s 2^-s
    const uint32_t qb = opaque(desc_lo(sbase + L::q));
    const uint32_t kb = opaque(desc_lo(sbase + L::k)) +
                        ((wg * (HALF / 8) * L::K_SBO) >> 4);
    float s[NH];
#pragma unroll
    for (int g = NS - 1; g >= 0; --g) {
      float part[NH];
#pragma unroll
      for (int e = 0; e < NH; ++e) part[e] = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (i > g) break;
        const uint32_t ka = kb + (((g - i) * L::K_TERM) >> 4);
        add_term_product<KQ>(part, f0, f1, [&](float(&f)[32], int kk) {
          mma<NH>(f, desc(qb + ((i * L::Q_TERM) >> 4) + kk * 16, L::Q_SBO),
                  desc(ka + kk * 16, L::K_SBO));
        });
      }
#pragma unroll
      for (int e = 0; e < NH; ++e)
        s[e] = g == NS - 1 ? part[e] : part[e] + s[e] * inv;
    }
    bar_arrive(B_KEMPTY, THREADS);   // the K terms may be overwritten

    // scale, softcap, additive mask (none where every pair is kept)
#pragma unroll
    for (int e = 0; e < NH; ++e) {
      float x = s[e] * rdenom;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      s[e] = x;
    }
    if (!full) {
#pragma unroll
      for (int i = 0; i < HALF / 8; ++i) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = wg * HALF + 8 * i + 2 * t4 + c;
          const int kp = kp_s[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int d = (h ? qp1 : qp0) - kp;
            bool ok = col < nk;
            if (causal) ok = ok && d >= 0;
            if (window > 0) ok = ok && d < window;
            s[4 * i + 2 * h + c] += ok ? 0.0f : tcec::NEG_INF;
          }
        }
      }
    }

    // online softmax along each row: the 4 lanes of a quad hold one row of
    // this warpgroup's keys; the row max is exchanged with the other
    float mx0 = tcec::NEG_INF, mx1 = tcec::NEG_INF;
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    if (t4 == 0) {
      red[wg * ROWS + row0] = mx0;
      red[wg * ROWS + row1] = mx1;
    }
    bar_sync(B_CONS, CONSUMERS);   // both halves' row max
    mx0 = fmaxf(red[row0], red[ROWS + row0]);
    mx1 = fmaxf(red[row1], red[ROWS + row1]);
    float a0 = 1.0f, a1 = 1.0f;
    if (!single) {
      mx0 = fmaxf(m0, mx0);
      mx1 = fmaxf(m1, mx1);
      a0 = exp2f((m0 - mx0) * LOG2E);
      a1 = exp2f((m1 - mx1) * LOG2E);
      m0 = mx0;
      m1 = mx1;
    }
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < HALF / 8; ++i) {
      s[4 * i] = exp2f((s[4 * i] - mx0) * LOG2E);
      s[4 * i + 1] = exp2f((s[4 * i + 1] - mx0) * LOG2E);
      s[4 * i + 2] = exp2f((s[4 * i + 2] - mx1) * LOG2E);
      s[4 * i + 3] = exp2f((s[4 * i + 3] - mx1) * LOG2E);
      sum0 += s[4 * i] + s[4 * i + 1];
      sum1 += s[4 * i + 2] + s[4 * i + 3];
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);
    if (single) {
      // the softmax completes here: normalize P before P.V
      if (t4 == 0) {
        red[2 * ROWS + wg * ROWS + row0] = sum0;
        red[2 * ROWS + wg * ROWS + row1] = sum1;
      }
      bar_sync(B_CONS, CONSUMERS);
      sum0 = red[2 * ROWS + row0] + red[3 * ROWS + row0];
      sum1 = red[2 * ROWS + row1] + red[3 * ROWS + row1];
#pragma unroll
      for (int i = 0; i < HALF / 8; ++i) {
        s[4 * i] /= sum0;
        s[4 * i + 1] /= sum0;
        s[4 * i + 2] /= sum1;
        s[4 * i + 3] /= sum1;
      }
    } else {
      l0 = a0 * l0 + sum0;
      l1 = a1 * l1 + sum1;
    }

    // P terms: register r of k16 step kk of this warpgroup's keys packs
    // score elements 8 kk + 2 r and 8 kk + 2 r + 1 (the A-fragment layout);
    // the same words go to shared memory for the other warpgroup's P.V
    // (with 8 keys a half, KH = 0, only there)
    uint32_t pa[NS][KH > 0 ? KH : 1][4];
#pragma unroll
    for (int e = 0; e < HALF / 4; ++e) {
      const int kk = e >> 2, r = e & 3;
      uint32_t w[NS];
      split2<NS>(s[2 * e], s[2 * e + 1], scale, w);
      const int row = (r & 1) ? row1 : row0;
      const int key = wg * HALF + 16 * kk + 8 * (r >> 1) + 2 * t4;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if constexpr (KH > 0) pa[i][kk][r] = w[i];
        *reinterpret_cast<uint32_t*>(smem + L::p + i * L::P_TERM +
                                     core_offset(row, key >> 3, BKV / 8) +
                                     2 * (key & 7)) = w[i];
      }
    }
    fence_async_smem();
    bar_sync(B_CONS, CONSUMERS);   // both halves' P terms
    bar_sync(B_VFULL, THREADS);    // this tile's V terms are in

    // P.V: rescale each group's accumulator by alpha, add its products,
    // this warpgroup's k16 steps with A from registers, the other's (all,
    // at KH = 0) from shared memory
    const uint32_t pb = opaque(desc_lo(sbase + L::p));
    const uint32_t vb = opaque(desc_lo(sbase + L::v + wg * 8 * 128, L::V_LBO));
    const int own = wg * KH, oth = (1 - wg) * KH;   // first k16 step of each
#pragma unroll
    for (int g = 0; g < NS; ++g) {
      if (!single) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[g][e] = __fmul_rn(acc[g][e], (e & 2) ? a1 : a0);
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (i > g) break;
        const uint32_t va = vb + (((g - i) * L::V_TERM) >> 4);
        add_term_product<KV>(acc[g], f0, f1, [&](float(&f)[32], int kk) {
          if (KH > 0 && kk < KH) {
            wgmma_rs64(f, pa[i][kk],
                       desc(va + (((own + kk) * 2 * L::V_LBO) >> 4), L::V_SBO));
          } else {
            const int ko = oth + kk - KH;
            wgmma_ss64(f, desc(pb + ((i * L::P_TERM + ko * 256) >> 4), L::P_SBO),
                       desc(va + ((ko * 2 * L::V_LBO) >> 4), L::V_SBO));
          }
        });
      }
    }
    bar_arrive(B_VEMPTY, THREADS);   // the V terms may be overwritten
  }

  // the row sums of both warpgroups' keys; fold the P.V groups
  // smallest-first, divide by l, store valid rows
  if (!single) {
    if (t4 == 0) {
      red[2 * ROWS + wg * ROWS + row0] = l0;
      red[2 * ROWS + wg * ROWS + row1] = l1;
    }
    bar_sync(B_CONS, CONSUMERS);
    l0 = red[2 * ROWS + row0] + red[3 * ROWS + row0];
    l1 = red[2 * ROWS + row1] + red[3 * ROWS + row1];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? row1 : row0;
    const int rr = r / bq, qi = r % bq;
    if (qi >= nq || rr >= rep) continue;
    const float l = h ? l1 : l0;
    float* dst = out + (qrow0 + qi * qld + rr) * hdv + col0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * wg + 8 * i + 2 * t4;
      if (col0 + col >= hdv) continue;
      float o[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * i + 2 * h + c;
        o[c] = acc[NS - 1][e];
#pragma unroll
        for (int g = NS - 2; g >= 0; --g) o[c] = acc[g][e] + o[c] * inv;
        if (!single) o[c] = o[c] / fmaxf(l, 1e-30f);
      }
      *reinterpret_cast<float2*>(dst + col) = make_float2(o[0], o[1]);
    }
  }
}

template <int NS, int HDP>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* q_pos, const int* k_pos, float* out, int B,
                   int Hkv, int rep, int S, int T, int hd, int hdv, int causal,
                   int window, float softcap, float sm_denom, float scale,
                   float inv, cudaStream_t stream) {
  const size_t bytes = Tile<NS, HDP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      tcec_attention_kernel<NS, HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int bq = ROWS / rep;
  const int ncol = HDP == OUTW ? 1 : (hdv + OUTW - 1) / OUTW;
  dim3 grid(B * Hkv * ncol, (S + bq - 1) / bq);
  tcec_attention_kernel<NS, HDP><<<grid, THREADS, bytes, stream>>>(
      q, k, v, q_pos, k_pos, out, Hkv, rep, S, T, hd, hdv, causal, window,
      softcap, sm_denom, scale, inv);
  return cudaGetLastError();
}

// The head dim the kernel pads to: 128 or 256 for the larger of hd and
// hdv, 0 above 256.
int padded_head_dim(int head_dim) {
  return head_dim <= 128 ? 128 : head_dim <= HDMAX ? 256 : 0;
}

}  // namespace

extern "C" int tcec_attention_launch(const void* q, const void* k,
                                     const void* v, const void* q_pos,
                                     const void* k_pos, void* out, int B,
                                     int Hkv, int rep, int S, int T, int hd,
                                     int hdv, int causal, int window,
                                     float softcap, float sm_denom,
                                     int n_splits, int scale_bits,
                                     void* stream) {
  if (hd > HDMAX || hdv > HDMAX || hd % 4 || hdv % 4 || rep < 1 ||
      rep > ROWS)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) & 15)
    return cudaErrorMisalignedAddress;
  const float scale = ldexpf(1.0f, scale_bits);
  const float inv = ldexpf(1.0f, -scale_bits);
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = padded_head_dim(hd > hdv ? hd : hdv) == 256;
#define TCEC_LAUNCH(NS)                                                     \
  (wide ? launch<NS, 256>(Q, K, V, qp, kp, O, B, Hkv, rep, S, T, hd, hdv,   \
                          causal, window, softcap, sm_denom, scale, inv, s) \
        : launch<NS, 128>(Q, K, V, qp, kp, O, B, Hkv, rep, S, T, hd, hdv,   \
                          causal, window, softcap, sm_denom, scale, inv, s))
  switch (n_splits) {
    case 2: return TCEC_LAUNCH(2);
    case 3: return TCEC_LAUNCH(3);
    case 4: return TCEC_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef TCEC_LAUNCH
}

// Keys per K/V tile for n_splits terms at head dim head_dim (the larger of
// hd and hdv; 0 if not taken): the plain version tiles the keys the same
// way, and its wrapper checks that the two agree.
extern "C" int tcec_attention_key_tile(int n_splits, int head_dim) {
  const int hdp = padded_head_dim(head_dim);
  if (hdp == 0) return 0;
  const bool wide = hdp == 256;
  switch (n_splits) {
    case 2: return wide ? Tile<2, 256>::BKV : Tile<2, 128>::BKV;
    case 3: return wide ? Tile<3, 256>::BKV : Tile<3, 128>::BKV;
    case 4: return wide ? Tile<4, 256>::BKV : Tile<4, 128>::BKV;
    default: return 0;
  }
}

extern "C" const char* tcec_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
