// TCEC GEMM for Hopper: an f32-accurate matrix product from bf16
// tensor-core products, act(fold(sum_g acc_g) out_scale + bias), for 2-D and
// batched operands, B as (K, N) or read in place as (N, K) (trans_b), any M,
// N and K (masked, never padded), 2, 3 or 4 terms (x3, x6, x10).  B is read
// through a batch stride and a row stride, so any B whose rows are
// contiguous is read where it lies: a contiguous (K, N) or (N, K) tensor,
// and a per-head view of a weight stored (K, H, N) or (N, H, K) (MLA's
// absorbed products: batch stride N or K, row stride H N or H K).
//
// Replaces the TPU kernel src/repro/kernels/tcec_matmul.py::_kernel (:69,
// helper _split_tile), launched there by tcec_matmul_pallas (:208).
//
// The paper's rule, on both paths: every term product of every 16-deep step
// goes into a zeroed fragment (wgmma with scale-d = 0, mma.sync with C = 0)
// and is added with round-to-nearest f32 adds into the accumulator of its
// scale group i + j; no tensor-core chain runs across 16-deep steps or term
// products.  The groups are folded smallest-first at the end (out = acc_g +
// out 2^-s), then out_scale -> bias -> activation, before the one store.
// The f32 operands are split into their bf16 terms on chip; the terms never
// reach device memory.
//
// One C entry, tcec_matmul_launch, runs one of two paths: the one its path
// argument names (0 path S, 1 path W; the autotuner measures both), or by
// M alone (path -1):
//
// Path W (M > SKINNY_MAX_M, prefill): bound by operations.  x6 runs 6 bf16
//   products (989 TFLOP/s dense), and the rule's f32 adds cost as many SM
//   cycles: one m64n64k16 wgmma is 65,536 multiply-adds, 32 clocks of the
//   SM's tensor cores (2,048 a clock), and its 4,096-element fragment is 32
//   clocks of the SM's 128 f32 adds a clock.  So the adds must overlap the
//   next wgmma, and the consumers' other per-element work must stay small.
//   The design: a 128 x 64 block tile over 64-deep stages, 384 threads.
//   * A producer warpgroup (setmaxnreg 56) keeps two stages of f32 A and B
//     tiles (96 KB) in flight with cp.async (a ring of three) and splits
//     each stage's B into bf16 terms in shared memory, once per block: a
//     transposed B K-major, a (K, N) B MN-major (the transpose bit), as the
//     wgmma descriptor wants.  Two B term buffers: the consumers multiply
//     one while the producer fills the other (named barriers full / empty).
//   * Two consumer warpgroups (setmaxnreg 224), 64 rows x 64 columns each.
//     A comes from registers: each consumer thread splits its own f32 A
//     fragment of a 16-deep step (8 values, read conflict-free from the
//     staged tile) into its terms, once per block, and each A term serves
//     every product that takes it (x6: a0 three, a1 two).  The split runs
//     on the consumers because a single producer warpgroup that also split
//     A was latency bound and held the block back (measured: the producer
//     alone took 10.1 of 13.3 ms at the unembed); the consumers have two
//     warps a scheduler and independent work to hide it.  B terms are read
//     by wgmma from shared memory.  Two fragments alternate
//     (sm90::wgmma_pipeline), so one wgmma runs while the other is added.
//   * Registers a consumer thread, x6: 3 accumulators x 32, 2 fragments x 32,
//     the A terms of two 16-deep steps (2 x 3 x 4) = 184 plus the f32
//     values being split and addressing; x10 pipelines one 16-deep step at
//     a time: 128 + 64 + 16 = 208 (ptxas spills 8 bytes there, off the
//     main path).  A 64 x 96 warpgroup tile would need ~252 at x6 and does
//     not fit.
//   * Measured (scripts/kernel1_ablation.py): the wgmmas and the f32 adds
//     do not overlap, whatever is in flight, so the adds bound this path
//     at about 3x its tensor bound; everything else is kept off them.
//   * Shared memory: 3 f32 stages of 53 KB plus 2 B term buffers of NS x 8
//     KB: x3 191 KB, x6 207 KB, x10 223 KB; one block an SM.  Blocks walk M
//     fastest, so the M-blocks of one B tile run together and B comes from
//     device memory once.  Waves at qwen3-0.6b's prefills: 2 x 512 (M 1024)
//     gives 128, 256 and 384 blocks at N 1024, 2048, 3072 (1, 2 and 3
//     waves on 132 SMs) and 18,992 at the unembed; 2 x 208 (M 416) gives
//     64 blocks at N 1024, half a wave.
//
// Path S (M <= SKINNY_MAX_M; decode, where M is the number of slots, and
//   short prefills): bound by bytes.  The whole f32 weight is read from
//   device memory once (N K 4 bytes at 3.35 TB/s), so the roles are
//   swapped: C^T = B^T A^T with mma.sync.m16n8k16, the weight as the
//   16-row operand, 8 slots as the n8 operand.  A block owns 16 weight
//   rows (output columns) over all of K for one group of 8 slots: at M <= 8
//   N 1024 gives 64 blocks, the unembed 9,496.  Each further group of 8
//   slots adds a block a band, adjacent in the grid, so the band comes
//   from device memory once and from L2 after.  One n8 half a block keeps
//   the registers low enough for four blocks an SM with B^T, what its
//   shared memory allows (a block with two halves had three and lost 17 %
//   at the decode unembed).  The f32 weight band and the
//   block's f32 activations stream through a cp.async ring of four
//   128-deep stages (24 KB of weight in flight a block); each of the 8
//   warps takes 16 k of a stage, splits its fragments' f32 values in
//   registers and runs the kept products.  The warps' group accumulators
//   are summed in shared memory in a fixed order, so there is no
//   cross-block reduction, no atomic and no second kernel.  Both weight
//   layouts are read in place; the k order inside a 16-deep step is chosen
//   per layout so that shared-memory reads are conflict-free, the same for
//   weight and activations (a sum over k does not depend on it).
//
// The threshold: timed on the card (scripts/kernel1_ablation.py), path S
//   is the faster of the two on the sum of one qwen3-0.6b forward's
//   products up to M 64 and path W from M 96.  Each product's own crossing
//   lies between M 24-32 (the unembed, where path W fills the card) and
//   M 128-192 (o, down).  So the threshold is the rule of path -1 only:
//   the dispatcher passes the path that kernels/tuning.py measured fastest
//   for the product's shape bucket, or this rule where it did not measure.
#include <cstdint>
#include <mutex>
#include <type_traits>
#include <utility>
#include <vector>

#include "tcec_common.cuh"
#include "tcec_sm90.cuh"

namespace {

using namespace sm90;

// The path threshold: M up to this runs path S (see the note above).
constexpr int SKINNY_MAX_M = 64;

// Term product p of the triangular schedule, in group order: (0,0),
// (0,1), (1,0), (0,2), (1,1), (2,0), ...; its group g and A term i.  Plain
// expressions, so that an unrolled loop folds them into register indices.
__host__ __device__ constexpr int term_g(int p) {
  return p < 1 ? 0 : p < 3 ? 1 : p < 6 ? 2 : 3;
}
__host__ __device__ constexpr int term_i(int p) {
  return p - term_g(p) * (term_g(p) + 1) / 2;
}

typedef void (*Kernel)(const float*, const float*, const float*, float*, int,
                       int, int, long long, int, int, float, float, float,
                       int);

// The epilogue of one output element: fold, out_scale, bias, activation.
template <int NS, class Get>
__device__ __forceinline__ float finish(Get acc, float inv, float out_scale,
                                        const float* bias, int col,
                                        int activation) {
  float v = acc(NS - 1);
#pragma unroll
  for (int g = NS - 2; g >= 0; --g) v = acc(g) + v * inv;
  if (out_scale != 1.0f) v = v * out_scale;
  if (bias != nullptr) v = v + bias[col];
  return tcec::activate(v, activation);
}

// store(std::integral_constant<int, activation>): the activation as a
// compile-time constant, so that a loop of epilogues does not branch on it
// for every element.
template <class Store>
__device__ __forceinline__ void with_activation(int activation, Store store) {
  switch (activation) {
    case 1: store(std::integral_constant<int, 1>()); break;
    case 2: store(std::integral_constant<int, 2>()); break;
    case 3: store(std::integral_constant<int, 3>()); break;
    case 4: store(std::integral_constant<int, 4>()); break;
    default: store(std::integral_constant<int, 0>()); break;
  }
}

// ------------------------------------------------------------- path W

namespace wide {

constexpr int BM = 128, BN = 64, BK = 64;
constexpr int DEPTH = 3;               // f32 stages in the cp.async ring
constexpr int PRODUCER = 128, CONSUMERS = 256, THREADS = PRODUCER + CONSUMERS;
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
static_assert(PRODUCER * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <=
                  THREADS * (65536 / THREADS / 8 * 8),
              "the registers the block is launched with");
constexpr int LDA = BK + 8;            // f32 staging row of A (conflict-free fragments)
constexpr int LDT = BK + 4;            // f32 staging row of B^T
constexpr int LDB = BN + 4;            // f32 staging row of a (K, N) B
// named barriers: the B terms of buffer b are in (B_FULL + b); the
// consumers are done with a stage of parity b (B_EMPTY + b); the producers
// among themselves
enum : int { B_FULL = 1, B_EMPTY = 3, B_PROD = 5 };

template <int NS>
struct Layout {
  static constexpr int A_F32 = BM * LDA * 4;
  static constexpr int B_F32 = (BN * LDT > BK * LDB ? BN * LDT : BK * LDB) * 4;
  static constexpr int SLOT = A_F32 + B_F32;
  static constexpr int B_TERM = BK * BN * 2;
  static constexpr int BUF = NS * B_TERM;
  static constexpr size_t terms = DEPTH * SLOT;        // two B term buffers
  static constexpr size_t bytes = terms + 2 * BUF;
  static constexpr int NP = NS * (NS + 1) / 2;         // kept term products
  static constexpr int KSUB = NS == 4 ? 1 : 2;         // 16-deep steps a pipeline
  static_assert((KSUB * NP) % 2 == 0 && (BK / 16) % KSUB == 0, "pipeline");
};

// Split the staged f32 B tile (rows x 8 C8 columns) into NS term tiles of
// core matrices: item (row r, columns 8 c8..) with r % 8 fastest, so 8
// threads store one 128-byte core matrix.
template <int NS, int C8, int ROWS>
__device__ __forceinline__ void split_tile(const float* src, int ld,
                                           unsigned char* dst, float scale,
                                           int tid) {
  constexpr int ITEMS = ROWS * C8 / PRODUCER;
#pragma unroll 1
  for (int it = 0; it < ITEMS; ++it) {
    const int idx = tid + PRODUCER * it;
    const int r = ((idx / (8 * C8)) << 3) | (idx & 7), c8 = (idx >> 3) % C8;
    const float4 lo = *reinterpret_cast<const float4*>(src + r * ld + 8 * c8);
    const float4 hi = *reinterpret_cast<const float4*>(src + r * ld + 8 * c8 + 4);
    const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint4 t[NS];
    split8<NS>(x, scale, t);
#pragma unroll
    for (int i = 0; i < NS; ++i)
      *reinterpret_cast<uint4*>(dst + i * (BK * BN * 2) + core_offset(r, c8, C8)) = t[i];
  }
}

// Copy the ROWS x COLS f32 tile at (r0, c0) of a matrix (R, Cn) whose rows
// lie lds floats apart into a staging tile with rows ld floats apart; what
// lies outside is zero.
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src,
                                          int R, int Cn, long long lds, int r0,
                                          int c0, int vec, int tid) {
  if (vec) {
    // thread t copies 16-byte column t % CH of rows t / CH + STEP i
    constexpr int CH = COLS / 4, STEP = PRODUCER / CH;
    const int ch = tid % CH, r = tid / CH, gc = c0 + 4 * ch;
    const float* s = src + (r0 + r) * lds + gc;
    float* d = dst + r * ld + 4 * ch;
#pragma unroll
    for (int it = 0; it < ROWS / STEP; ++it) {
      const bool ok = r0 + r + STEP * it < R && gc < Cn;
      cp_async16_zfill(d + STEP * it * ld, ok ? s : src, ok ? 16 : 0);
      s += STEP * lds;
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < ROWS * COLS / PRODUCER; ++it) {
      const int c = tid + PRODUCER * it, r = c / COLS, e = c % COLS;
      const int gr = r0 + r, gc = c0 + e;
      const bool ok = gr < R && gc < Cn;
      cp_async4_zfill(dst + r * ld + e,
                      ok ? src + gr * lds + gc : src, ok ? 4 : 0);
    }
  }
}

// The producer warpgroup: keeps DEPTH - 1 stages of f32 A and B in flight
// and splits each stage's B into its terms; a ring slot is refilled once
// the consumers are done with the stage it held.
template <int NS, int TB>
__device__ __forceinline__ void produce(unsigned char* smem, const float* A,
                                        const float* B, int M, int N, int K,
                                        long long sb, int ldb, int vec,
                                        float scale) {
  using L = Layout<NS>;
  const int tid = threadIdx.x;
  const long long z = blockIdx.z;
  A += z * M * K;
  B += z * sb;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nst = (K + BK - 1) / BK;
  auto copy = [&](int s) {
    if (s < nst) {
      float* fa = reinterpret_cast<float*>(smem + (s % DEPTH) * L::SLOT);
      float* fb = fa + L::A_F32 / 4;
      const int k0 = s * BK;
      copy_tile<BM, BK>(fa, LDA, A, M, K, K, m0, k0, vec, tid);
      if (TB)
        copy_tile<BN, BK>(fb, LDT, B, N, K, ldb, n0, k0, vec, tid);
      else
        copy_tile<BK, BN>(fb, LDB, B, K, N, ldb, k0, n0, vec, tid);
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < DEPTH - 1; ++s) copy(s);
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<DEPTH - 2>();
    bar_sync(B_PROD, PRODUCER);   // stage s is in
    const float* fb = reinterpret_cast<const float*>(smem + (s % DEPTH) * L::SLOT + L::A_F32);
    unsigned char* tb = smem + L::terms + (s & 1) * L::BUF;   // free since stage s - 2
    if (TB)
      split_tile<NS, BK / 8, BN>(fb, LDT, tb, scale, tid);
    else
      split_tile<NS, BN / 8, BK>(fb, LDB, tb, scale, tid);
    fence_async_smem();
    bar_arrive(B_FULL + (s & 1), THREADS);
    // the consumers are done with stage s - 1: refill its slot
    if (s >= 1) bar_sync(B_EMPTY + ((s - 1) & 1), THREADS);
    copy(s + DEPTH - 1);
  }
  if (nst >= 1) bar_sync(B_EMPTY + ((nst - 1) & 1), THREADS);
}

// Register layout of an m64n64 accumulator in consumer warpgroup thread t
// (warp w = t / 32 % 4, lane l): element 4 i + 2 h + c sits at row 16 w +
// l / 4 + 8 h, column 8 i + 2 (l % 4) + c.  The A fragment of a 16-deep
// step holds rows 16 w + l / 4 (+ 8) at k 2 (l % 4) (+ 1) and + 8.
template <int NS, int TB>
__global__ void __launch_bounds__(THREADS, 1)
wide_kernel(const float* __restrict__ A, const float* __restrict__ B,
            const float* __restrict__ bias, float* __restrict__ C, int M,
            int N, int K, long long sb, int ldb, int vec, float scale,
            float inv, float out_scale, int activation) {
  using L = Layout<NS>;
  constexpr int NP = L::NP, KSUB = L::KSUB;
  extern __shared__ __align__(128) unsigned char smem[];
  // Nothing is computed before the roles split: a value live across
  // setmaxnreg would be spilled.
  if (threadIdx.x < PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    produce<NS, TB>(smem, A, B, M, N, K, sb, ldb, vec, scale);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int tid = threadIdx.x - PRODUCER, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, w = warp & 3;
  const int nst = (K + BK - 1) / BK;
  const uint32_t sbase = smem_addr(smem);
  // this thread's A-fragment words in a staged f32 A tile
  const int afrag = (64 * wg + 16 * w + (lane >> 2)) * LDA + 2 * (lane & 3);

  float acc[NS][32];
#pragma unroll
  for (int g = 0; g < NS; ++g)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[g][e] = 0.0f;
  float f0[32], f1[32];   // wgmma fragments
#pragma unroll
  for (int e = 0; e < 32; ++e) f0[e] = f1[e] = 0.0f;

  for (int s = 0; s < nst; ++s) {
    const int b = s & 1;
    bar_sync(B_FULL + b, THREADS);   // this stage's B terms are in
    const float* fa = reinterpret_cast<const float*>(smem + (s % DEPTH) * L::SLOT) + afrag;
    const uint32_t tb = sbase + L::terms + b * L::BUF;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ks += KSUB) {
      // the A terms of KSUB 16-deep steps, split in registers: register r
      // holds rows + 8 (r & 1) at k + 8 (r >> 1)
      uint32_t a[KSUB][NS][4];
#pragma unroll
      for (int q = 0; q < KSUB; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              fa + (r & 1) * 8 * LDA + 16 * (ks + q) + 8 * (r >> 1));
          uint32_t t[NS];
          split2<NS>(v.x, v.y, scale, t);
#pragma unroll
          for (int i = 0; i < NS; ++i) a[q][i][r] = t[i];
        }
      // B terms: K-major (LBO 128, 8 rows of N at BK / 8 core matrices)
      // for B^T; MN-major (8 rows of K at BN / 8 core matrices, 8 columns
      // at 128) for a (K, N) B
      const uint32_t bd = opaque(desc_lo(tb, TB ? 128 : BN / 8 * 128));
      wgmma_pipeline<KSUB * NP>(
          f0, f1,
          [&](float(&f)[32], int n) {
            const int q = n / NP, p = n % NP, i = term_i(p);
            const int j = term_g(p) - i, kk = ks + q;
            const uint32_t off = j * L::B_TERM + (TB ? kk * 256 : kk * 2 * BN / 8 * 128);
            wgmma_rs64<TB ? 0 : 1>(f, a[q][i], desc(bd + (off >> 4), TB ? BK / 8 * 128 : 128));
          },
          [&](const float(&f)[32], int n) {
            const int g = term_g(n % NP);
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[g][e] += f[e];
          });
    }
    bar_arrive(B_EMPTY + b, THREADS);   // the stage's slot and terms may be reused
  }

  const long long z = blockIdx.z;
  C += z * M * N;
  const int r0 = blockIdx.x * BM + 64 * wg + 16 * w + (lane >> 2);
  const int c0 = blockIdx.y * BN + 2 * (lane & 3);
  const bool pairs = N % 2 == 0;   // column pairs are 8-byte aligned
  with_activation(activation, [&](auto act) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h, col = c0 + 8 * i, e = 4 * i + 2 * h;
        if (row >= M) continue;
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          v[c] = col + c < N ? finish<NS>([&](int g) { return acc[g][e + c]; },
                                          inv, out_scale, bias, col + c,
                                          decltype(act)::value)
                             : 0.0f;
        float* dst = C + (long long)row * N + col;
        if (pairs && col + 1 < N) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          if (col < N) dst[0] = v[0];
          if (col + 1 < N) dst[1] = v[1];
        }
      }
  });
}

}  // namespace wide

// ------------------------------------------------------------- path S

namespace skinny {

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int BN = 16;                 // weight rows (output columns) a block
constexpr int BKS = 16 * WARPS;        // k a stage: 16 per warp
constexpr int DEPTH = 4;               // stages in the cp.async ring
constexpr int LDW_T = BKS + 16;        // staged (N, K) weight: a row of k
constexpr int LDW_N = 24;              // staged (K, N) weight: a row of 16 n
constexpr int LDX = BKS + 4;           // staged activations: a row of k
constexpr int SLOTS = 8;               // slots a block: the mma's n8

__host__ __device__ constexpr int weight_floats(int tb) {
  return tb ? BN * LDW_T : BKS * LDW_N;
}
__host__ __device__ constexpr int stage_floats(int tb, int M) {
  return weight_floats(tb) + M * LDX;
}
__host__ __device__ constexpr size_t smem_bytes(int tb, int M) {
  return size_t(DEPTH) * stage_floats(tb, M) * 4;
}
// Blocks an SM, to which the registers are capped (ptxas otherwise takes
// up to twice as many).  B^T: four, what the shared memory of 8 slots
// allows (53.8 KB a block).  A (K, N) B: two; its shared memory would allow
// three (66.0 KB a block), but x6 and x10 spill in 80 registers, and the
// decode gate measured within 2 % at two blocks and at three.
__host__ __device__ constexpr int min_blocks(int tb) { return tb ? 4 : 2; }
static_assert(min_blocks(1) * (smem_bytes(1, SLOTS) + 1024) <= 228 * 1024 &&
                  min_blocks(0) * (smem_bytes(0, SLOTS) + 1024) <= 228 * 1024,
              "the blocks an SM fit its shared memory");

// A block: weight rows n0.. (output columns) over all of K, for slots m0..
// m0 + 7.  mma fragments, lane l (g = l / 4, t = l % 4): the weight A
// operand holds rows g and g + 8 at positions 2t, 2t+1 (a0, a1) and 2t+8,
// 2t+9 (a2, a3); the slots' B operand holds slot g at the same positions;
// D holds rows g, g + 8 at slots 2t, 2t+1.  Positions map to the k of the
// warp's 16: B^T reads kw + 4t .. 4t+3 (one float4 a row), a (K, N) B reads
// kw + t + 4e, e = 0..3 (conflict-free columns with rows 24 floats apart).
template <int NS, int TB>
__global__ void __launch_bounds__(THREADS, min_blocks(TB))
skinny_kernel(const float* __restrict__ A, const float* __restrict__ B,
              const float* __restrict__ bias, float* __restrict__ C, int M,
              int N, int K, long long sb, int ldb, int vec, float scale,
              float inv, float out_scale, int activation) {
  constexpr int NP = NS * (NS + 1) / 2;
  constexpr int WF = weight_floats(TB);
  extern __shared__ __align__(128) float sm[];
  const long long z = blockIdx.y;
  // the blocks of one weight band are adjacent, one a group of slots
  const int groups = (M + SLOTS - 1) / SLOTS;
  const int m0 = SLOTS * (blockIdx.x % groups), MS = min(SLOTS, M - m0);
  A += (z * M + m0) * K;
  B += z * sb;
  C += (z * M + m0) * N;
  const int n0 = blockIdx.x / groups * BN, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int SF = stage_floats(TB, MS);
  const int nst = (K + BKS - 1) / BKS;

  auto copy = [&](int s) {
    if (s < nst) {
      float* w = sm + (s % DEPTH) * SF;
      float* x = w + WF;
      const int k0 = s * BKS;
      if (vec) {
        constexpr int CK = BKS / 4, CN = BN / 4;   // 16-byte chunks a row
        for (int c = tid; c < BN * BKS / 4; c += THREADS) {
          int gn, gk;
          float* dst;
          if (TB) {
            gn = n0 + c / CK, gk = k0 + 4 * (c % CK);
            dst = w + (c / CK) * LDW_T + 4 * (c % CK);
          } else {
            gk = k0 + c / CN, gn = n0 + 4 * (c % CN);
            dst = w + (c / CN) * LDW_N + 4 * (c % CN);
          }
          const bool ok = gn < N && gk < K;
          const float* src = TB ? B + (long long)gn * ldb + gk : B + (long long)gk * ldb + gn;
          cp_async16_zfill(dst, ok ? src : B, ok ? 16 : 0);
        }
        for (int c = tid; c < MS * CK; c += THREADS) {
          const int r = c / CK, gk = k0 + 4 * (c % CK);
          const bool ok = gk < K;
          cp_async16_zfill(x + r * LDX + 4 * (c % CK),
                           ok ? A + (long long)r * K + gk : A, ok ? 16 : 0);
        }
      } else {
        for (int c = tid; c < BN * BKS; c += THREADS) {
          int gn, gk;
          float* dst;
          if (TB) {
            gn = n0 + c / BKS, gk = k0 + c % BKS;
            dst = w + (c / BKS) * LDW_T + c % BKS;
          } else {
            gk = k0 + c / BN, gn = n0 + c % BN;
            dst = w + (c / BN) * LDW_N + c % BN;
          }
          const bool ok = gn < N && gk < K;
          const float* src = TB ? B + (long long)gn * ldb + gk : B + (long long)gk * ldb + gn;
          cp_async4_zfill(dst, ok ? src : B, ok ? 4 : 0);
        }
        for (int c = tid; c < MS * BKS; c += THREADS) {
          const int r = c / BKS, gk = k0 + c % BKS;
          const bool ok = gk < K;
          cp_async4_zfill(x + r * LDX + c % BKS,
                          ok ? A + (long long)r * K + gk : A, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) copy(s);
  const int kw = 16 * warp;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<DEPTH - 2>();
    __syncthreads();   // stage s is in; every warp is done with stage s - 1
    copy(s + DEPTH - 1);
    const float* w = sm + (s % DEPTH) * SF;
    const float* x = w + WF;
    // the weight fragment (rows g, g + 8) and its terms
    float wv[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (TB) {
        const float4 v = *reinterpret_cast<const float4*>(w + (g + 8 * r) * LDW_T + kw + 4 * t);
        wv[r][0] = v.x; wv[r][1] = v.y; wv[r][2] = v.z; wv[r][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[r][e] = w[(kw + t + 4 * e) * LDW_N + g + 8 * r];
      }
    }
    uint32_t wa[NS][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // a0: row g lo, a1: row g+8 lo, a2 / a3: hi
      uint32_t tw[NS];
      split2<NS>(wv[q & 1][2 * (q >> 1)], wv[q & 1][2 * (q >> 1) + 1], scale, tw);
#pragma unroll
      for (int i = 0; i < NS; ++i) wa[i][q] = tw[i];
    }
    // the slots' fragment (slot g) and its terms (slots past MS are zeros)
    float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (g < MS) {
      if (TB) {
        const float4 v = *reinterpret_cast<const float4*>(x + g * LDX + kw + 4 * t);
        xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) xv[e] = x[g * LDX + kw + t + 4 * e];
      }
    }
    uint32_t xb[NS][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t tx[NS];
      split2<NS>(xv[2 * q], xv[2 * q + 1], scale, tx);
#pragma unroll
      for (int i = 0; i < NS; ++i) xb[i][q] = tx[i];
    }
    // every kept term product into a zeroed fragment, added in f32
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int i = term_i(p), gg = term_g(p);
      float d[4];
      mma16816(d, wa[gg - i], xb[i]);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[gg][c] += d[c];
    }
  }

  // sum the warps' group accumulators in warp order, then fold and store
  cp_async_wait<0>();
  __syncthreads();
  float* red = sm;   // [warp][group][c][lane]
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[((warp * NS + i) * 4 + c) * 32 + lane] = acc[i][c];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m = 2 * t + (c & 1), col = n0 + g + 8 * (c >> 1);
    if (m >= MS || col >= N) continue;
    float sum[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sum[i] = 0.0f;
      for (int v = 0; v < WARPS; ++v)
        sum[i] += red[((v * NS + i) * 4 + c) * 32 + lane];
    }
    C[(long long)m * N + col] = finish<NS>([&](int i) { return sum[i]; }, inv,
                                           out_scale, bias, col, activation);
  }
}

static_assert(WARPS * 4 * 4 * 32 <= DEPTH * weight_floats(1),
              "the warps' sums fit in the ring");

}  // namespace skinny

// ------------------------------------------------------------- dispatch

struct Plan {
  Kernel kernel;
  dim3 grid;
  int threads;
  size_t bytes;
  size_t max_bytes;   // the most dynamic shared memory the kernel takes
};

// Allow the kernel its shared memory, once per kernel and device.
cudaError_t prepare(const Plan& p) {
  static std::mutex mu;
  static std::vector<std::pair<Kernel, int>> done;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == p.kernel && d.second == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p.max_bytes));
  if (err == cudaSuccess) done.emplace_back(p.kernel, dev);
  return err;
}

// path: 0 path S, 1 path W, -1 by M (path S up to SKINNY_MAX_M).
template <int NS>
Plan plan_for(int M, int N, int batch, int tb, int path) {
  if (path < 0 ? M <= SKINNY_MAX_M : path == 0) {
    using namespace skinny;
    Kernel k = tb ? skinny_kernel<NS, 1> : skinny_kernel<NS, 0>;
    const int groups = (M + SLOTS - 1) / SLOTS;
    return {k, dim3(groups * ((N + BN - 1) / BN), batch), THREADS,
            smem_bytes(tb, M < SLOTS ? M : SLOTS), smem_bytes(tb, SLOTS)};
  }
  Kernel k = tb ? wide::wide_kernel<NS, 1> : wide::wide_kernel<NS, 0>;
  return {k,
          dim3((M + wide::BM - 1) / wide::BM, (N + wide::BN - 1) / wide::BN, batch),
          wide::THREADS, wide::Layout<NS>::bytes, wide::Layout<NS>::bytes};
}

Plan plan(int M, int N, int batch, int tb, int n_splits, int path) {
  if (path < -1 || path > 1) return {nullptr, dim3(), 0, 0, 0};
  switch (n_splits) {
    case 2: return plan_for<2>(M, N, batch, tb, path);
    case 3: return plan_for<3>(M, N, batch, tb, path);
    case 4: return plan_for<4>(M, N, batch, tb, path);
    default: return {nullptr, dim3(), 0, 0, 0};
  }
}

}  // namespace

// B's element (z, k, n) lies at b[z sb + k ldb + n], or with trans_b at
// b[z sb + n ldb + k]: a contiguous B has ldb N (K with trans_b) and sb K N.
extern "C" int tcec_matmul_launch(const void* a, const void* b,
                                  const void* bias, void* c, int batch, int M,
                                  int N, int K, int trans_b, long long sb,
                                  int ldb, int n_splits, int scale_bits,
                                  float out_scale, int activation,
                                  int path, void* stream) {
  const Plan p = plan(M, N, batch, trans_b, n_splits, path);
  if (p.kernel == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = prepare(p);
  if (err != cudaSuccess) return err;
  // 16-byte copies need every row of A and B to start 16-byte aligned
  const int vec = K % 4 == 0 && (trans_b || N % 4 == 0) && ldb % 4 == 0 &&
                  sb % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  p.kernel<<<p.grid, p.threads, p.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<float*>(c), M, N, K, sb,
      ldb, vec, ldexpf(1.0f, scale_bits), ldexpf(1.0f, -scale_bits),
      out_scale, activation);
  return cudaGetLastError();
}

// The largest M that takes path S (decode); larger M takes path W.
extern "C" int tcec_matmul_skinny_max() { return SKINNY_MAX_M; }

// The grid of a launch: out[0] blocks, out[1] blocks resident an SM.
extern "C" int tcec_matmul_grid(int M, int N, int batch, int trans_b,
                                int n_splits, int path, int* out) {
  const Plan p = plan(M, N, batch, trans_b, n_splits, path);
  if (p.kernel == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = prepare(p);
  if (err != cudaSuccess) return err;
  out[0] = p.grid.x * p.grid.y * p.grid.z;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], p.kernel,
                                                       p.threads, p.bytes);
}

extern "C" const char* tcec_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
