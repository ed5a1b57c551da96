// TCEC GEMM: an f32-accurate matrix product from bf16 tensor-core products.
//
// Replaces the TPU kernel src/repro/kernels/tcec_matmul.py::_kernel (helper
// _split_tile), launched there by tcec_matmul_pallas.
//
// What bounds it on the H100: a policy with P kept products does P bf16
// tensor-core products per output tile, so large products are bound by
// operations (P x 2MNK at 989 TFLOP/s); the decode-time products (M = a few
// slots) read the whole f32 weight once and are bound by bytes (3.35 TB/s).
//
// What the design does about it: the f32 A and B tiles are read from device
// memory once, like an SGEMM, and split into their bf16 terms as they are
// stored to shared memory, so the split terms never reach device memory.
// Each 16x16x16 product of two terms goes into a zeroed wmma fragment and is
// added element by element, in f32 with round-to-nearest, into the
// accumulator of its scale group i+j (the paper's Code 3,
// frag_c.x[i] += frag_dc.x[i]): the sums run outside the tensor core's
// truncating accumulation chain.  One accumulator set per group (2, 3 or 4),
// folded smallest-first on the last K step, then out_scale -> bias ->
// activation, all before the single f32 store.  Ragged M, N and K are masked
// on load (zero terms add exact zeros) and on store, so nothing is padded.
//
// Simple first: wmma (mma.sync); the next tile is prefetched into registers
// while the current one is multiplied.  wgmma, TMA and a cp.async pipeline
// are later work.
#include <mma.h>

#include "tcec_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;   // 8 warps: 2 along M (32 rows) x 4 along N (16 cols)
constexpr int LDA = BK + 8;    // bf16 elements per row of an A term tile
constexpr int LDB = BN + 8;    // bf16 elements per row of a B term tile
constexpr int LDC = BN + 4;    // f32 elements per row of the output staging tile

template <int NS>
struct Smem {
  static constexpr int kTiles = NS * (BM * LDA + BK * LDB) * 2;  // bytes
  static constexpr int kStage = BM * LDC * 4;
  static constexpr int kBytes = kTiles > kStage ? kTiles : kStage;
};

template <int NS>
__global__ void __launch_bounds__(THREADS)
tcec_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, float* __restrict__ C,
                   int M, int N, int K, int trans_b, float scale, float inv,
                   float out_scale, int activation) {
  __shared__ __align__(128) unsigned char smem[Smem<NS>::kBytes];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);   // [NS][BM][LDA]
  __nv_bfloat16* Bs = As + NS * BM * LDA;                       // [NS][BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                   // [BM][LDC]

  const long long batch = blockIdx.z;
  A += batch * (long long)M * K;
  B += batch * (long long)K * N;
  C += batch * (long long)M * N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 4) * 32;   // warp's first row in the tile
  const int wn = (warp % 4) * 16;   // warp's first column in the tile

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NS][2];
#pragma unroll
  for (int g = 0; g < NS; ++g)
#pragma unroll
    for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[g][f], 0.0f);

  // The next tile's f32 values are fetched into registers before the
  // products of the current tile are issued, so the global-load latency
  // overlaps the tensor-core work; they are split into shared memory after.
  float ra[BM * BK / THREADS], rb[BK * BN / THREADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      // A: row-major, consecutive threads on consecutive k
      const int idx = tid + e * THREADS;
      const int gm = m0 + idx / BK, gk = k0 + idx % BK;
      ra[e] = (gm < M && gk < K) ? A[(long long)gm * K + gk] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      // B: (K, N) row-major, or (N, K) row-major when trans_b; consecutive
      // threads on the contiguous dimension either way
      const int idx = tid + e * THREADS;
      const int r = trans_b ? idx % BK : idx / BN;
      const int c = trans_b ? idx / BK : idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      float x = 0.0f;
      if (gk < K && gn < N)
        x = trans_b ? B[(long long)gn * K + gk] : B[(long long)gk * N + gn];
      rb[e] = x;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int e = 0; e < BM * BK / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      __nv_bfloat16 t[NS];
      tcec::split_bf16<NS>(ra[e], scale, t);
#pragma unroll
      for (int i = 0; i < NS; ++i) As[(i * BM + idx / BK) * LDA + idx % BK] = t[i];
    }
#pragma unroll
    for (int e = 0; e < BK * BN / THREADS; ++e) {
      const int idx = tid + e * THREADS;
      const int r = trans_b ? idx % BK : idx / BN;
      const int c = trans_b ? idx / BK : idx % BN;
      __nv_bfloat16 t[NS];
      tcec::split_bf16<NS>(rb[e], scale, t);
#pragma unroll
      for (int i = 0; i < NS; ++i) Bs[(i * BK + r) * LDB + c] = t[i];
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[NS][2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int f = 0; f < 2; ++f)
          wmma::load_matrix_sync(af[i][f], As + (i * BM + wm + f * 16) * LDA + kk, LDA);
        wmma::load_matrix_sync(bf[i], Bs + (i * BK + kk) * LDB + wn, LDB);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f) {
        // triangular schedule: group g holds the products (i, g - i)
#pragma unroll
        for (int g = 0; g < NS; ++g) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> part, prod;
          wmma::fill_fragment(part, 0.0f);
#pragma unroll
          for (int i = 0; i <= g; ++i) {
            wmma::fill_fragment(prod, 0.0f);
            wmma::mma_sync(prod, af[i][f], bf[g - i], prod);
#pragma unroll
            for (int e = 0; e < part.num_elements; ++e) part.x[e] += prod.x[e];
          }
          // f32 round-to-nearest add, outside the tensor core (Code 3)
#pragma unroll
          for (int e = 0; e < part.num_elements; ++e) acc[g][f].x[e] += part.x[e];
        }
      }
    }
    __syncthreads();
  }

  // fold the scale groups smallest-first: out = acc_g + out * 2^-s
#pragma unroll
  for (int f = 0; f < 2; ++f) {
#pragma unroll
    for (int g = NS - 2; g >= 0; --g)
#pragma unroll
      for (int e = 0; e < acc[g][f].num_elements; ++e)
        acc[NS - 1][f].x[e] = acc[g][f].x[e] + acc[NS - 1][f].x[e] * inv;
    wmma::store_matrix_sync(Cs + (wm + f * 16) * LDC + wn, acc[NS - 1][f], LDC,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // epilogue: out_scale -> bias -> activation, masked store
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    float v = Cs[r * LDC + c];
    if (out_scale != 1.0f) v = v * out_scale;
    if (bias != nullptr) v = v + bias[gn];
    C[(long long)gm * N + gn] = tcec::activate(v, activation);
  }
}

template <int NS>
cudaError_t launch(const float* a, const float* b, const float* bias, float* c,
                   int batch, int M, int N, int K, int trans_b, float scale,
                   float inv, float out_scale, int activation,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  tcec_matmul_kernel<NS><<<grid, THREADS, 0, stream>>>(
      a, b, bias, c, M, N, K, trans_b, scale, inv, out_scale, activation);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tcec_matmul_launch(const void* a, const void* b,
                                  const void* bias, void* c, int batch, int M,
                                  int N, int K, int trans_b, int n_splits,
                                  int scale_bits, float out_scale,
                                  int activation, void* stream) {
  const float scale = ldexpf(1.0f, scale_bits);
  const float inv = ldexpf(1.0f, -scale_bits);
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  const float* bs = static_cast<const float*>(bias);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_splits) {
    case 2:
      return launch<2>(A, B, bs, C, batch, M, N, K, trans_b, scale, inv, out_scale, activation, s);
    case 3:
      return launch<3>(A, B, bs, C, batch, M, N, K, trans_b, scale, inv, out_scale, activation, s);
    case 4:
      return launch<4>(A, B, bs, C, batch, M, N, K, trans_b, scale, inv, out_scale, activation, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* tcec_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
