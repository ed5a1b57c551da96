// TCEC flash attention (prefill): softmax(QK^T / sqrt(hd)) V with both
// products split into bf16 terms and accumulated per scale group in f32.
//
// Replaces the TPU kernel src/repro/kernels/tcec_attention.py::_attn_kernel
// (helpers _tcec_product and _pv_parts), launched there by
// tcec_attention_pallas.
//
// What bounds it on the H100: operations.  A policy with P kept products
// runs P bf16 tensor-core products for QK^T and P for PV, over the causal
// half of the (S, T) pairs; the f32 Q, K and V are read once per q block.
//
// What the design does about it: one block per (batch, kv head, block of
// 64 query rows = rep heads x 64/rep positions), so GQA reads each K/V tile
// once for all rep query heads of the group.  The block walks the K/V blocks
// of 32 keys itself (the TPU's sequential grid axis becomes a loop) and
// skips blocks that the causal mask or the window kills for every (q, k)
// pair.  Q, K, V and P are split into their bf16 terms as they are staged
// in shared memory; the (S, T) scores and probabilities never reach device
// memory.  Every 16x16x16 term product goes into a zeroed wmma fragment and
// is added in f32 outside the tensor core.  QK^T folds its scale groups at
// once (head_dim is whole in the block); scale, tanh softcap and the additive
// -2e38 mask follow, then the online softmax (running max m and sum l in
// shared memory).  P.V is accumulated per scale group in registers, each
// group rescaled by exp(m_old - m_new), and folded smallest-first at the
// end, divided by l.  With a single K/V block the probabilities are
// normalized before P.V, the exact operation order of the JAX kernel's
// single-block branch.
//
// Simple first: wmma with synchronous staging; wgmma, TMA and cp.async
// double buffering are later work.
#include <climits>
#include <mma.h>

#include "tcec_common.cuh"

using namespace nvcuda;

namespace {

constexpr int ROWS = 64;      // query rows per block (rep * positions)
constexpr int BKV = 32;       // keys per K/V block (one per lane in softmax)
constexpr int HDMAX = 128;    // largest head_dim taken
constexpr int THREADS = 256;  // 8 warps
constexpr int LDQ = HDMAX + 8;
constexpr int LDP = BKV + 8;
constexpr int LDS = BKV + 4;
constexpr int LDT = HDMAX + 4;
constexpr int ACC = ROWS * HDMAX / THREADS;   // output elements per thread

template <int NS>
struct Layout {
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(__nv_bfloat16) * NS * ROWS * LDQ;
  static constexpr size_t v = k + sizeof(__nv_bfloat16) * NS * BKV * LDQ;
  static constexpr size_t p = v + sizeof(__nv_bfloat16) * NS * BKV * LDQ;
  static constexpr size_t s = p + sizeof(__nv_bfloat16) * NS * ROWS * LDP;
  static constexpr size_t t = s + sizeof(float) * ROWS * LDS;
  static constexpr size_t stats = t + sizeof(float) * ROWS * LDT;
  static constexpr size_t pos = stats + sizeof(float) * 3 * ROWS;
  static constexpr size_t bytes = pos + sizeof(int) * (ROWS + BKV + 4);
};

using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void add_to(Acc& dst, const Acc& src) {
#pragma unroll
  for (int e = 0; e < dst.num_elements; ++e) dst.x[e] += src.x[e];
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

template <int NS>
__global__ void __launch_bounds__(THREADS)
tcec_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ q_pos,
                      const int* __restrict__ k_pos, float* __restrict__ out,
                      int Hkv, int rep, int S, int T, int hd, int hdv,
                      int causal, int window, float softcap, float sm_denom,
                      float scale, float inv) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Layout<NS>;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* St = reinterpret_cast<float*>(smem + L::t);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  int* qpos_s = reinterpret_cast<int*>(smem + L::pos);
  int* kpos_s = qpos_s + ROWS;
  int* misc = kpos_s + BKV;   // qmin, qmax, run

  const int bq = ROWS / rep;
  const int q0 = blockIdx.x * bq;
  const long long bh = (long long)blockIdx.z * Hkv + blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd16 = (hd + 15) & ~15, hdv16 = (hdv + 15) & ~15;
  const int nq = min(bq, S - q0);

  // stage Q (row r = head r / bq of the group, position q0 + r % bq)
  for (int idx = tid; idx < ROWS * hd16; idx += THREADS) {
    const int r = idx / hd16, d = idx % hd16;
    const int rr = r / bq, qi = r % bq;
    float x = 0.0f;
    if (qi < nq && d < hd) x = q[((bh * rep + rr) * S + q0 + qi) * hd + d];
    __nv_bfloat16 t[NS];
    tcec::split_bf16<NS>(x, scale, t);
#pragma unroll
    for (int i = 0; i < NS; ++i) Qs[(i * ROWS + r) * LDQ + d] = t[i];
  }
  if (tid < ROWS) {
    qpos_s[tid] = q_pos[q0 + min(tid % bq, nq - 1)];
    m_s[tid] = tcec::NEG_INF;
    l_s[tid] = 0.0f;
  }
  if (warp == 0) {
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = lane; i < nq; i += 32) {
      lo = min(lo, q_pos[q0 + i]);
      hi = max(hi, q_pos[q0 + i]);
    }
    lo = warp_min_int(lo);
    hi = warp_max_int(hi);
    if (lane == 0) { misc[0] = lo; misc[1] = hi; }
  }

  float acc[NS][ACC];
#pragma unroll
  for (int g = 0; g < NS; ++g)
#pragma unroll
    for (int e = 0; e < ACC; ++e) acc[g][e] = 0.0f;

  const int nkb = (T + BKV - 1) / BKV;
  const bool single = nkb == 1;

  for (int kb = 0; kb < nkb; ++kb) {
    const int col0 = kb * BKV;
    const int nk = min(BKV, T - col0);
    __syncthreads();   // the previous block's readers are done
    if (warp == 0) {
      const int kp = lane < nk ? k_pos[col0 + lane] : 0;
      const int kmin = warp_min_int(lane < nk ? kp : INT_MAX);
      const int kmax = warp_max_int(lane < nk ? kp : INT_MIN);
      kpos_s[lane] = kp;
      if (lane == 0) {
        // skip a block masked for every (q, k) pair: it adds no mass
        bool run = !causal || misc[1] >= kmin;
        run = run && (window <= 0 || misc[0] - kmax < window);
        misc[2] = run;
      }
    }
    __syncthreads();
    if (!misc[2]) continue;

    for (int idx = tid; idx < BKV * hd16; idx += THREADS) {
      const int c = idx / hd16, d = idx % hd16;
      const float x = (c < nk && d < hd) ? k[(bh * T + col0 + c) * hd + d] : 0.0f;
      __nv_bfloat16 t[NS];
      tcec::split_bf16<NS>(x, scale, t);
#pragma unroll
      for (int i = 0; i < NS; ++i) Ks[(i * BKV + c) * LDQ + d] = t[i];
    }
    for (int idx = tid; idx < BKV * hdv16; idx += THREADS) {
      const int c = idx / hdv16, d = idx % hdv16;
      const float x = (c < nk && d < hdv) ? v[(bh * T + col0 + c) * hdv + d] : 0.0f;
      __nv_bfloat16 t[NS];
      tcec::split_bf16<NS>(x, scale, t);
#pragma unroll
      for (int i = 0; i < NS; ++i) Vs[(i * BKV + c) * LDQ + d] = t[i];
    }
    __syncthreads();

    // scores: warp w computes the 16x16 tile (w / 2, w % 2) of the 64x32 block
    {
      const int fm = warp >> 1, fn = warp & 1;
      Acc sfr, part, pair, prod;
#pragma unroll
      for (int g = NS - 1; g >= 0; --g) {
        wmma::fill_fragment(part, 0.0f);
#pragma unroll
        for (int i = 0; i <= g; ++i) {
          const int j = g - i;
          wmma::fill_fragment(pair, 0.0f);
          for (int kk = 0; kk < hd16; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
            wmma::load_matrix_sync(af, Qs + (i * ROWS + fm * 16) * LDQ + kk, LDQ);
            wmma::load_matrix_sync(bf, Ks + (j * BKV + fn * 16) * LDQ + kk, LDQ);
            wmma::fill_fragment(prod, 0.0f);
            wmma::mma_sync(prod, af, bf, prod);
            add_to(pair, prod);
          }
          add_to(part, pair);
        }
        // fold smallest-first: s = part_g + s * 2^-s
        if (g == NS - 1) {
          sfr = part;
        } else {
#pragma unroll
          for (int e = 0; e < sfr.num_elements; ++e) sfr.x[e] = part.x[e] + sfr.x[e] * inv;
        }
      }
      wmma::store_matrix_sync(Ss + fm * 16 * LDS + fn * 16, sfr, LDS, wmma::mem_row_major);
    }
    __syncthreads();

    // scale, softcap, mask, online softmax: warp w owns rows 8w..8w+7, lane = key
    for (int i8 = 0; i8 < ROWS / 8; ++i8) {
      const int r = warp * (ROWS / 8) + i8;
      float s = Ss[r * LDS + lane] / sm_denom;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
      const int d = qpos_s[r] - kpos_s[lane];
      bool ok = lane < nk;
      if (causal) ok = ok && d >= 0;
      if (window > 0) ok = ok && d < window;
      s = s + (ok ? 0.0f : tcec::NEG_INF);
      float p;
      if (single) {
        const float m = tcec::warp_max(s);
        p = expf(s - m);
        p = p / tcec::warp_sum(p);
      } else {
        const float m_prev = m_s[r];
        const float m_next = fmaxf(m_prev, tcec::warp_max(s));
        const float alpha = expf(m_prev - m_next);
        p = expf(s - m_next);
        const float l = alpha * l_s[r] + tcec::warp_sum(p);
        __syncwarp();
        if (lane == 0) { m_s[r] = m_next; l_s[r] = l; a_s[r] = alpha; }
      }
      __nv_bfloat16 t[NS];
      tcec::split_bf16<NS>(p, scale, t);
#pragma unroll
      for (int i = 0; i < NS; ++i) Ps[(i * ROWS + r) * LDP + lane] = t[i];
    }
    __syncthreads();

    // P.V per scale group: tensor-core tiles to St, then the per-row rescale
    const int nf = 4 * (hdv16 / 16);
#pragma unroll
    for (int g = 0; g < NS; ++g) {
      for (int f = warp; f < nf; f += THREADS / 32) {
        const int fm = f & 3, fn = f >> 2;
        Acc part, pair, prod;
        wmma::fill_fragment(part, 0.0f);
#pragma unroll
        for (int i = 0; i <= g; ++i) {
          const int j = g - i;
          wmma::fill_fragment(pair, 0.0f);
#pragma unroll
          for (int kk = 0; kk < BKV; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
            wmma::load_matrix_sync(af, Ps + (i * ROWS + fm * 16) * LDP + kk, LDP);
            wmma::load_matrix_sync(bf, Vs + (j * BKV + kk) * LDQ + fn * 16, LDQ);
            wmma::fill_fragment(prod, 0.0f);
            wmma::mma_sync(prod, af, bf, prod);
            add_to(pair, prod);
          }
          add_to(part, pair);
        }
        wmma::store_matrix_sync(St + fm * 16 * LDT + fn * 16, part, LDT, wmma::mem_row_major);
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        const int idx = tid + THREADS * e;
        const int r = idx / HDMAX, c = idx % HDMAX;
        const float pv = c < hdv16 ? St[r * LDT + c] : 0.0f;
        acc[g][e] = single ? acc[g][e] + pv : acc[g][e] * a_s[r] + pv;
      }
      __syncthreads();
    }
  }

  // fold the P.V groups smallest-first, divide by l, store valid rows
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    const int idx = tid + THREADS * e;
    const int r = idx / HDMAX, c = idx % HDMAX;
    const int rr = r / bq, qi = r % bq;
    if (qi >= nq || c >= hdv) continue;
    float o = acc[NS - 1][e];
#pragma unroll
    for (int g = NS - 2; g >= 0; --g) o = acc[g][e] + o * inv;
    if (!single) o = o / fmaxf(l_s[r], 1e-30f);
    out[((bh * rep + rr) * S + q0 + qi) * hdv + c] = o;
  }
}

template <int NS>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* q_pos, const int* k_pos, float* out, int B,
                   int Hkv, int rep, int S, int T, int hd, int hdv, int causal,
                   int window, float softcap, float sm_denom, float scale,
                   float inv, cudaStream_t stream) {
  const size_t bytes = Layout<NS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      tcec_attention_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int bq = ROWS / rep;
  dim3 grid((S + bq - 1) / bq, Hkv, B);
  tcec_attention_kernel<NS><<<grid, THREADS, bytes, stream>>>(
      q, k, v, q_pos, k_pos, out, Hkv, rep, S, T, hd, hdv, causal, window,
      softcap, sm_denom, scale, inv);
  return cudaGetLastError();
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
  if (hd > HDMAX || hdv > HDMAX || rep < 1 || ROWS % rep != 0)
    return cudaErrorInvalidValue;
  const float scale = ldexpf(1.0f, scale_bits);
  const float inv = ldexpf(1.0f, -scale_bits);
  const float* Q = static_cast<const float*>(q);
  const float* K = static_cast<const float*>(k);
  const float* V = static_cast<const float*>(v);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_splits) {
    case 2:
      return launch<2>(Q, K, V, qp, kp, O, B, Hkv, rep, S, T, hd, hdv, causal, window, softcap, sm_denom, scale, inv, s);
    case 3:
      return launch<3>(Q, K, V, qp, kp, O, B, Hkv, rep, S, T, hd, hdv, causal, window, softcap, sm_denom, scale, inv, s);
    case 4:
      return launch<4>(Q, K, V, qp, kp, O, B, Hkv, rep, S, T, hd, hdv, causal, window, softcap, sm_denom, scale, inv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* tcec_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
