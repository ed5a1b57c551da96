// TCEC paged decode attention: one query token per sequence slot against
// a bf16 KV cache kept in fixed-size pages of a shared pool.
//
// Replaces the TPU kernel
// src/repro/kernels/tcec_paged_attention.py::_paged_kernel, launched there
// by tcec_paged_attention_pallas.
//
// What bounds it on the H100: bytes.  Each slot reads its valid K and V
// tokens once (bf16), and does a few multiply-adds per byte read.
//
// What the design does about it: one block per (slot, kv head).  The block
// reads its own row of the block table and gathers the pages by index, so no
// gathered copy of the cache is ever written; every K and V element is read
// once, by neighbouring threads on neighbouring addresses.  rep (query heads
// per kv head, 2 for qwen3) is far below a tensor-core tile, so the products
// run on the CUDA cores.  The f32 query and the f32 probabilities are split
// into bf16 terms (their products with the bf16 cache are exact in f32); the
// cache is bf16-valued, so its own residual terms are exactly zero and only
// the products (i, 0) of each scale group i are formed.  Per-group sums are
// folded smallest-first, as in kernel 2, and the online softmax walks the
// pages in order.  Pages past the length or outside the window are skipped;
// inside a page, masking is a select (stale, possibly non-finite data in a
// recycled page is never read into a sum).  Rows with length <= 0 return 0.
//
// Simple first: one page per step and no cp.async; splitting a slot's pages
// across blocks needs a second reduction pass and is later work.
#include "tcec_common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps; thread d owns output column d
constexpr int MAX_REP = 8;
constexpr int MAX_PS = 64;
constexpr int HDMAX = 128;

template <int NS>
__global__ void __launch_bounds__(THREADS)
tcec_paged_attention_kernel(const float* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k_pages,
                            const __nv_bfloat16* __restrict__ v_pages,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, int Hkv, int rep, int hd,
                            int hdv, int ps, int maxp, int window,
                            float softcap, float sm_denom, float scale,
                            float inv) {
  __shared__ float qs[NS][MAX_REP][HDMAX];   // split query terms
  __shared__ float ss[MAX_REP][MAX_PS];      // scores of one page
  __shared__ float pst[NS][MAX_REP][MAX_PS]; // split probabilities
  __shared__ float m_s[MAX_REP], l_s[MAX_REP], a_s[MAX_REP];

  const int h = blockIdx.x, b = blockIdx.y;
  const long long bh = (long long)b * Hkv + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int length = lengths[b];
  const int cur = length - 1;            // position of the current token
  const int* table = block_tables + (long long)b * maxp;

  for (int idx = tid; idx < rep * HDMAX; idx += THREADS) {
    const int r = idx / HDMAX, d = idx % HDMAX;
    float t[NS];
    tcec::split_f32<NS>(d < hd ? q[(bh * rep + r) * hd + d] : 0.0f, scale, t);
#pragma unroll
    for (int i = 0; i < NS; ++i) qs[i][r][d] = t[i];
  }
  if (tid < MAX_REP) { m_s[tid] = tcec::NEG_INF; l_s[tid] = 0.0f; }

  float acc[NS][MAX_REP];
#pragma unroll
  for (int g = 0; g < NS; ++g)
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) acc[g][r] = 0.0f;
  const bool single = maxp == 1;

  for (int pg = 0; pg < maxp; ++pg) {
    const int col0 = pg * ps;
    // skip pages wholly past the length or wholly older than the window
    if (col0 >= length) continue;
    if (window > 0 && cur - (col0 + ps - 1) >= window) continue;
    const long long page = table[pg];
    __syncthreads();   // the previous page's readers of ss / pst are done

    // scores: warp w takes tokens w, w + 4, ...; lanes split head_dim
    for (int t = warp; t < ps; t += THREADS / 32) {
      const int pos = col0 + t;
      const bool ok = pos <= cur && (window <= 0 || cur - pos < window);
      if (!ok) {
        if (lane < rep) ss[lane][t] = tcec::NEG_INF;
        continue;
      }
      const __nv_bfloat16* krow = k_pages + ((page * ps + t) * Hkv + h) * hd;
      float kv[HDMAX / 32];
#pragma unroll
      for (int u = 0; u < HDMAX / 32; ++u) {
        const int d = lane + 32 * u;
        kv[u] = d < hd ? __bfloat162float(krow[d]) : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        float part[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float dot = 0.0f;
#pragma unroll
          for (int u = 0; u < HDMAX / 32; ++u) dot += qs[i][r][lane + 32 * u] * kv[u];
          part[i] = tcec::warp_sum(dot);
        }
        float s = part[NS - 1];
#pragma unroll
        for (int g = NS - 2; g >= 0; --g) s = part[g] + s * inv;
        s = s / sm_denom;
        if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
        if (lane == 0) ss[r][t] = s;
      }
    }
    __syncthreads();

    // online softmax over the page: warp w takes rows w, w + 4, ...
    for (int r = warp; r < rep; r += THREADS / 32) {
      const bool in0 = lane < ps, in1 = lane + 32 < ps;
      const float s0 = in0 ? ss[r][lane] : tcec::NEG_INF;
      const float s1 = in1 ? ss[r][lane + 32] : tcec::NEG_INF;
      const float m_curr = tcec::warp_max(fmaxf(s0, s1));
      float p0, p1;
      if (single) {
        p0 = in0 ? expf(s0 - m_curr) : 0.0f;
        p1 = in1 ? expf(s1 - m_curr) : 0.0f;
        const float sum = tcec::warp_sum(p0 + p1);
        p0 = p0 / sum;
        p1 = p1 / sum;
      } else {
        const float m_prev = m_s[r];
        const float m_next = fmaxf(m_prev, m_curr);
        const float alpha = expf(m_prev - m_next);
        p0 = in0 ? expf(s0 - m_next) : 0.0f;
        p1 = in1 ? expf(s1 - m_next) : 0.0f;
        const float l = alpha * l_s[r] + tcec::warp_sum(p0 + p1);
        __syncwarp();
        if (lane == 0) { m_s[r] = m_next; l_s[r] = l; a_s[r] = alpha; }
      }
      float t0[NS], t1[NS];
      tcec::split_f32<NS>(p0, scale, t0);
      tcec::split_f32<NS>(p1, scale, t1);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if (in0) pst[i][r][lane] = t0[i];
        if (in1) pst[i][r][lane + 32] = t1[i];
      }
    }
    __syncthreads();

    // P.V per scale group: thread d sums the valid tokens of the page
    if (tid < hdv) {
      float part[NS][MAX_REP];
#pragma unroll
      for (int g = 0; g < NS; ++g)
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) part[g][r] = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const int pos = col0 + t;
        if (pos > cur || (window > 0 && cur - pos >= window)) continue;
        const float vv = __bfloat162float(
            v_pages[((page * ps + t) * Hkv + h) * hdv + tid]);
#pragma unroll
        for (int g = 0; g < NS; ++g)
#pragma unroll
          for (int r = 0; r < MAX_REP; ++r)
            if (r < rep) part[g][r] += pst[g][r][t] * vv;
      }
#pragma unroll
      for (int g = 0; g < NS; ++g)
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r)
          if (r < rep)
            acc[g][r] = single ? acc[g][r] + part[g][r]
                               : acc[g][r] * a_s[r] + part[g][r];
    }
  }

  if (tid < hdv) {
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      float o = acc[NS - 1][r];
#pragma unroll
      for (int g = NS - 2; g >= 0; --g) o = acc[g][r] + o * inv;
      if (!single) o = o / fmaxf(l_s[r], 1e-30f);
      out[(bh * rep + r) * hdv + tid] = o;
    }
  }
}

template <int NS>
cudaError_t launch(const float* q, const __nv_bfloat16* kp,
                   const __nv_bfloat16* vp, const int* bt, const int* lens,
                   float* out, int B, int Hkv, int rep, int hd, int hdv, int ps,
                   int maxp, int window, float softcap, float sm_denom,
                   float scale, float inv, cudaStream_t stream) {
  dim3 grid(Hkv, B);
  tcec_paged_attention_kernel<NS><<<grid, THREADS, 0, stream>>>(
      q, kp, vp, bt, lens, out, Hkv, rep, hd, hdv, ps, maxp, window, softcap,
      sm_denom, scale, inv);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tcec_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, int B, int Hkv,
    int rep, int hd, int hdv, int ps, int maxp, int window, float softcap,
    float sm_denom, int n_splits, int scale_bits, void* stream) {
  if (hd > HDMAX || hdv > HDMAX || rep < 1 || rep > MAX_REP || ps < 1 ||
      ps > MAX_PS)
    return cudaErrorInvalidValue;
  const float scale = ldexpf(1.0f, scale_bits);
  const float inv = ldexpf(1.0f, -scale_bits);
  const float* Q = static_cast<const float*>(q);
  const __nv_bfloat16* KP = static_cast<const __nv_bfloat16*>(k_pages);
  const __nv_bfloat16* VP = static_cast<const __nv_bfloat16*>(v_pages);
  const int* BT = static_cast<const int*>(block_tables);
  const int* LN = static_cast<const int*>(lengths);
  float* O = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_splits) {
    case 2:
      return launch<2>(Q, KP, VP, BT, LN, O, B, Hkv, rep, hd, hdv, ps, maxp, window, softcap, sm_denom, scale, inv, s);
    case 3:
      return launch<3>(Q, KP, VP, BT, LN, O, B, Hkv, rep, hd, hdv, ps, maxp, window, softcap, sm_denom, scale, inv, s);
    case 4:
      return launch<4>(Q, KP, VP, BT, LN, O, B, Hkv, rep, hd, hdv, ps, maxp, window, softcap, sm_denom, scale, inv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* tcec_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
