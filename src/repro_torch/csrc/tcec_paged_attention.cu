// TCEC paged decode attention: one query token per sequence slot against
// a bf16 or f32 KV cache kept in fixed-size pages of a shared pool.
//
// Replaces the TPU kernel
// src/repro/kernels/tcec_paged_attention.py::_paged_kernel, launched there
// by tcec_paged_attention_pallas.
//
// What bounds it on the H100: bytes.  Each slot reads its valid K and V
// tokens once (bf16): per token and kv head 2 (hd + hdv) bytes against
// rep x NS (hd + hdv) multiply-adds of the kept (i, 0) products, 3 a byte at
// rep 2 and x6, below the card's f32 ridge of about 10.
//
// Design: split-KV ("flash decoding").  The wrapper's rule
// (kernels/tcec_paged_attention.py::chunk_pages) cuts each slot's block
// table into chunks of C pages, as many as fit 32 KB of K and V (C 4 at
// pages of 16 and hd 128); the grid is (chunks, kv heads, slots).  A block
// whose chunk holds no valid token (past the length, or wholly outside the
// window) writes an empty partial and returns.  A live block reads its C
// table entries once (together with the length and the query), turns them
// into one pool row a token, then issues every K and V row of the chunk at
// once as 16-byte cp.async copies (neighbouring threads on neighbouring
// addresses) in two commit groups, K first, and splits the query while
// they land; it computes the scores as soon as K is in, while V is still
// landing.  Rows past the current token or outside the window are
// zero-filled by the copy's source size (their page numbers are never
// used) and their scores selected to NEG_INF, so stale, possibly
// non-finite data in a recycled page never enters a product.
//
// Products on the tensor cores, with mma.sync (m16n8k16, bf16): the f32
// query and probabilities are split into bf16 terms (exact products with
// the bf16 cache, whose own residual terms are zero, so only the (i, 0)
// products of each scale group i are formed).  Scores: a warp takes 16
// tokens of K (ldmatrix from rows padded by 16 bytes, conflict-free)
// against the rep x NS query-term columns; P.V: a warp takes 16 output
// columns of V (ldmatrix .trans) against the rep x NS probability-term rows.
// Every k16 step of every product goes into a zeroed fragment and is added
// in f32 into its scale group (the paper's rule, as in kernels 1 and 2).
// Each live block writes its partial (row max m, sum l and one f32
// accumulator per scale group) to a workspace; a second kernel, one block
// per (kv head, slot), combines the live chunks in chunk order without
// atomics (M = max m_j, w_j = exp(m_j - M), acc_g = sum w_j acc_g,j,
// l = sum w_j l_j), folds the groups smallest-first, divides by
// max(l, 1e-30) and writes the output; it runs a block for each 256 of a
// slot's rep x hdv outputs.  With a single chunk the first
// kernel writes the output itself.  At maxp == 1 the probabilities are
// normalised before P.V (the JAX kernel's one-step branch).  Rows with
// length <= 0 return 0.
//
// Budget at qwen3-0.6b's decode (C 4, pages of 16, rep 2, hd 128, x6):
// 41.1 KB of shared memory a block (K 17 KB, whose space then holds P.V's
// sums, V 17 KB, query and probability terms, scores), 128 threads,
// registers capped at 96 by the launch bounds: 5 blocks an SM, 160 KB of
// K and V in flight an SM.  Head dims up to 128 and up to 256 have an
// instantiation each, the query values a thread loads (MAX_REP x 128 or
// 256 over the threads: 8 or 16 registers) sized for it.  At hd 256 the
// rule gives C 2 at pages of 16 (32 tokens, 32 KB of K and V); at rep 8
// and x6 a block then takes 68 KB: K 17 KB, whose space then holds P.V's
// 32 KB of sums, V 17, query terms 13, scores and P terms 7; 3 blocks an
// SM.
//
// f32 pools (the prefix cache's bitwise contract runs on them) have an
// instantiation of their own, the page type a template parameter: a block
// loads its K and V rows as f32 (float4 loads, no cp.async) and splits
// each element into NS bf16 terms as it lands, the query's split, into NS
// term tiles in shared memory.  The scores and P.V then run one pass for
// each K or V term j: every k16 step into a zeroed fragment, added in f32
// into the fragment's partial sum, which is added into scale group i + j
// (query or probability term i) where i + j < NS, the policy's triangular
// keep.  The wrapper's rule sizes C by the bytes of K and V as pooled (32
// KB: 2 pages of 16 at hd 128, 1 at hd 256), so at x6 and hd 128 a block
// takes 56 KB, 4 blocks an SM.  A simple kernel: the load does not overlap
// the query's split, and the term passes reload their fragments.
#include <cstdint>

#include "tcec_sm90.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;
constexpr int MAX_PS = 64;
constexpr int HDMAX = 256;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

// Query values a thread loads at head dims up to hdp.
constexpr int qreg(int hdp) { return MAX_REP * hdp / THREADS; }

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// One block's dynamic shared memory: tiles of TP = C ps tokens rounded up
// to 16, head dims rounded up to 16; K, V and the bf16 term rows are padded
// by 16 bytes, so that the 8 rows an ldmatrix reads hit distinct banks.
// With f32 pools K and V hold kt = NS bf16 term tiles each (kt = 1 for
// bf16 pools), tile j at j ktile (j vtile) bytes.
struct Layout {
  int TP, hd16, hdv16, NQ, MP;    // tokens, head dims, score / P.V rows
  int kstride, vstride, pstride;  // bytes of a K (or q term) row, V row, p row
  int ktile, vtile;               // bytes of one K, one V term tile
  int ks, red, vs, qb, sg, ss, pa, rows, total;
  __host__ __device__ Layout(int C, int ps, int rep, int hd, int hdv, int ns,
                             int kt) {
    TP = round_up(C * ps, 16);
    hd16 = round_up(hd, 16);
    hdv16 = round_up(hdv, 16);
    NQ = round_up(rep * ns, 8);   // score columns (term i of row r: i rep + r)
    MP = round_up(rep * ns, 16);  // P.V rows, ordered as the score columns
    kstride = hd16 * 2 + 16;
    vstride = hdv16 * 2 + 16;
    pstride = TP * 2 + 16;
    ktile = TP * kstride;
    vtile = TP * vstride;
    ks = 0;                       // K: kt x TP x kstride
    red = 0;                      // P.V's f32 sums, once K is read: MP x hdv16
    const int kbytes = kt * ktile, rbytes = MP * hdv16 * 4;
    vs = kbytes > rbytes ? kbytes : rbytes;  // V: kt x TP x vstride
    qb = vs + kt * vtile;         // bf16 query terms: NQ x kstride
    sg = qb + NQ * kstride;       // f32 scores by group: TP x NQ
    ss = sg + TP * NQ * 4;        // f32 scores, then probabilities: rep x TP
    pa = ss + rep * TP * 4;       // bf16 probability terms: MP x pstride
    rows = pa + MP * pstride;     // each token's row in the pool: TP ints
    total = rows + TP * 4;
  }
};

// Floats of one chunk's partial: m and l (rep each), then ns x rep x hdv.
__host__ __device__ inline long long partial_floats(int rep, int hdv,
                                                    int ns) {
  return (long long)rep * (2 + ns * hdv);
}

// Whether chunk c of a slot holds a valid token: one at or before the
// current one (cur = length - 1) and, with a window, newer than the window.
__device__ inline bool chunk_live(int c, int C, int ps, int maxp, int length,
                                  int window) {
  const int col0 = c * C * ps;
  const int last = min((c + 1) * C, maxp) * ps - 1;
  return last >= col0 && col0 < length &&
         (window <= 0 || (length - 1) - last < window);
}

template <int NS>
__device__ inline float fold(const float (&acc)[NS], float inv) {
  float o = acc[NS - 1];
#pragma unroll
  for (int g = NS - 2; g >= 0; --g) o = acc[g] + o * inv;
  return o;
}

// Row (lane % 8 + 8 (lane / 8 % 2)) and column (8 (lane / 16)) of the
// 16 x 16 tile whose address lane gives to ldmatrix_x4: the order of an
// mma A fragment, and with .trans of two n8 B fragments side by side.
__device__ inline int ld_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ inline int ld_col(int lane) { return (lane >> 4) * 8; }

// 16-byte copies of TP rows of `segs` 16-byte pieces (the first `valid` of
// them from the pool, the rest zero) into rows of `stride` bytes; a row
// < 0 is zero-filled.  Thread tid takes pieces tid, tid + THREADS, ...,
// stepping (row, piece) without a division.
__device__ inline void gather(unsigned char* dst, int stride,
                              const __nv_bfloat16* src, long long rowlen,
                              int valid, int segs, const int* rows, int TP,
                              int tid) {
  int t = tid / segs, s = tid - t * segs;
  const int dt = THREADS / segs, ds = THREADS - dt * segs;
  while (t < TP) {
    const int row = rows[t];
    const bool ok = row >= 0 && s < valid;
    sm90::cp_async16_zfill(dst + t * stride + s * 16,
                           ok ? src + row * rowlen + s * 8 : src, ok ? 16 : 0);
    t += dt;
    s += ds;
    if (s >= segs) { s -= segs; ++t; }
  }
}

// f32 rows of `cols` values (the first `valid` from the pool, the rest
// zero) split into NS bf16 terms as they land: term g of token t goes to
// dst + g tile + t stride.  A row < 0 is zero-filled.  With `vec` a thread
// takes 4 values (one float4 load) at a time, else one.
template <int NS>
__device__ inline void gather_split(unsigned char* dst, int stride, int tile,
                                    const float* src, long long rowlen,
                                    int valid, int cols, const int* rows,
                                    int TP, int tid, float scale, bool vec) {
  if (vec) {
    const int segs = cols / 4;
    for (int i = tid; i < TP * segs; i += THREADS) {
      const int t = i / segs, s = i - t * segs, row = rows[t];
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row >= 0 && s * 4 < valid)
        x = *reinterpret_cast<const float4*>(src + row * rowlen + s * 4);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      __nv_bfloat16 t4[4][NS];
#pragma unroll
      for (int e = 0; e < 4; ++e) tcec::split_bf16<NS>(xs[e], scale, t4[e]);
#pragma unroll
      for (int g = 0; g < NS; ++g) {
        __nv_bfloat162 lo = __halves2bfloat162(t4[0][g], t4[1][g]);
        __nv_bfloat162 hi = __halves2bfloat162(t4[2][g], t4[3][g]);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dst + g * tile + t * stride + s * 8) = u;
      }
    }
  } else {
    for (int i = tid; i < TP * cols; i += THREADS) {
      const int t = i / cols, d = i - t * cols, row = rows[t];
      const float x = row >= 0 && d < valid ? src[row * rowlen + d] : 0.0f;
      __nv_bfloat16 terms[NS];
      tcec::split_bf16<NS>(x, scale, terms);
#pragma unroll
      for (int g = 0; g < NS; ++g)
        reinterpret_cast<__nv_bfloat16*>(dst + g * tile + t * stride)[d] = terms[g];
    }
  }
}

// The page element type's instantiation: bf16 pages are the products'
// terms as they lie (one tile, 5 blocks an SM), f32 pages NS tiles of terms.
template <typename PT, int NS>
struct PageType {
  static constexpr int kt = 1, blocks = 5;
};
template <int NS>
struct PageType<float, NS> {
  static constexpr int kt = NS, blocks = 4;
};

template <typename PT, int NS, int QREG>
__global__ void __launch_bounds__(THREADS, (PageType<PT, NS>::blocks))
paged_chunk_kernel(const float* __restrict__ q,
                   const PT* __restrict__ k_pages,
                   const PT* __restrict__ v_pages,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   float* __restrict__ part, int Hkv, int rep, int hd,
                   int hdv, int ps, int maxp, int C, int window,
                   float softcap, float sm_denom, float scale, float inv,
                   bool vec) {
  constexpr int KT = PageType<PT, NS>::kt;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[MAX_REP], l_s[MAX_REP];
  const Layout L(C, ps, rep, hd, hdv, NS, KT);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.x;
  const long long bh = (long long)b * Hkv + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;           // mma fragment coordinates
  const int pg0 = c * C, npg = min(C, maxp - pg0);
  const int col0 = pg0 * ps, T = npg * ps;
  const int RN = rep * NS;                           // score columns in use
  float* partial = part + (bh * nch + c) * partial_floats(rep, hdv, NS);

  // in flight together: the length, this thread's token's page number and
  // its query values
  const int length = lengths[b];
  const int entry = tid < T ? block_tables[(long long)b * maxp + pg0 + tid / ps] : 0;
  float qv[QREG];
#pragma unroll
  for (int k = 0; k < QREG; ++k) {
    const int i = tid + k * THREADS;
    qv[k] = i < rep * hd ? q[bh * rep * hd + i] : 0.0f;
  }
  const int cur = length - 1;                        // the current token
  const int lo = window > 0 ? cur - window + 1 : 0;  // the oldest valid one

  if (!chunk_live(c, C, ps, maxp, length, window)) {
    if (nch == 1) {
      for (int i = tid; i < rep * hdv; i += THREADS)
        out[bh * rep * hdv + i] = 0.0f;
    } else if (tid < rep) {                   // an empty partial
      partial[tid] = tcec::NEG_INF;
      partial[rep + tid] = 0.0f;
    }
    return;
  }

  // each token's row in the pool, or -1 where it is not valid (past T, past
  // the current token or outside the window): only valid tokens' page
  // numbers are used
  int* rows = reinterpret_cast<int*>(smem + L.rows);
  for (int t = tid; t < L.TP; t += THREADS) {
    const int pos = col0 + t;
    int row = -1;
    if (t < T && pos >= lo && pos <= cur) {
      const int e = t < THREADS ? entry
                                : block_tables[(long long)b * maxp + pg0 + t / ps];
      row = e * ps + t % ps;
    }
    rows[t] = row;
  }
  __syncthreads();

  // gather every K row, then every V row, of the chunk's TP tokens; rows of
  // tokens that are not valid, and the columns past the head dims, are
  // zero-filled
  unsigned char* ks = smem + L.ks;
  unsigned char* vs = smem + L.vs;
  const long long rowk = (long long)Hkv * hd, rowv = (long long)Hkv * hdv;
  if constexpr (KT > 1) {   // f32 pages: loaded and split into NS terms
    gather_split<NS>(ks, L.kstride, L.ktile, k_pages + h * hd, rowk, hd,
                     L.hd16, rows, L.TP, tid, scale, vec);
    gather_split<NS>(vs, L.vstride, L.vtile, v_pages + h * hdv, rowv, hdv,
                     L.hdv16, rows, L.TP, tid, scale, vec);
  } else if (vec) {
    gather(ks, L.kstride, k_pages + h * hd, rowk, hd / 8, L.hd16 / 8, rows, L.TP, tid);
    sm90::cp_async_commit();
    gather(vs, L.vstride, v_pages + h * hdv, rowv, hdv / 8, L.hdv16 / 8, rows, L.TP, tid);
    sm90::cp_async_commit();
  } else {  // head dims not a multiple of 8: element by element
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
    for (int i = tid; i < L.TP * L.hd16; i += THREADS) {
      const int t = i / L.hd16, d = i - t * L.hd16, row = rows[t];
      reinterpret_cast<__nv_bfloat16*>(ks + t * L.kstride)[d] =
          row >= 0 && d < hd ? k_pages[row * rowk + h * hd + d] : zero;
    }
    for (int i = tid; i < L.TP * L.hdv16; i += THREADS) {
      const int t = i / L.hdv16, d = i - t * L.hdv16, row = rows[t];
      reinterpret_cast<__nv_bfloat16*>(vs + t * L.vstride)[d] =
          row >= 0 && d < hdv ? v_pages[row * rowv + h * hdv + d] : zero;
    }
  }

  // split the query while the copies land: bf16 terms, the scores' B
  // operand, row i rep + r for term i of query row r (zero elsewhere)
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + L.qb);
  const int qrow = L.kstride / 2;
#pragma unroll
  for (int k = 0; k < QREG; ++k) {
    const int i = tid + k * THREADS;
    if (i < rep * hd) {
      const int r = i / hd, d = i - r * hd;
      __nv_bfloat16 t[NS];
      tcec::split_bf16<NS>(qv[k], scale, t);
#pragma unroll
      for (int g = 0; g < NS; ++g) qb[(g * rep + r) * qrow + d] = t[g];
    }
  }
  const int qsegs = L.hd16 / 8;                 // zero the rows past RN
  for (int i = RN * qsegs + tid; i < L.NQ * qsegs; i += THREADS)
    *reinterpret_cast<uint4*>(smem + L.qb + i * 16 + i / qsegs * 16) =
        make_uint4(0, 0, 0, 0);
  if (hd < L.hd16)                              // and the columns past hd
    for (int i = tid; i < RN * (L.hd16 - hd); i += THREADS) {
      const int n = i / (L.hd16 - hd);
      qb[n * qrow + hd + i - n * (L.hd16 - hd)] = __float2bfloat16_rn(0.0f);
    }
  sm90::cp_async_wait<1>();   // K is in
  __syncthreads();

  // scores, a warp for each 16 tokens: every k16 step of every term
  // product into a zeroed fragment, added in f32 into its column (one scale
  // group of one query row).  With f32 pages, K term j's pass adds its
  // column i rep + r into group i + j's column (i + j) rep + r, for i + j <
  // NS; a warp's passes touch only its own rows
  float* sg = reinterpret_cast<float*>(smem + L.sg);
  const int nq8 = L.NQ / 8;
  for (int t0 = warp * 16; t0 < T; t0 += WARPS * 16) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      const unsigned char* arow = ks + kt * L.ktile + (t0 + ld_row(lane)) * L.kstride + ld_col(lane) * 2;
      for (int k0 = 0; k0 < L.hd16; k0 += 16) {
        uint32_t a[4];
        sm90::ldmatrix_x4(a, arow + k0 * 2);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nq8) {
            const unsigned char* brow = smem + L.qb + (j * 8 + g8) * L.kstride + (k0 + 2 * t4) * 2;
            const uint32_t bb[2] = {*reinterpret_cast<const uint32_t*>(brow),
                                    *reinterpret_cast<const uint32_t*>(brow + 16)};
            float d[4];
            sm90::mma16816(d, a, bb);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
          }
        }
      }
      if (kt == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < nq8) {
            float* r0 = sg + (t0 + g8) * L.NQ + j * 8 + 2 * t4;
            *reinterpret_cast<float2*>(r0) = make_float2(acc[j][0], acc[j][1]);
            *reinterpret_cast<float2*>(r0 + 8 * L.NQ) = make_float2(acc[j][2], acc[j][3]);
          }
        }
      } else {
        __syncwarp();   // the previous pass's columns are in
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * 8 + 2 * t4 + e + kt * rep;
            if (j < nq8 && col < RN) {
              float* r0 = sg + (t0 + g8) * L.NQ + col;
              r0[0] += acc[j][e];
              r0[8 * L.NQ] += acc[j][2 + e];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // fold the groups smallest-first, scale, softcap, select the valid tokens
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  for (int i = tid; i < rep * T; i += THREADS) {
    const int r = i / T, t = i - r * T, pos = col0 + t;
    float s = tcec::NEG_INF;
    if (pos >= lo && pos <= cur) {
      float part[NS];
#pragma unroll
      for (int g = 0; g < NS; ++g) part[g] = sg[t * L.NQ + g * rep + r];
      s = fold<NS>(part, inv) / sm_denom;
      if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
    }
    ss[r * L.TP + t] = s;
  }
  __syncthreads();

  // the chunk's softmax, a warp a row: m, p = exp(s - m), l; p's bf16
  // terms, the P.V A operand, row i rep + r (zero past T)
  __nv_bfloat16* pa = reinterpret_cast<__nv_bfloat16*>(smem + L.pa);
  const int prow = L.pstride / 2;
  const bool single = maxp == 1;
  for (int r = warp; r < rep; r += WARPS) {
    float* sr = ss + r * L.TP;
    float m = tcec::NEG_INF;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, sr[t]);
    m = tcec::warp_max(m);
    float l = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float p = expf(sr[t] - m);
      sr[t] = p;
      l += p;
    }
    l = tcec::warp_sum(l);
    for (int t = lane; t < L.TP; t += 32) {
      const float p = t < T ? (single ? sr[t] / l : sr[t]) : 0.0f;
      __nv_bfloat16 terms[NS];
      tcec::split_bf16<NS>(p, scale, terms);
#pragma unroll
      for (int g = 0; g < NS; ++g) pa[(g * rep + r) * prow + t] = terms[g];
    }
    if (lane == 0) { m_s[r] = m; l_s[r] = l; }
  }
  sm90::cp_async_wait<0>();   // V is in
  __syncthreads();

  // P.V, a warp for each 16 output columns: rows i rep + r of the p terms
  // against V, every k16 step into a zeroed fragment added in f32.  With
  // f32 pages, V term j's pass adds its row i rep + r into group i + j's
  // row (i + j) rep + r, for i + j < NS; a warp's passes touch only its
  // own columns
  float* red = reinterpret_cast<float*>(smem + L.red);  // K is read: reuse
  const int mtiles = L.MP / 16;                         // 1 or 2
  for (int n0 = warp * 16; n0 < L.hdv16; n0 += WARPS * 16) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      float acc[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
      const unsigned char* vt = vs + kt * L.vtile;
      for (int k0 = 0; k0 < T; k0 += 16) {
        uint32_t bv[4];
        sm90::ldmatrix_x4_trans(bv, vt + (k0 + ld_row(lane)) * L.vstride + (n0 + ld_col(lane)) * 2);
        const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt < mtiles) {
            uint32_t a[4];
            sm90::ldmatrix_x4(a, smem + L.pa + (mt * 16 + ld_row(lane)) * L.pstride + (k0 + ld_col(lane)) * 2);
            float d[4];
            sm90::mma16816(d, a, b0);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][0][e] += d[e];
            sm90::mma16816(d, a, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][1][e] += d[e];
          }
        }
      }
      if (kt == 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt < mtiles) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float* r0 = red + (mt * 16 + g8) * L.hdv16 + n0 + j * 8 + 2 * t4;
              *reinterpret_cast<float2*>(r0) = make_float2(acc[mt][j][0], acc[mt][j][1]);
              *reinterpret_cast<float2*>(r0 + 8 * L.hdv16) = make_float2(acc[mt][j][2], acc[mt][j][3]);
            }
          }
        }
      } else {
        __syncwarp();   // the previous pass's rows are in
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8) {
            const int row = mt * 16 + g8 + 8 * h8 + kt * rep;
            if (mt < mtiles && row < RN) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                float* r0 = red + row * L.hdv16 + n0 + j * 8 + 2 * t4;
                r0[0] += acc[mt][j][2 * h8];
                r0[1] += acc[mt][j][2 * h8 + 1];
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // the output (one chunk) or the chunk's partial, per (row, column)
  for (int i = tid; i < rep * hdv; i += THREADS) {
    const int r = i / hdv, d = i - r * hdv;
    float a[NS];
#pragma unroll
    for (int g = 0; g < NS; ++g) a[g] = red[(g * rep + r) * L.hdv16 + d];
    if (nch == 1) {
      float o = fold<NS>(a, inv);
      if (!single) o = o / fmaxf(l_s[r], 1e-30f);
      out[bh * rep * hdv + i] = o;
    } else {
#pragma unroll
      for (int g = 0; g < NS; ++g)
        partial[2 * rep + (long long)g * rep * hdv + i] = a[g];
    }
  }
  if (nch > 1 && tid < rep) {
    partial[tid] = m_s[tid];
    partial[rep + tid] = l_s[tid];
  }
}

// The second pass: one block per (kv head, slot, CTHREADS of the rep x hdv
// outputs) combines the live chunks' partials in chunk order (a block for
// each 256 outputs: MQA's 8 query heads of 256 on one kv head give 8
// blocks a slot, where one block a slot would leave the card idle).  The
// live chunks are consecutive; their weights w_j = exp(m_j - M) go to
// shared memory first, so that each thread's loads of the accumulators
// are independent and many are in flight at once.
constexpr int CTHREADS = 256;

template <int NS>
__global__ void __launch_bounds__(CTHREADS)
paged_combine_kernel(const int* __restrict__ lengths,
                     const float* __restrict__ part, float* __restrict__ out,
                     int Hkv, int rep, int hdv, int ps, int maxp, int C,
                     int nch, int window, float inv) {
  extern __shared__ float ws[];  // w_j of each row, then l_j
  __shared__ float M_s[MAX_REP], l_s[MAX_REP];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long bh = (long long)b * Hkv + h;
  const int length = lengths[b];
  int c0 = nch, c1 = -1;
  for (int c = 0; c < nch; ++c)
    if (chunk_live(c, C, ps, maxp, length, window)) {
      c0 = min(c0, c);
      c1 = c;
    }
  const int nl = c1 - c0 + 1;
  const int o = blockIdx.z * CTHREADS + tid;   // this thread's output
  if (nl <= 0) {
    if (o < rep * hdv) out[bh * rep * hdv + o] = 0.0f;
    return;
  }
  const long long pf = partial_floats(rep, hdv, NS);
  const float* base = part + (bh * nch + c0) * pf;
  float* lw = ws + nl * rep;
  for (int i = tid; i < nl * rep; i += CTHREADS) {
    const int j = i / rep, r = i - j * rep;
    ws[i] = base[j * pf + r];
    lw[i] = base[j * pf + rep + r];
  }
  __syncthreads();
  if (tid < rep) {
    float M = tcec::NEG_INF;
    for (int j = 0; j < nl; ++j) M = fmaxf(M, ws[j * rep + tid]);
    M_s[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < nl * rep; i += CTHREADS)
    ws[i] = expf(ws[i] - M_s[i % rep]);
  __syncthreads();
  if (tid < rep) {
    float l = 0.0f;
    for (int j = 0; j < nl; ++j) l = fmaf(ws[j * rep + tid], lw[j * rep + tid], l);
    l_s[tid] = l;
  }
  __syncthreads();
  if (o < rep * hdv) {
    const int r = o / hdv;
    const float* pc = base + 2 * rep + o;   // (g, r, d) at g rep hdv + o
    float acc[NS];
#pragma unroll
    for (int g = 0; g < NS; ++g) acc[g] = 0.0f;
#pragma unroll 8
    for (int j = 0; j < nl; ++j) {
      const float w = ws[j * rep + r];
#pragma unroll
      for (int g = 0; g < NS; ++g)
        acc[g] = fmaf(w, pc[j * pf + (long long)g * rep * hdv], acc[g]);
    }
    out[bh * rep * hdv + o] = fold<NS>(acc, inv) / fmaxf(l_s[r], 1e-30f);
  }
}

// The first pass, its instantiation for query values of head dims up to
// 128 (QREG 8) or 256 (QREG 16).
template <typename PT, int NS, int QREG>
cudaError_t launch_chunks(const Layout& L, int nch, const float* q,
                          const PT* kp, const PT* vp,
                          const int* bt, const int* lens, float* out,
                          float* work, int B, int Hkv, int rep, int hd,
                          int hdv, int ps, int maxp, int C, int window,
                          float softcap, float sm_denom, float scale,
                          float inv, bool vec, cudaStream_t stream) {
  if (L.total > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_chunk_kernel<PT, NS, QREG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
  }
  paged_chunk_kernel<PT, NS, QREG>
      <<<dim3(nch, Hkv, B), THREADS, L.total, stream>>>(
          q, kp, vp, bt, lens, out, work, Hkv, rep, hd, hdv, ps, maxp, C,
          window, softcap, sm_denom, scale, inv, vec);
  return cudaGetLastError();
}

template <typename PT, int NS>
cudaError_t launch(const float* q, const PT* kp, const PT* vp, const int* bt,
                   const int* lens, float* out, float* work, int B, int Hkv,
                   int rep, int hd, int hdv, int ps, int maxp, int C,
                   int window, float softcap, float sm_denom, float scale,
                   float inv, bool vec, cudaStream_t stream) {
  const Layout L(C, ps, rep, hd, hdv, NS, PageType<PT, NS>::kt);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  const int nch = maxp > 0 ? (maxp + C - 1) / C : 1;
  if (nch > 1 && work == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      hd <= 128
          ? launch_chunks<PT, NS, qreg(128)>(L, nch, q, kp, vp, bt, lens, out,
                                         work, B, Hkv, rep, hd, hdv, ps, maxp,
                                         C, window, softcap, sm_denom, scale,
                                         inv, vec, stream)
          : launch_chunks<PT, NS, qreg(HDMAX)>(L, nch, q, kp, vp, bt, lens, out,
                                           work, B, Hkv, rep, hd, hdv, ps,
                                           maxp, C, window, softcap, sm_denom,
                                           scale, inv, vec, stream);
  if (err != cudaSuccess || nch == 1) return err;
  const int cbytes = 2 * nch * rep * 4;   // w_j and l_j of every row
  if (cbytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (cbytes > 48 * 1024) {
    err = cudaFuncSetAttribute(paged_combine_kernel<NS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               cbytes);
    if (err != cudaSuccess) return err;
  }
  const int nz = (rep * hdv + CTHREADS - 1) / CTHREADS;
  paged_combine_kernel<NS><<<dim3(Hkv, B, nz), CTHREADS, cbytes, stream>>>(
      lens, work, out, Hkv, rep, hdv, ps, maxp, C, nch, window, inv);
  return cudaGetLastError();
}

// The policy's term count, then the page type.
template <typename PT>
cudaError_t launch_pages(const float* q, const void* kp, const void* vp,
                         const int* bt, const int* lens, float* out,
                         float* work, int B, int Hkv, int rep, int hd, int hdv,
                         int ps, int maxp, int C, int window, float softcap,
                         float sm_denom, int n_splits, float scale, float inv,
                         bool vec, cudaStream_t s) {
  const PT* K = static_cast<const PT*>(kp);
  const PT* V = static_cast<const PT*>(vp);
  switch (n_splits) {
    case 2:
      return launch<PT, 2>(q, K, V, bt, lens, out, work, B, Hkv, rep, hd, hdv, ps, maxp, C, window, softcap, sm_denom, scale, inv, vec, s);
    case 3:
      return launch<PT, 3>(q, K, V, bt, lens, out, work, B, Hkv, rep, hd, hdv, ps, maxp, C, window, softcap, sm_denom, scale, inv, vec, s);
    case 4:
      return launch<PT, 4>(q, K, V, bt, lens, out, work, B, Hkv, rep, hd, hdv, ps, maxp, C, window, softcap, sm_denom, scale, inv, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// page_bytes: 2 for bf16 pools, 4 for f32 pools; anything else is refused.
extern "C" int tcec_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* lengths, void* out, void* work,
    int B, int Hkv, int rep, int hd, int hdv, int ps, int maxp, int C,
    int window, float softcap, float sm_denom, int n_splits, int scale_bits,
    int page_bytes, void* stream) {
  if (hd < 1 || hd > HDMAX || hdv < 1 || hdv > HDMAX || rep < 1 ||
      rep > MAX_REP || ps < 1 || ps > MAX_PS || maxp < 0 || C < 1 ||
      C > (maxp > 0 ? maxp : 1))
    return cudaErrorInvalidValue;
  const float scale = ldexpf(1.0f, scale_bits);
  const float inv = ldexpf(1.0f, -scale_bits);
  const bool vec = hd % 8 == 0 && hdv % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const float* Q = static_cast<const float*>(q);
  const int* BT = static_cast<const int*>(block_tables);
  const int* LN = static_cast<const int*>(lengths);
  float* O = static_cast<float*>(out);
  float* W = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (page_bytes) {
    case 2:
      return launch_pages<__nv_bfloat16>(Q, k_pages, v_pages, BT, LN, O, W, B, Hkv, rep, hd, hdv, ps, maxp, C, window, softcap, sm_denom, n_splits, scale, inv, vec, s);
    case 4:
      return launch_pages<float>(Q, k_pages, v_pages, BT, LN, O, W, B, Hkv, rep, hd, hdv, ps, maxp, C, window, softcap, sm_denom, n_splits, scale, inv, vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* tcec_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
