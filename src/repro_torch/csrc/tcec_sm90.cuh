// Hopper (sm_90a) building blocks of the TCEC kernels: shared-memory
// descriptors of unswizzled core-matrix tiles, the wgmma forms with
// scale-d = 0, the two-fragment pipeline that adds every wgmma's fragment
// in f32 (the paper's rule), mma.sync with C = 0 and ldmatrix, named
// barriers, cp.async and the paired f32 -> bf16 term split.  Each piece was
// checked on the card against a plain product before a kernel was built on
// it.
#pragma once

#include <cstdint>

#include "tcec_common.cuh"

namespace sm90 {

// ------------------------------------------------------------- wgmma

// Byte offset of the 16-byte row segment (row r, columns 8 c8 .. 8 c8 + 7)
// of a bf16 operand tile of kd8 x 8 columns, stored without swizzle as 8 x 8
// core matrices of 128 contiguous bytes: along a row at 128 bytes, 8-row
// groups at kd8 x 128 bytes.
__device__ __forceinline__ int core_offset(int r, int c8, int kd8) {
  return ((r >> 3) * kd8 + c8) * 128 + (r & 7) * 16;
}

// wgmma shared-memory matrix descriptor, no swizzle, in two words: the low
// word holds the start address (bits 0-13, in 16-byte units) and the
// leading byte offset (K-major: the next core matrix along K, 128 here;
// MN-major: the next 8 rows along K); the high word the stride byte offset
// (the next 8 rows along M or N; MN-major: the next 8 columns).
__device__ __forceinline__ uint32_t desc_lo(uint32_t saddr, uint32_t lbo = 128) {
  return ((saddr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}

__device__ __forceinline__ uint64_t desc(uint32_t lo, uint32_t sbo) {
  return (uint64_t(sbo >> 4) << 32) | lo;
}

// x, opaque to the compiler: the descriptors formed from it in the tile loop
// are not loop invariants, so they are formed where each wgmma needs them
// instead of being hoisted out of the loop, a register pair each.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of a fragment above the wait that
// completes it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The wgmma forms, each D = A B with scale-d = 0 (D's earlier content is
// not read) into the first N / 2 elements of d: A (64 x 16) and B (16 x N)
// from shared memory, or A from registers in wgmma's A-fragment layout.
// A is K-major.  B is K-major for the n32, n16 and n8 forms (QK^T: K terms)
// and MN-major, the transpose bit set, for the n64 forms (P.V: V terms);
// wgmma_rs64<0> takes a K-major B.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(0)
      : "memory");
}

__device__ __forceinline__ void wgmma_ss32(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(0)
      : "memory");
}

template <int TB = 1>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0),
        "n"(TB)
      : "memory");
}


__device__ __forceinline__ void wgmma_ss16(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(0)
      : "memory");
}

__device__ __forceinline__ void wgmma_ss8(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(0)
      : "memory");
}

// D = A B from shared memory into the first NR of d: m64n(2 NR)k16.
template <int NR>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
  static_assert(NR == 16 || NR == 8 || NR == 4, "n32, n16 or n8");
  if constexpr (NR == 16)
    wgmma_ss32(d, da, db);
  else if constexpr (NR == 8)
    wgmma_ss16(d, da, db);
  else
    wgmma_ss8(d, da, db);
}

// N wgmmas, issue(f, n), each with scale-d = 0 into fragment f0 or f1,
// and add(f, n) once wgmma n has landed (N even, or 1).  The two fragments
// alternate, so that the next wgmma runs while one is added; they persist
// across calls, so that ptxas keeps them in fixed registers.  No branch may
// enclose a wgmma here: ptxas would serialize the pipeline.
template <int N, class Issue, class Add>
__device__ __forceinline__ void wgmma_pipeline(float (&f0)[32], float (&f1)[32],
                                               Issue issue, Add add) {
  static_assert(N % 2 == 0 || N == 1, "the fragments alternate in pairs");
  if constexpr (N == 1) {   // one wgmma: nothing to overlap its add with
    wgmma_fence();
    issue(f0, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(f0);
    add(f0, 0);
  } else {
    wgmma_fence();
    issue(f0, 0);
    wgmma_commit();
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      wgmma_fence();
      issue(f1, n + 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(f0);
      add(f0, n);
      if (n + 2 < N) {
        wgmma_fence();
        issue(f0, n + 2);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(f1);
      add(f1, n + 1);
    }
  }
}

// dst += one term product over K k16 steps (K even, or 1): step kk is the wgmma
// issue(f, kk), added in f32 into the first NR elements of dst.
template <int K, int NR, class Issue>
__device__ __forceinline__ void add_term_product(float (&dst)[NR],
                                                 float (&f0)[32],
                                                 float (&f1)[32],
                                                 Issue issue) {
  wgmma_pipeline<K>(f0, f1, issue, [&](const float(&f)[32], int) {
#pragma unroll
    for (int e = 0; e < NR; ++e) dst[e] += f[e];
  });
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------- mma.sync

// D = A B with C = 0: one m16n8k16 bf16 product.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; .trans hands each lane the transpose.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// ------------------------------------------------------------- staging

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Split (a, b) into NS bf16x2 words of terms, a in the low half: the
// paper's split (tcec::split_bf16), two values per conversion.
template <int NS>
__device__ __forceinline__ void split2(float a, float b, float scale,
                                       uint32_t (&w)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(w[i]) : "f"(b), "f"(a));
    if (i + 1 < NS) {
      a = __fmul_rn(__fsub_rn(a, __uint_as_float(w[i] << 16)), scale);
      b = __fmul_rn(__fsub_rn(b, __uint_as_float(w[i] & 0xffff0000u)), scale);
    }
  }
}

// Split 8 f32 values into NS 16-byte rows of bf16 terms.
template <int NS>
__device__ __forceinline__ void split8(const float (&x)[8], float scale,
                                       uint4 (&out)[NS]) {
  uint32_t w[4][NS];
#pragma unroll
  for (int e = 0; e < 4; ++e) split2<NS>(x[2 * e], x[2 * e + 1], scale, w[e]);
#pragma unroll
  for (int i = 0; i < NS; ++i) out[i] = make_uint4(w[0][i], w[1][i], w[2][i], w[3][i]);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async with zero fill: src_bytes of the 16 (or 4) are copied, the rest
// of the destination is zeroed; src_bytes = 0 copies nothing (src must
// still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

}  // namespace sm90
