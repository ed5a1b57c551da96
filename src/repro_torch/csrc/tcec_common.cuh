// Shared device helpers of the TCEC kernels: the in-register split of an
// f32 value into bf16 terms (the paper's Eqs. 19-22 with the residual scaled
// by 2^scale_bits before each cast), warp reductions, and the epilogue
// activations.  Each helper restates, operation for operation, what the
// JAX package's kernels compute, so that the kernels agree with their plain
// PyTorch versions to the f32 rounding of the summation order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tcec {

// Additive mask value of the attention kernels (finite: fully masked rows
// give garbage instead of NaN, as in the JAX package's models.layers).
constexpr float NEG_INF = -2.0e38f;

// Split x into NS bf16 terms, round to nearest even at every cast:
//   a_0 = bf16(x); r = (x - a_0) * 2^s; a_1 = bf16(r); ...
template <int NS>
__device__ __forceinline__ void split_bf16(float x, float scale,
                                           __nv_bfloat16 (&out)[NS]) {
  float r = x;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    out[i] = __float2bfloat16_rn(r);
    if (i + 1 < NS) r = __fmul_rn(__fsub_rn(r, __bfloat162float(out[i])), scale);
  }
}

// The same split, with each term returned as the f32 value it stands for.
template <int NS>
__device__ __forceinline__ void split_f32(float x, float scale,
                                          float (&out)[NS]) {
  float r = x;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    out[i] = __bfloat162float(__float2bfloat16_rn(r));
    if (i + 1 < NS) r = __fmul_rn(__fsub_rn(r, out[i]), scale);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Epilogue activations, numbered as kernels/tcec_matmul.py's ACTIVATION_IDS.
// gelu is the tanh approximation (jax.nn.gelu's default).
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1:
      return fmaxf(x, 0.0f);
    case 2: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
    }
    case 3:
      return x * (1.0f / (1.0f + expf(-x)));
    case 4:
      return tanhf(x);
    default:
      return x;
  }
}

}  // namespace tcec
