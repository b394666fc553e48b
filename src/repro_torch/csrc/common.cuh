// Shared helpers for the port's hand-written kernels (sm_90a, plain C entry
// points loaded with ctypes by repro_torch/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes, kept equal to _build.DTYPE_CODES
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Round-to-nearest-even, as torch's and XLA's casts do.
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Dispatch a runtime dtype code onto a template body taking `scalar_t`.
#define DISPATCH_DTYPE(code, ...)                                      \
  switch (code) {                                                      \
    case kF32: { using scalar_t = float; __VA_ARGS__; break; }         \
    case kBF16: { using scalar_t = __nv_bfloat16; __VA_ARGS__; break; } \
    case kF16: { using scalar_t = __half; __VA_ARGS__; break; }        \
    default: return (int)cudaErrorInvalidValue;                        \
  }
