// Row RMSNorm for Hopper.
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm (Pallas `_kernel`): mean of
// squares in f32, y = x * rsqrt(var + eps) rounded to x's dtype, times gamma,
// rounded to x's dtype again.
//
// Bound on the H100: bytes. Each row is read once and written once and does
// ~3 flops per element, far below the ~295 flops/byte where compute would
// bound it. Design: one warp per row, 16-byte vector loads and stores
// (8 bf16 or 4 f32 per lane) with neighbouring lanes on neighbouring
// addresses, the sum of squares reduced by warp shuffles, no shared memory.
// The second pass re-reads the row, which a 4-warp block (<= 32 KB of rows
// at d = 4096) finds in L1, so device memory sees one read per element.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T, typename G, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
               T* __restrict__ out, long long n, long long d, long long xs, float eps) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * xs;
  T* orow = out + row * d;

  float ss = 0.f;
  if (kVec) {
    for (long long i = (long long)lane * V; i < d; i += 32 * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (long long i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);

  if (kVec) {
    for (long long i = (long long)lane * V; i < d; i += 32 * V) {
      uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T y = from_f32<T>(to_f32(e[j]) * r);
        o[j] = from_f32<T>(to_f32(y) * to_f32(gamma[i + j]));
      }
      *reinterpret_cast<uint4*>(orow + i) = res;
    }
  } else {
    for (long long i = lane; i < d; i += 32) {
      const T y = from_f32<T>(to_f32(xr[i]) * r);
      orow[i] = from_f32<T>(to_f32(y) * to_f32(gamma[i]));
    }
  }
}

template <typename T, typename G>
int launch(const void* x, const void* g, void* out, long long n, long long d,
           long long xs, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 && xs % V == 0 && ((uintptr_t)x % 16) == 0 &&
                   ((uintptr_t)out % 16) == 0;
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps)), block(kWarps * 32);
  if (vec) {
    rmsnorm_kernel<T, G, true><<<grid, block, 0, stream>>>(
        (const T*)x, (const G*)g, (T*)out, n, d, xs, eps);
  } else {
    rmsnorm_kernel<T, G, false><<<grid, block, 0, stream>>>(
        (const T*)x, (const G*)g, (T*)out, n, d, xs, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, d) rows `xs` elements apart; out: (n, d) contiguous; gamma: (d,) of
// x's dtype or f32.
extern "C" int rmsnorm_fwd(const void* x, const void* gamma, void* out, long long n,
                           long long d, long long xs, float eps, int dtype,
                           int gamma_dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (gamma_dtype == kF32) {
    DISPATCH_DTYPE(dtype, return launch<scalar_t, float>(x, gamma, out, n, d, xs, eps, s));
  }
  if (gamma_dtype != dtype) return (int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(dtype, return launch<scalar_t, scalar_t>(x, gamma, out, n, d, xs, eps, s));
  return 0;
}
