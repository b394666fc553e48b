// Row RMSNorm for Hopper, and its backward (at the end of the file).
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm (Pallas `_kernel`): mean of
// squares in f32, y = x * rsqrt(var + eps) rounded to x's dtype, times gamma
// in f32, rounded to x's dtype again. Rows of x lie `xs` elements apart (the
// final norm reads x[:, -1]); out is contiguous.
//
// What bounds it on the H100. At many rows, bytes: each element is read once
// and written once and costs ~3 flops, far below the ~295 flops/byte where
// compute would bound it, so the card needs enough loads in flight on every
// SM to cover device-memory latency. At few rows (8 rows of 4096 bf16 are
// 64 KB, 20 ns of the card's bandwidth), latency: the launch, one round trip
// to device memory and one reduction are all there is to the time.
//
// Design. A thread owns VPT (a template parameter) 16-byte vectors of its
// row, vector j * tpr + t for thread t of the row's tpr threads (neighbouring
// threads on neighbouring addresses), and the matching gamma vectors. It
// issues every load before it uses any, keeps the vectors in registers,
// reduces the sum of squares, scales and stores: one read per element, no
// second pass, no loop over a runtime d. Gamma is loaded once per CTA, in
// the same burst as the first row's x, and a grid of at most (SMs x
// resident CTAs) walks the rows. The host chooses the CTA's shape
// (kernels/rmsnorm.py:rmsnorm_plan), from times measured on the card:
//  - few rows (up to 4 per SM): one CTA per row, the row spread over up to
//    256 threads (8 warps at d = 4096 bf16, 2 vectors each); warps combine
//    their sums through shared memory with one __syncthreads. At the decode
//    batch of 8 that is 8 SMs and 64 warps instead of 2 SMs and 8 warps, and
//    the chain is one round trip plus one block reduction.
//  - many rows: two rows per CTA of up to 128 threads each (4 warps of 4
//    vectors at d = 4096 bf16); every SM holds several CTAs, so enough rows'
//    loads are in flight to keep device memory busy, and gamma stays in
//    registers across the rows a CTA walks.
// Rows narrower than a warp share one (tpr < 32 lanes each). The scalar
// instantiation (kVec = false: one element per "vector", same code) takes a
// d or a row stride that is not a whole number of vectors, or any of x,
// gamma, out not 16-byte aligned. A row must fit one CTA's registers: d up
// to 32768 (bf16/f16) or 16384 (f32) on the vector path, 16384 on the scalar.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kVecBytes = 16;

// The most threads a CTA may have at VPT vectors per thread, kept equal to
// kernels/rmsnorm.py:max_threads. x and gamma of VPT 16-byte vectors take
// 8 * VPT registers (12 * VPT with an f32 gamma beside bf16 x), so the bound
// halves from VPT = 8 on and leaves each thread 128-255 registers.
__host__ __device__ constexpr int max_threads(int vpt, bool vec) {
  return !vec || vpt <= 4 ? 1024 : 4096 / vpt;
}

// Hide a register's value from the optimiser. Without it, ptxas keeps the
// f32 copies of x made for the sum of squares (and of gamma, hoisted out of
// the row loop) live until the scaling, twice the registers of the raw
// vectors, and spills; converting again after the reduction costs one
// instruction per element.
__device__ __forceinline__ void opaque(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}
__device__ __forceinline__ void opaque(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }
template <typename H>  // __nv_bfloat16, __half
__device__ __forceinline__ void opaque(H& v) {
  asm volatile("" : "+h"(reinterpret_cast<unsigned short&>(v)));
}

template <typename T, typename G, int VPT, bool kVec>
__global__ void __launch_bounds__(max_threads(VPT, kVec))
rmsnorm_kernel(const T* __restrict__ x, const G* __restrict__ gamma, T* __restrict__ out,
               long long n, int d, long long xs, int rows, int tpr, float eps) {
  constexpr int W = kVec ? kVecBytes / (int)sizeof(T) : 1;          // elements per vector
  constexpr int GQ = kVec ? W * (int)sizeof(G) / kVecBytes : 1;     // loads per gamma vector
  using XV = std::conditional_t<kVec, uint4, T>;
  using GV = std::conditional_t<kVec, uint4, G>;
  __shared__ float part[2][32];  // per-warp sums; alternate rows use alternate halves

  const int r = threadIdx.x / tpr, t = threadIdx.x - r * tpr;
  const int nvec = d / W;
  const int warps = tpr >> 5;  // warps per row (0: several rows share a warp)
  const int lanes = tpr < 32 ? tpr : 32;

  GV g[VPT][GQ];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * tpr + t;
#pragma unroll
    for (int q = 0; q < GQ; ++q)
      g[j][q] = v < nvec ? reinterpret_cast<const GV*>(gamma + (long long)v * W)[q] : GV{};
  }

  const long long step = (long long)gridDim.x * rows;
  int buf = 0;
  for (long long row0 = (long long)blockIdx.x * rows; row0 < n; row0 += step, buf ^= 1) {
    const long long row = row0 + r;
    const bool live = row < n;
    const XV* xr = reinterpret_cast<const XV*>(x + row * xs);
    XV xv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = j * tpr + t;
      xv[j] = live && v < nvec ? xr[v] : XV{};
    }

    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const T* e = reinterpret_cast<const T*>(&xv[j]);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float f = to_f32(e[k]);
        ss = fmaf(f, f, ss);
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (warps > 1) {  // the same for every thread of the CTA
      if ((threadIdx.x & 31) == 0) part[buf][threadIdx.x >> 5] = ss;
      __syncthreads();
      const float* p = part[buf] + r * warps;
      ss = 0.f;
      for (int w = 0; w < warps; ++w) ss += p[w];
    }
    const float rs = rsqrtf(ss / (float)d + eps);

    if (live) {
      XV* orow = reinterpret_cast<XV*>(out + row * d);
      int ts = t;  // store offsets are computed anew, not kept from the loads
      opaque(ts);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        opaque(xv[j]);
        const int v = j * tpr + ts;
        if (v < nvec) {
          const T* e = reinterpret_cast<const T*>(&xv[j]);
          const G* ge = reinterpret_cast<const G*>(&g[j][0]);
          XV o;
          T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const T y = from_f32<T>(to_f32(e[k]) * rs);
            oe[k] = from_f32<T>(to_f32(y) * to_f32(ge[k]));
          }
          orow[v] = o;
        }
      }
    }
    // gamma is converted at use, row by row, not once into f32 registers
    // (placed here so that the first row's loads never wait on gamma's)
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int q = 0; q < GQ; ++q) opaque(g[j][q]);
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p % kVecBytes) == 0; }

template <typename T, typename G, int VPT, bool kVec>
int launch(const void* x, const void* g, void* out, long long n, long long d, long long xs,
           float eps, int rows, int tpr, cudaStream_t stream) {
  constexpr int W = kVec ? kVecBytes / (int)sizeof(T) : 1;
  const int threads = rows * tpr;
  if (rows < 1 || tpr < 1 || threads > max_threads(VPT, kVec) || threads % 32 != 0 ||
      (tpr < 32 ? 32 % tpr != 0 : tpr % 32 != 0) || (long long)tpr * VPT * W < d ||
      d > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (kVec && (d % W != 0 || xs % W != 0 || !aligned16(x) || !aligned16(g) || !aligned16(out)))
    return (int)cudaErrorMisalignedAddress;
  auto kernel = rmsnorm_kernel<T, G, VPT, kVec>;
  // resident CTAs per SM, by threads / 32; the same on every sm_90a card
  static int per_sm[33] = {};
  int& resident = per_sm[threads / 32];
  if (resident == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                                        threads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (n + rows - 1) / rows;
  const long long wave = (long long)resident * n_sm;
  const unsigned grid = (unsigned)(groups < wave ? groups : wave);
  kernel<<<grid, threads, 0, stream>>>((const T*)x, (const G*)g, (T*)out, n, (int)d, xs, rows,
                                       tpr, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename G>
int dispatch(const void* x, const void* g, void* out, long long n, long long d, long long xs,
             float eps, int rows, int tpr, int vpt, int vec, cudaStream_t s) {
#define RMSNORM_CASE(V)                                                                   \
  case V:                                                                                 \
    return vec ? launch<T, G, V, true>(x, g, out, n, d, xs, eps, rows, tpr, s)           \
               : launch<T, G, V, false>(x, g, out, n, d, xs, eps, rows, tpr, s);
  switch (vpt) {
    RMSNORM_CASE(1)
    RMSNORM_CASE(2)
    RMSNORM_CASE(4)
    RMSNORM_CASE(8)
    RMSNORM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RMSNORM_CASE
}

}  // namespace

// x: (n, d) rows `xs` elements apart; out: (n, d) contiguous; gamma: (d,) of
// x's dtype or f32. The CTA shape (rows per CTA, threads per row, vectors
// per thread) and the path (vec: 16-byte vectors, else one element at a
// time) come from kernels/rmsnorm.py; a shape that does not cover d or a
// vector path on unaligned data is refused.
extern "C" int rmsnorm_fwd(const void* x, const void* gamma, void* out, long long n,
                           long long d, long long xs, float eps, int dtype, int gamma_dtype,
                           int rows, int tpr, int vpt, int vec, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (gamma_dtype == kF32) {
    DISPATCH_DTYPE(dtype, return dispatch<scalar_t, float>(x, gamma, out, n, d, xs, eps, rows,
                                                           tpr, vpt, vec, s));
  }
  if (gamma_dtype != dtype) return (int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(dtype, return dispatch<scalar_t, scalar_t>(x, gamma, out, n, d, xs, eps, rows,
                                                            tpr, vpt, vec, s));
  return 0;
}

// ---------------------------------------------------------------------------
// Backward.
//
// The gradient of the forward for the output's gradient dy, in f32: with
// r = rsqrt(mean(x^2) + eps), xhat = x r and g = dy gamma,
//   dx = r (g - xhat mean(g xhat)),   dgamma = sum over rows of dy xhat',
// xhat' being xhat rounded to x's dtype, as the forward multiplies it. The
// Pallas kernel has no backward: the reference differentiates its plain
// rms_norm, and this is that gradient written out (plain version:
// kernels/ref.py:rmsnorm_bwd). The forward saves nothing but x and gamma, so
// r is recomputed from x.
//
// What bounds it on the H100: bytes, as the forward. x and dy are read and
// dx written (three times the forward's half), at ~12 flops an element.
//
// Design, simple first. Stage 1: a grid of n_cta CTAs (two per SM, the
// host's choice) walks the rows, CTA b taking rows b, b + n_cta, ... For
// each row the CTA makes two passes: the first reduces sum(x^2) and
// sum(g x) (warp shuffles, then one __syncthreads over per-warp sums,
// double-buffered across rows as in the forward); the second reads x and dy
// again (from L1: a row is 16 KB at d = 4096 in bf16), writes dx and adds
// dy xhat' into the CTA's partial of dgamma, d doubles of shared memory in
// which every column belongs to one thread. At the end the CTA stores its
// partial as row b of a workspace (n_cta, d). Stage 2 sums each column's
// n_cta partials in a fixed order into dgamma (in gamma's dtype). No
// atomics: two runs give the same bits.
//
// dgamma sums one term per row, 2048 of them at the training step's shape,
// and f32 sums in two different orders differ there by more than the f32
// tolerance (2e-5) wherever the terms cancel; so the sum is kept in f64
// (the products of two floats are exact in it), and the plain version sums
// in f64 too. Both then round the same near-exact sum. For the same reason
// the row sums (x^2, g x) are f64 and r is rsqrt in f64 rounded once to
// f32: an r one ulp off flips the bf16 rounding of some xhat', and a few
// flipped terms move a small dgamma by more than the bf16 tolerance.
namespace {

constexpr int kBwdThreads = 256;   // stage 1: threads per CTA
constexpr int kBwdMaxD = 16384;    // stage 1's f64 partial: 128 KB of shared memory
constexpr int kColGroups = 8;      // stage 2: row groups per column

template <typename T, typename G, bool kVec>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const G* __restrict__ gamma,
                 const T* __restrict__ dy, T* __restrict__ dx, double* __restrict__ ws,
                 long long n, int d, long long xs, long long dys, float eps) {
  constexpr int W = kVec ? kVecBytes / (int)sizeof(T) : 1;       // elements per vector
  constexpr int GQ = kVec ? W * (int)sizeof(G) / kVecBytes : 1;  // loads per gamma vector
  using XV = std::conditional_t<kVec, uint4, T>;
  using GV = std::conditional_t<kVec, uint4, G>;
  extern __shared__ double acc[];  // [W][nvec]: element k of vector v at k * nvec + v
  __shared__ double red[2][2][32];  // per-warp sums of x^2 and g x; alternate rows, halves

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, warps = blockDim.x >> 5;
  const int nvec = d / W;
  for (int v = t; v < nvec; v += blockDim.x) {
#pragma unroll
    for (int k = 0; k < W; ++k) acc[k * nvec + v] = 0.0;
  }

  int buf = 0;
  for (long long row = blockIdx.x; row < n; row += gridDim.x, buf ^= 1) {
    const XV* xr = reinterpret_cast<const XV*>(x + row * xs);
    const XV* dyr = reinterpret_cast<const XV*>(dy + row * dys);
    double ss = 0.0, sgx = 0.0;
    for (int v = t; v < nvec; v += blockDim.x) {
      const XV xv = xr[v], dv = dyr[v];
      GV gv[GQ];
#pragma unroll
      for (int q = 0; q < GQ; ++q) gv[q] = reinterpret_cast<const GV*>(gamma + (long long)v * W)[q];
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* de = reinterpret_cast<const T*>(&dv);
      const G* ge = reinterpret_cast<const G*>(gv);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const double xf = to_f32(xe[k]);
        ss = fma(xf, xf, ss);
        sgx = fma((double)(to_f32(de[k]) * to_f32(ge[k])), xf, sgx);
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    if (lane == 0) {
      red[buf][0][warp] = ss;
      red[buf][1][warp] = sgx;
    }
    __syncthreads();
    ss = 0.0;
    sgx = 0.0;
    for (int w = 0; w < warps; ++w) {
      ss += red[buf][0][w];
      sgx += red[buf][1][w];
    }
    const double rd = rsqrt(ss / (double)d + (double)eps);
    const float r = (float)rd;
    const float c = (float)(sgx * rd / (double)d);  // mean(g xhat)

    XV* dxr = reinterpret_cast<XV*>(dx + row * d);
    for (int v = t; v < nvec; v += blockDim.x) {
      const XV xv = xr[v], dv = dyr[v];
      GV gv[GQ];
#pragma unroll
      for (int q = 0; q < GQ; ++q) gv[q] = reinterpret_cast<const GV*>(gamma + (long long)v * W)[q];
      const T* xe = reinterpret_cast<const T*>(&xv);
      const T* de = reinterpret_cast<const T*>(&dv);
      const G* ge = reinterpret_cast<const G*>(gv);
      XV o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float xh = to_f32(xe[k]) * r;
        const float dyf = to_f32(de[k]);
        oe[k] = from_f32<T>(r * (dyf * to_f32(ge[k]) - xh * c));
        acc[k * nvec + v] += (double)dyf * (double)to_f32(from_f32<T>(xh));
      }
      dxr[v] = o;
    }
  }
  double* part = ws + (long long)blockIdx.x * d;
  for (int v = t; v < nvec; v += blockDim.x) {
#pragma unroll
    for (int k = 0; k < W; ++k) part[v * W + k] = acc[k * nvec + v];
  }
}

// dgamma[c] = the sum of ws[b][c] over b: 32 columns a CTA, kColGroups row
// groups summed apart and then in order, so the bits never change.
template <typename G>
__global__ void __launch_bounds__(32 * kColGroups)
rmsnorm_bwd_cols(const double* __restrict__ ws, int n_cta, int d, G* __restrict__ dgamma) {
  __shared__ double part[kColGroups][33];
  const int col = blockIdx.x * 32 + threadIdx.x, j = threadIdx.y;
  double s = 0.0;
  if (col < d) {
#pragma unroll 4
    for (int b = j; b < n_cta; b += kColGroups) s += ws[(long long)b * d + col];
  }
  part[j][threadIdx.x] = s;
  __syncthreads();
  if (j == 0 && col < d) {
    double total = 0.0;
    for (int i = 0; i < kColGroups; ++i) total += part[i][threadIdx.x];
    dgamma[col] = from_f32<G>((float)total);  // f64 -> f32 -> G, as torch's cast
  }
}

template <typename T, typename G, bool kVec>
int launch_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg, void* ws,
               long long n, long long d, long long xs, long long dys, float eps, int n_cta,
               cudaStream_t stream) {
  constexpr int W = kVec ? kVecBytes / (int)sizeof(T) : 1;
  if (n_cta < 1 || d < 1 || d > kBwdMaxD) return (int)cudaErrorInvalidValue;
  if (kVec && (d % W != 0 || xs % W != 0 || dys % W != 0 || !aligned16(x) || !aligned16(g) ||
               !aligned16(dy) || !aligned16(dx)))
    return (int)cudaErrorMisalignedAddress;
  const int smem = (int)(d * sizeof(double));
  auto rows = rmsnorm_bwd_rows<T, G, kVec>;
  // past 48 KB of shared memory a launch needs the kernel's opt-in; it is
  // given once per instantiation, for the largest row
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdMaxD * (int)sizeof(double));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  rows<<<n_cta, kBwdThreads, smem, stream>>>((const T*)x, (const G*)g, (const T*)dy, (T*)dx,
                                             (double*)ws, n, (int)d, xs, dys, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_cols<G><<<(unsigned)((d + 31) / 32), dim3(32, kColGroups), 0, stream>>>(
      (const double*)ws, n_cta, (int)d, (G*)dg);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, d) rows `xs` elements apart; dy: (n, d) rows `dys` apart; dx: (n, d)
// contiguous in x's dtype; gamma and dgamma: (d,) of x's dtype or f32; ws: an
// f64 workspace of n_cta x d. n_cta (stage 1's CTAs) and the path (vec:
// 16-byte vectors, else one element at a time) come from
// kernels/rmsnorm.py; a vector path on unaligned data is refused.
extern "C" int rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                           void* dgamma, void* ws, long long n, long long d, long long xs,
                           long long dys, float eps, int dtype, int gamma_dtype, int n_cta,
                           int vec, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (gamma_dtype == kF32) {
    DISPATCH_DTYPE(dtype, return vec ? launch_bwd<scalar_t, float, true>(
                                           x, gamma, dy, dx, dgamma, ws, n, d, xs, dys, eps,
                                           n_cta, s)
                                     : launch_bwd<scalar_t, float, false>(
                                           x, gamma, dy, dx, dgamma, ws, n, d, xs, dys, eps,
                                           n_cta, s));
  }
  if (gamma_dtype != dtype) return (int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(dtype, return vec ? launch_bwd<scalar_t, scalar_t, true>(
                                         x, gamma, dy, dx, dgamma, ws, n, d, xs, dys, eps,
                                         n_cta, s)
                                   : launch_bwd<scalar_t, scalar_t, false>(
                                         x, gamma, dy, dx, dgamma, ws, n, d, xs, dys, eps,
                                         n_cta, s));
  return 0;
}
