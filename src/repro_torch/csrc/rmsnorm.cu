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
#include <cooperative_groups.h>
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
// Arithmetic, fixed by the plain version. dgamma sums one term per row,
// 2048 of them at the training step's shape, and f32 sums in two orders
// differ there by more than the f32 tolerance (2e-5) wherever the terms
// cancel; so dgamma is summed in f64 (a product of two floats is exact in
// it). The row sums of x^2 and g x are f64 too and r is one rounding of an
// f64 rsqrt: an r one ulp off flips bf16 roundings of xhat', and a few
// flipped terms move a small dgamma past the bf16 tolerance. Only the
// order of the f64 additions is the kernel's own (and its f64 rsqrt is
// Newton's, good to an f64 ulp or two, which moves the f32 r only where
// it falls within that of an f32 rounding boundary).
//
// What bounds it on the H100: bytes. x and dy are read and dx written, 6
// bytes an element in bf16 (0.0150 ms at (2048, 4096) at 3.35 TB/s), at
// ~12 flops an element. In the way: each row needs a block-wide reduction
// between its two passes; the conversions to f64, 16 a clock per SM (3 an
// element, with the paired bf16 roundings ~1000 cycles of an SM's
// conversion pipe a 4096-wide row against ~1650 for its bytes at the
// card's rate); and the sum of dgamma across CTAs.
//
// Design: one cooperative launch of a persistent grid (as many CTAs as are
// resident, at most one per row; kernels/rmsnorm.py:rmsnorm_bwd_plan).
//  - CTA b takes a contiguous block of rows (sizes differing by at most
//    one: the order of every sum depends on (n, n_cta) alone). Thread t
//    owns vectors j * threads + t of every row, the same columns all along.
//  - Rows stream through a ring of `stages` shared-memory stages, one TMA
//    bulk copy per row per tensor (x, dy; gamma rides with row 0), each
//    stage with a full mbarrier. Both passes over a row read shared
//    memory, never device memory again; dx is stored from registers.
//  - Row i's pass 2 (dx, dgamma terms) and row i + 1's pass 1 (its sums)
//    run in one sweep over the thread's vectors, so a row costs one block
//    reduction and the two rows' conversions overlap. The reduction's
//    __syncthreads shows every warp is done with row i's stage, and thread
//    0 then refills it with row i + stages: no empty barrier, no wait.
//  - Each thread's f64 column sums of dgamma stay in registers across its
//    rows (at most kBwdMaxElems of them). At the end each CTA writes them as
//    row b of an f64 workspace (n_cta, d), the grid synchronises
//    (cooperative_groups; the launch refuses a grid that cannot be
//    co-resident instead of hanging), and CTA b sums its own slice of
//    columns over the n_cta partials: row groups b' = g, g + groups, ...
//    summed apart and then in group order. No atomics: two launches give
//    the same bits.
//  - Conversions: x is converted once for both row sums and dy gamma once
//    (its products with x are not exact in f32, so they stay f64 FMAs). For
//    bf16 and f16 x, dy xhat' is exact in f32 (8 x 8 and 11 x 11
//    significant bits fit in 24), so the dgamma term converts the product
//    once: 3 F2F.F64 an element where the two-launch design this replaces
//    had 4 (f32 x keeps 4), and xhat' and dx are rounded to bf16/f16 two
//    at a time (F2FP). In the SASS the passes appear more than once (row
//    0's pass 1, the fused sweep, the one-stage sweeps): a bf16/f16 vector
//    kernel holds VPT * W * (3 * 2 + 2 * 1) + 1 F2F.F64 (the one: eps).
// The scalar instantiation (kVec = false: one element per "vector") takes a
// d or a row stride that is not a whole number of 16-byte vectors, or
// unaligned data. It has no ring: the threads copy each row into one stage
// from device memory, then run the passes one after the other, with the
// same grid, register partials and in-launch sum. d is 1 ... 16384.
namespace {

constexpr int kBwdMaxD = 16384;
constexpr int kBwdMaxStages = 8;
constexpr int kBwdMaxElems = 32;  // f64 partials of dgamma a thread holds: 64 registers

// The most threads a CTA may have at `elems` elements per thread, kept equal
// to kernels/rmsnorm.py:bwd_max_threads: 64 registers a thread at 1024, 128
// at 512.
__host__ __device__ constexpr int bwd_max_threads(int elems) { return elems <= 8 ? 1024 : 512; }

template <typename T, bool kVec>
__host__ __device__ constexpr int bwd_width() {
  return kVec ? kVecBytes / (int)sizeof(T) : 1;
}

// a / d rounded to nearest, as the division a / (double)d: q = a * rcp, then
// one correction with the exact remainder (Markstein), rcp being 1 / d
// rounded to nearest. Inline: the division operator's slow-path call makes
// ptxas save registers to local memory around it.
__device__ __forceinline__ double div_by(double a, double d, double rcp) {
  const double q = a * rcp;
  return fma(fma(-q, d, a), rcp, q);
}

// 1 / sqrt(a) in f64 for a > 0 (here mean(x^2) + eps): MUFU.RSQ64H's
// estimate and Newton's iteration, inline. The math library's rsqrt adds a
// called slow path (zero, subnormal, infinite a) around which ptxas saves
// registers to local memory.
__device__ __forceinline__ double rsqrt_f64(double a) {
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(a));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = fma(0.5 * y, fma(-a * y, y, 1.0), y);
  return y;
}

// a and b rounded to T (to nearest even) by one paired conversion: `qa` and
// `qb` get them back as floats, `packed` the two T side by side.
template <typename T>
__device__ __forceinline__ void round_pair(float a, float b, float& qa, float& qb,
                                           uint32_t& packed) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    qa = __low2float(p);
    qb = __high2float(p);
    packed = *reinterpret_cast<const uint32_t*>(&p);
  } else if constexpr (std::is_same_v<T, __half>) {
    const __half2 p = __floats2half2_rn(a, b);
    qa = __low2float(p);
    qb = __high2float(p);
    packed = *reinterpret_cast<const uint32_t*>(&p);
  } else {
    qa = a;
    qb = b;
    packed = 0;
  }
}

template <typename T, typename G, int VPT, bool kVec>
__global__ void __launch_bounds__(bwd_max_threads(VPT * bwd_width<T, kVec>()))
rmsnorm_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                   const T* __restrict__ dy, T* __restrict__ dx, G* __restrict__ dgamma,
                   double* __restrict__ ws, int n, int d, long long xs, long long dys,
                   float eps, double rcp_d, int stages) {
  constexpr int W = bwd_width<T, kVec>();                    // elements per vector
  constexpr int GW = kVec ? kVecBytes / (int)sizeof(G) : 1;  // gamma elements a 16-byte load
  constexpr bool kPair = kVec && sizeof(T) == 2;             // bf16/f16 vectors: paired roundings
  using XV = std::conditional_t<kVec, uint4, T>;
  // [stages][x row, dy row], then gamma: on the vector path as G, brought by
  // the TMA with the first row; on the scalar path one stage, filled by the
  // threads, and gamma as f32
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[kBwdMaxStages];
  __shared__ double red[2][2][32];  // per-warp sums of x^2 and g x; alternate rows, halves

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nt = blockDim.x, warps = nt >> 5, nvec = d / W;
  const int b = blockIdx.x, n_cta = gridDim.x;
  const int rq = n / n_cta, rr = n % n_cta;
  const int r0 = b * rq + (b < rr ? b : rr);  // this CTA's rows: r0 ... r0 + cnt - 1
  const int cnt = rq + (b < rr);
  const int ring = kVec ? stages : 1;
  const uint32_t row_bytes = (uint32_t)d * (uint32_t)sizeof(T);
  const uint32_t stage_bytes = 2 * row_bytes;
  unsigned char* gsm = smem + (size_t)ring * stage_bytes;
  const double dd = (double)d;

  // stage s's x row (its dy row follows it)
  auto stage_x = [&](int s) { return reinterpret_cast<const T*>(smem + (size_t)s * stage_bytes); };
  // thread 0: row `row` into stage s by TMA, once the block is done reading it
  auto refill = [&](int s, long long row) {
    unsigned char* st = smem + (size_t)s * stage_bytes;
    fence_proxy_async();  // the block's reads of the stage before the copy's writes
    mbar_expect_tx(&full[s], stage_bytes);
    bulk_load(st, x + row * xs, row_bytes, &full[s]);
    bulk_load(st + row_bytes, dy + row * dys, row_bytes, &full[s]);
  };
  // the scalar path's stage: row `row` copied in by every thread
  auto copy_row = [&](long long row) {
    T* sx = reinterpret_cast<T*>(smem);
#pragma unroll 4
    for (int i = t; i < d; i += nt) {
      sx[i] = x[row * xs + i];
      sx[d + i] = dy[row * dys + i];
    }
  };

  if constexpr (kVec) {
    if (t == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
      mbar_fence_init();
      const uint32_t gamma_bytes = (uint32_t)d * (uint32_t)sizeof(G);  // with row 0
      mbar_expect_tx(&full[0], stage_bytes + gamma_bytes);
      bulk_load(gsm, gamma, gamma_bytes, &full[0]);
      bulk_load(smem, x + (long long)r0 * xs, row_bytes, &full[0]);
      bulk_load(smem + row_bytes, dy + (long long)r0 * dys, row_bytes, &full[0]);
      for (int i = 1; i < stages && i < cnt; ++i) refill(i, (long long)r0 + i);
    }
  } else {  // gamma as f32, the thread's own elements in one burst of loads
    float* gs = reinterpret_cast<float*>(gsm);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int i = j * nt + t;
      if (i < d) gs[i] = to_f32(gamma[i]);
    }
    copy_row(r0);
  }
  __syncthreads();

  auto gamma_at = [&](int v, float (&ge)[W]) {
    if constexpr (kVec) {
      const uint4* g = reinterpret_cast<const uint4*>(gsm) + v * (W / GW);
#pragma unroll
      for (int q = 0; q < W / GW; ++q) {
        const uint4 u = g[q];
        const G* e = reinterpret_cast<const G*>(&u);
#pragma unroll
        for (int k = 0; k < GW; ++k) ge[q * GW + k] = to_f32(e[k]);
      }
    } else {
      ge[0] = reinterpret_cast<const float*>(gsm)[v];
    }
  };

  // The threads' vector indices j * nt + t go through copies that every row
  // hides from the optimiser (`opaque`): otherwise the compiler keeps all
  // VPT offsets of each of x, dy, gamma and dx live across the row loop
  // (scalar path: 32 of each) and spills.
  int nt_r = nt, t_r = t;

  // vector j of the thread's share of a row: `pass(v, gamma)` with its index
  // and gamma (one load of gamma for both rows of a fused sweep). The scalar
  // path holds an element, not a 16-byte vector, in each register it loads:
  // a warp barrier every 8 elements keeps ptxas from hoisting all of a
  // pass's loads (and spilling).
  auto each = [&](int j, auto&& pass) {
    const int v = j * nt_r + t_r;
    if (v < nvec) {
      float ge[W];
      gamma_at(v, ge);
      pass(v, ge);
    }
    if constexpr (!kVec) {
      if (j % 8 == 7) __syncwarp();
    }
  };

  // pass 1 over vector v of a row: sum(x^2) and sum(g x), f64
  auto pass1 = [&](const T* xr, int v, const float (&ge)[W], double& ss, double& sgx) {
    const XV xv = reinterpret_cast<const XV*>(xr)[v];
    const XV dv = reinterpret_cast<const XV*>(xr + d)[v];
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* de = reinterpret_cast<const T*>(&dv);
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const double xf = to_f32(xe[k]);
      ss = fma(xf, xf, ss);
      sgx = fma((double)(to_f32(de[k]) * ge[k]), xf, sgx);
    }
  };

  double acc[VPT][W];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
#pragma unroll
    for (int k = 0; k < W; ++k) acc[j][k] = 0.0;
  }

  // pass 2 over vector v (the thread's j-th) of row `row`: dx, and dy xhat'
  // into the register partials of dgamma
  float r = 0.f, c = 0.f;  // the row's scale and mean(g xhat)
  auto pass2 = [&](const T* xr, long long row, int j, int v, const float (&ge)[W]) {
    const XV xv = reinterpret_cast<const XV*>(xr)[v];
    const XV dv = reinterpret_cast<const XV*>(xr + d)[v];
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* de = reinterpret_cast<const T*>(&dv);
    XV o;
    if constexpr (kPair) {
      uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int k = 0; k < W; k += 2) {
        float xq0, xq1, unused0, unused1;
        uint32_t unused;
        const float xh0 = to_f32(xe[k]) * r, xh1 = to_f32(xe[k + 1]) * r;
        const float dy0 = to_f32(de[k]), dy1 = to_f32(de[k + 1]);
        round_pair<T>(r * (dy0 * ge[k] - xh0 * c), r * (dy1 * ge[k + 1] - xh1 * c), unused0,
                      unused1, op[k / 2]);
        round_pair<T>(xh0, xh1, xq0, xq1, unused);
        acc[j][k] += (double)(dy0 * xq0);  // exact in f32: one conversion
        acc[j][k + 1] += (double)(dy1 * xq1);
      }
    } else {
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const float xh = to_f32(xe[k]) * r;
        const float dyf = to_f32(de[k]);
        oe[k] = from_f32<T>(r * (dyf * ge[k] - xh * c));
        const float xq = to_f32(from_f32<T>(xh));
        if constexpr (sizeof(T) == 2)
          acc[j][k] += (double)(dyf * xq);
        else
          acc[j][k] += (double)dyf * (double)xq;
      }
    }
    reinterpret_cast<XV*>(dx + row * d)[v] = o;
  };

  // the block's sums of row k (parity k & 1 of `red`) -> r and c
  auto reduce = [&](int k, double ss, double sgx) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, off);
    }
    const int buf = k & 1;
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
    const double rd = rsqrt_f64(div_by(ss, dd, rcp_d) + (double)eps);
    r = (float)rd;
    c = (float)div_by(sgx * rd, dd, rcp_d);  // mean(g xhat)
  };

  // Row i's pass 2 runs in the same sweep over the thread's vectors as row
  // i + 1's pass 1 where both rows are in the ring (two stages or more), so
  // each row costs one block reduction and the two rows' conversions
  // overlap; with one stage the passes run one after the other.
  int s = 0;
  uint32_t phase = 0;
  if constexpr (kVec) mbar_wait(&full[0], 0);
  {
    double ss = 0.0, sgx = 0.0;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      each(j, [&](int v, const float (&ge)[W]) { pass1(stage_x(0), v, ge, ss, sgx); });
    reduce(0, ss, sgx);
  }
  for (int i = 0; i < cnt; ++i) {
    opaque(nt_r);
    opaque(t_r);
    const long long row = (long long)r0 + i;
    const bool next = i + 1 < cnt;
    const int s1 = s + 1 == ring ? 0 : s + 1;  // row i + 1's stage
    const uint32_t phase1 = s1 == 0 ? phase ^ 1 : phase;
    double ss = 0.0, sgx = 0.0;
    if (kVec && ring > 1 && next) {
      mbar_wait(&full[s1], phase1);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        each(j, [&](int v, const float (&ge)[W]) {
          pass2(stage_x(s), row, j, v, ge);
          // a warp barrier between the two rows' loads: without it ptxas
          // hoists both and squeezes the bf16 kernels into 64 registers,
          // spilling
          __syncwarp();
          pass1(stage_x(s1), v, ge, ss, sgx);
        });
      }
    } else {
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        each(j, [&](int v, const float (&ge)[W]) { pass2(stage_x(s), row, j, v, ge); });
    }
    if (next && !(kVec && ring > 1)) {  // one stage: row i + 1 after row i
      __syncthreads();  // every thread is done with row i
      if constexpr (kVec) {
        if (t == 0) refill(s, row + 1);
        mbar_wait(&full[s1], phase1);
      } else {
        copy_row(row + 1);
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        each(j, [&](int v, const float (&ge)[W]) { pass1(stage_x(s1), v, ge, ss, sgx); });
    }
    if (next) reduce(i + 1, ss, sgx);
    // the reduction's barrier is the proof that every warp is done with row
    // i's stage: thread 0 refills it with row i + stages without waiting
    if (kVec && ring > 1 && t == 0 && i + stages < cnt) refill(s, row + stages);
    s = s1;
    phase = phase1;
  }

  // this CTA's partial of dgamma: row b of the workspace
  double* part = ws + (long long)b * d;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int v = j * nt + t;
    if (v < nvec) {
      if constexpr (W % 2 == 0) {  // 16-byte stores
        double2* p2 = reinterpret_cast<double2*>(part + (long long)v * W);
#pragma unroll
        for (int k = 0; k < W; k += 2) p2[k / 2] = make_double2(acc[j][k], acc[j][k + 1]);
      } else {
        part[v] = acc[j][0];
      }
    }
  }
  cooperative_groups::this_grid().sync();

  // CTA b sums its slice of columns, cw at a time (cw: the power of two up
  // to 32 that covers the widest slice), over the n_cta partials: thread t
  // takes column t % cw and partials t / cw, t / cw + groups, ... in order,
  // then the groups' sums are added in order (kernels/rmsnorm.py:
  // bwd_col_groups).
  const int cq = d / n_cta, cr = d % n_cta;
  const int c0 = b * cq + (b < cr ? b : cr);
  const int c1 = c0 + cq + (b < cr);
  const int widest = cq + (cr > 0);
  int cw = 1;
  while (cw < widest && cw < 32) cw <<= 1;
  const int groups = nt / cw, gi = t / cw, li = t - gi * cw;
  double* cbuf = reinterpret_cast<double*>(smem);  // the ring and gamma are done with
  for (int base = c0; base < c1; base += cw) {
    const int col = base + li;
    double sum = 0.0;
    if (col < c1) {  // 16 loads in flight, then added in order
      const double* p = ws + col;
      int bb = gi;
      for (; bb + 15 * groups < n_cta; bb += 16 * groups) {
        double v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = __ldcg(p + (long long)(bb + u * groups) * d);
#pragma unroll
        for (int u = 0; u < 16; ++u) sum += v[u];
      }
      for (; bb < n_cta; bb += groups) sum += __ldcg(p + (long long)bb * d);
    }
    cbuf[t] = sum;
    __syncthreads();
    if (t < cw && col < c1) {
      double total = 0.0;
      for (int g = 0; g < groups; ++g) total += cbuf[g * cw + t];
      dgamma[col] = from_f32<G>((float)total);  // f64 -> f32 -> G, as torch's cast
    }
    __syncthreads();
  }
}

template <typename T, typename G, int VPT, bool kVec>
int launch_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg, void* ws,
               long long n, long long d, long long xs, long long dys, float eps, int threads,
               int stages, int n_cta, cudaStream_t stream) {
  constexpr int W = bwd_width<T, kVec>();
  constexpr int E = VPT * W;
  if constexpr (E > kBwdMaxElems) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n_cta < 1 || n_cta > n || n > INT32_MAX || d < 1 || d > kBwdMaxD || threads < 32 ||
        threads % 32 != 0 ||
        threads > bwd_max_threads(E) || (long long)threads * E < d ||
        (kVec ? stages < 1 || stages > kBwdMaxStages : stages != 0))
      return (int)cudaErrorInvalidValue;
    if (kVec && (d % W != 0 || xs % W != 0 || dys % W != 0 || !aligned16(x) || !aligned16(g) ||
                 !aligned16(dy) || !aligned16(dx)))
      return (int)cudaErrorMisalignedAddress;
    auto kernel = rmsnorm_bwd_kernel<T, G, VPT, kVec>;
    // opt in once per instantiation to all the dynamic shared memory a block
    // may have beside the kernel's static part
    static int max_dyn = -1;
    if (max_dyn < 0) {
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
      if (e != cudaSuccess) return (int)e;
      int dev = 0, optin = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      const int room = optin - (int)attr.sharedSizeBytes;
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
      if (e != cudaSuccess) return (int)e;
      // all of the SM's unified memory as shared memory: the rows arrive by
      // TMA and gamma is staged, so L1 has little to hold
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return (int)e;
      max_dyn = room;
    }
    const long long ring = (long long)(kVec ? stages : 1) * 2 * d * (long long)sizeof(T);
    const long long need = ring + d * (long long)(kVec ? sizeof(G) : sizeof(float));
    const long long smem = need > 8LL * threads ? need : 8LL * threads;
    if (smem > max_dyn) return (int)cudaErrorInvalidValue;  // the plan needs more than a block has
    // a cooperative grid must be co-resident: refuse one that is not (the
    // launch would too) rather than let it wait on CTAs that never run
    int dev = 0, n_sm = 0, resident = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads,
                                                                        (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    if ((long long)resident * n_sm < n_cta) return (int)cudaErrorCooperativeLaunchTooLarge;
    const T* xa = (const T*)x;
    const G* ga = (const G*)g;
    const T* dya = (const T*)dy;
    T* dxa = (T*)dx;
    G* dga = (G*)dg;
    double* wsa = (double*)ws;
    int ni = (int)n, di = (int)d;
    double rcp_d = 1.0 / (double)d;
    void* args[] = {&xa, &ga, &dya, &dxa, &dga, &wsa, &ni, &di, &xs, &dys, &eps, &rcp_d,
                    &stages};
    return (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)n_cta),
                                            dim3((unsigned)threads), args, (size_t)smem, stream);
  }
}

template <typename T, typename G>
int dispatch_bwd(const void* x, const void* g, const void* dy, void* dx, void* dg, void* ws,
                 long long n, long long d, long long xs, long long dys, float eps, int threads,
                 int vpt, int stages, int n_cta, int vec, cudaStream_t s) {
#define RMSNORM_BWD_CASE(V, VEC)                                                              \
  case V:                                                                                     \
    return launch_bwd<T, G, V, VEC>(x, g, dy, dx, dg, ws, n, d, xs, dys, eps, threads, stages, \
                                    n_cta, s);
  if (vec) {
    switch (vpt) {
      RMSNORM_BWD_CASE(1, true)
      RMSNORM_BWD_CASE(2, true)
      RMSNORM_BWD_CASE(4, true)
      RMSNORM_BWD_CASE(8, true)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (vpt) {
    RMSNORM_BWD_CASE(1, false)
    RMSNORM_BWD_CASE(2, false)
    RMSNORM_BWD_CASE(4, false)
    RMSNORM_BWD_CASE(8, false)
    RMSNORM_BWD_CASE(16, false)
    RMSNORM_BWD_CASE(32, false)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RMSNORM_BWD_CASE
}

}  // namespace

// x: (n, d) rows `xs` elements apart; dy: (n, d) rows `dys` apart; dx: (n, d)
// contiguous in x's dtype; gamma and dgamma: (d,) of x's dtype or f32; ws: an
// f64 workspace of n_cta x d. The plan (threads per CTA, vectors per
// thread, ring stages, CTAs) and the path (vec: 16-byte vectors through the
// ring, else one element at a time from device memory) come from
// kernels/rmsnorm.py:rmsnorm_bwd_plan. A plan that does not cover d, needs
// more shared memory than a block has or more CTAs than can be resident,
// or a vector path on unaligned data, is refused.
extern "C" int rmsnorm_bwd(const void* x, const void* gamma, const void* dy, void* dx,
                           void* dgamma, void* ws, long long n, long long d, long long xs,
                           long long dys, float eps, int dtype, int gamma_dtype, int threads,
                           int vpt, int stages, int n_cta, int vec, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (gamma_dtype == kF32) {
    DISPATCH_DTYPE(dtype, return dispatch_bwd<scalar_t, float>(x, gamma, dy, dx, dgamma, ws, n,
                                                               d, xs, dys, eps, threads, vpt,
                                                               stages, n_cta, vec, s));
  }
  if (gamma_dtype != dtype) return (int)cudaErrorInvalidValue;
  DISPATCH_DTYPE(dtype, return dispatch_bwd<scalar_t, scalar_t>(x, gamma, dy, dx, dgamma, ws, n,
                                                                d, xs, dys, eps, threads, vpt,
                                                                stages, n_cta, vec, s));
  return 0;
}
