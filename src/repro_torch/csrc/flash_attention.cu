// Prefill flash attention for Hopper: tiled online softmax, f32 accumulation.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (Pallas
// `_kernel`): causal, sliding-window and padded-KV (kv_len) masks over
// arange positions, GQA by head h -> h / G, (m, l, acc) kept in f32, and
// rows with no valid key emit 0 (m starts at -1e30 and p is zeroed while
// m <= -5e29).
//
// Bound on the H100: operations. At prefill lengths the scores and the mix
// do ~4 * Sq * Sk * dh flops per head on ~(Sq + 2 Sk) * dh elements read, so
// above a few hundred tokens the arithmetic, not the bytes, sets the floor.
// Design (simple first, not yet fast): one CTA of 256 threads per
// (64-row query tile, head, batch); K/V tiles of 64 keys are staged in shared
// memory as f32 and the Q tile stays resident; scores and P.V are plain f32
// FMA (the Pallas kernel also upcasts to f32), each thread owning a 4 x 4
// block of scores and a 4 x dh/16 block of the accumulator in registers.
// Tiles wholly above the causal diagonal or before the window are skipped,
// which changes no result: their p is exactly 0. The kernel reads q, k, v
// and writes o through strides, so the model layout q (B, S, K*G, dh),
// k/v (B, S, K, dh) needs no transpose copy. wgmma/TMA come later.
#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;

template <int DH>
constexpr int smem_floats() {
  return kBQ * (DH + 1) + kBK * (DH + 1) + kBK * DH + kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int G, int Sq,
                       int Sk, long long q_sb, long long q_ss, long long q_sh,
                       long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                       long long o_sh, int causal, int window, int kv_len, float scale) {
  constexpr int DP = DH + 1;   // padded Q/K rows: conflict-free column reads
  constexpr int PP = kBK + 1;  // padded P rows
  constexpr int NJ = DH / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // kBQ x DP
  float* Ks = Qs + kBQ * DP;       // kBK x DP
  float* Vs = Ks + kBK * DP;       // kBK x DH
  float* Ps = Vs + kBK * DH;       // kBQ x PP: scores, then probabilities
  float* row_m = Ps + kBQ * PP;    // running max
  float* row_l = row_m + kBQ;      // running denominator
  float* row_c = row_l + kBQ;      // this tile's correction exp(m_prev - m_new)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, c = i % DH, qi = q0 + r;
    Qs[r * DP + c] = qi < Sq ? to_f32(qb[qi * q_ss + c]) : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.f;
  }

  // Key range that can hold a valid key for some row of this tile.
  int k_end = min(Sk, kv_len);
  if (causal) k_end = min(k_end, q0 + kBQ);
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / kBK) * kBK;

  const int tx = tid % 16, ty = tid / 16;  // rows ty + 16 i, columns tx + 16 j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's K/V/P reads are done
    for (int i = tid; i < kBK * DH; i += kThreads) {
      const int r = i / DH, c = i % DH, kj = k0 + r;
      const bool in = kj < Sk;
      Ks[r * DP + c] = in ? to_f32(kb[kj * k_ss + c]) : 0.f;
      Vs[r * DH + c] = in ? to_f32(vb[kj * v_ss + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 block, masked, into Ps.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        bool ok = kpos < kv_len && kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        Ps[r * PP + c] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: 4 neighbouring lanes per row.
    {
      const int r = tid / 4, part = tid % 4;
      float mx = kNegInf;
      for (int c = part; c < kBK; c += 4) mx = fmaxf(mx, Ps[r * PP + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const bool dead = m_new <= kNegInf / 2;  // no valid key so far
      float sum = 0.f;
      for (int c = part; c < kBK; c += 4) {
        const float p = dead ? 0.f : expf(Ps[r * PP + c] - m_new);
        Ps[r * PP + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_c[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = row_c[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    T* orow = o + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
           int Sq, int Sk, const long long* st, int causal, int window, int kv_len,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H / K, Sq, Sk, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal, window,
      kv_len, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, dh); k, v: (B, Sk, K, dh); element strides (batch, seq,
// head) for q, k, v, o in that order; the dh axis is contiguous.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int K, int Sq, int Sk,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   int dh, int causal, int window, int kv_len,
                                   float scale, int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(D)                                                                \
  case D:                                                                            \
    DISPATCH_DTYPE(dtype, return launch<scalar_t, D>(q, k, v, o, B, H, K, Sq, Sk, st, \
                                                     causal, window, kv_len, scale, s)); \
    break;
  switch (dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return 0;
}
