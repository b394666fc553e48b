// Flash-decoding for Hopper: one query token per sequence against its KV cache.
//
// Replaces src/repro/kernels/decode_attention.py:decode_attention (Pallas
// `_kernel`): slot validity from absolute positions (kv_pos < 0 empty,
// kv_pos > pos future, kv_pos <= pos - window outside a ring cache's
// window), online softmax with (m, l, acc) in f32, rows with no valid slot
// emit 0.
//
// Bound on the H100: bytes. Each valid cache slot's K and V row is read once
// and used for G query heads' ~4 dh flops, about one flop per byte. Design:
// one CTA of 128 threads per (batch row, KV head) holds all G query heads of
// that KV head, so each K/V row is read from device memory once (the Pallas
// grid re-reads it per query head). The cache is walked in tiles of 64
// slots; a tile's positions are read first and a tile with no valid slot is
// skipped whole, and within a tile only valid slots' K and V rows are read,
// so a short sequence in a long cache costs its length, not the capacity.
// The valid rows of a tile are staged in shared memory with 16-byte loads,
// unrolled so that every thread keeps several in flight (a CTA that waited
// on one load at a time spent ~0.45 ms on a 576-slot cache). Scores: one
// warp per slot, lanes across dh, shuffle reduction. Mix: one thread per dh
// column. The cache is read through strides, so the model's (B, Sc, K, dh)
// layout needs no transpose. Split-K across CTAs, for few long sequences
// that leave most SMs idle, comes later.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64, kThreads = 128, kWarps = kThreads / 32, kMaxG = 8;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_pos,
                        const int* __restrict__ pos, T* __restrict__ o, int G, int Sc,
                        long long q_sb, long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                        long long p_sb, long long o_sb, long long o_sh, int window,
                        float scale, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // kTile x DH, raw cache dtype
  T* Vs = Ks + kTile * DH;
  __shared__ float Qs[kMaxG][DH];
  __shared__ float Ps[kMaxG][kTile];
  __shared__ int valid[kTile];
  __shared__ float g_m[kMaxG], g_l[kMaxG], g_c[kMaxG];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int qpos = pos[b];
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int* pb = kv_pos + b * p_sb;

  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    Qs[g][d] = to_f32(q[b * q_sb + (kvh * G + g) * q_sh + d]);
  }
  if (tid < G) {
    g_m[tid] = kNegInf;
    g_l[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int s0 = 0; s0 < Sc; s0 += kTile) {
    __syncthreads();  // previous tile's Ps/valid reads are done
    int ok = 0;
    if (tid < kTile) {
      const int s = s0 + tid;
      if (s < Sc) {
        const int kp = pb[s];
        ok = kp >= 0 && kp <= qpos && (window <= 0 || kp > qpos - window);
      }
      valid[tid] = ok;
    }
    if (!__syncthreads_or(ok)) continue;  // no valid slot: skip the tile's K/V

    // Stage the valid rows' K and V in shared memory.
    if (vec) {
      constexpr int CH = DH * (int)sizeof(T) / 16;  // 16-byte chunks per row
      constexpr int ITERS = (kTile * CH + kThreads - 1) / kThreads;
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int i = tid + it * kThreads, r = i / CH, c = i % CH;
        if (i < kTile * CH && valid[r]) {
          const long long off = (long long)(s0 + r);
          reinterpret_cast<uint4*>(Ks + r * DH)[c] =
              reinterpret_cast<const uint4*>(kb + off * k_ss)[c];
          reinterpret_cast<uint4*>(Vs + r * DH)[c] =
              reinterpret_cast<const uint4*>(vb + off * v_ss)[c];
        }
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < kTile * DH; i += kThreads) {
        const int r = i / DH, c = i % DH;
        if (valid[r]) {
          const long long off = (long long)(s0 + r);
          Ks[i] = kb[off * k_ss + c];
          Vs[i] = vb[off * v_ss + c];
        }
      }
    }
    __syncthreads();

    // Scores: warp w takes slots w, w + 4, ...
    for (int j = warp; j < kTile; j += kWarps) {
      if (!valid[j]) {
        if (lane < G) Ps[lane][j] = kNegInf;
        continue;
      }
      const T* kr = Ks + j * DH;
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
#pragma unroll
      for (int d = lane; d < DH; d += 32) {
        const float kd = to_f32(kr[d]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) part[g] = fmaf(Qs[g][d], kd, part[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float sc = warp_sum(part[g]);
          if (lane == 0) Ps[g][j] = sc * scale;
        }
      }
    }
    __syncthreads();

    // Online softmax: warp g takes query head g.
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, Ps[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = g_m[g];
      const float m_new = fmaxf(m_prev, mx);
      const bool dead = m_new <= kNegInf / 2;
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float p = dead ? 0.f : expf(Ps[g][j] - m_new);
        Ps[g][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        g_l[g] = g_l[g] * corr + sum;
        g_m[g] = m_new;
        g_c[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: thread tid owns column tid of every head.
    if (tid < DH) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= g_c[g];
      for (int j = 0; j < kTile; ++j) {
        if (!valid[j]) continue;  // p is exactly 0 there
        const float vd = to_f32(Vs[j * DH + tid]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] = fmaf(Ps[g][j], vd, acc[g]);
      }
    }
  }
  __syncthreads();

  if (tid < DH) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float inv = 1.f / fmaxf(g_l[g], 1e-30f);
        o[b * o_sb + (kvh * G + g) * o_sh + tid] = from_f32<T>(acc[g] * inv);
      }
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* kv_pos, const int* pos,
           void* o, int B, int K, int G, int Sc, const long long* st, int window,
           float scale, cudaStream_t stream) {
  constexpr int bytes = 2 * kTile * DH * (int)sizeof(T);
  auto kern = decode_attention_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  // 16-byte loads need 16-byte aligned rows: base pointers and every stride.
  constexpr long long V = 16 / sizeof(T);
  const bool vec = ((uintptr_t)k % 16) == 0 && ((uintptr_t)v % 16) == 0 &&
                   st[2] % V == 0 && st[3] % V == 0 && st[4] % V == 0 &&
                   st[5] % V == 0 && st[6] % V == 0 && st[7] % V == 0;
  const dim3 grid((unsigned)K, (unsigned)B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_pos, pos, (T*)o, G, Sc, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], window, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, dh); k, v: (B, Sc, K, dh); kv_pos: (B, Sc) int32; pos: (B,)
// int32. Element strides: q (batch, head), k and v (batch, slot, head),
// kv_pos (batch), o (batch, head); the dh axis is contiguous. H = K * G,
// G <= 8.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_pos, const void* pos, void* o, int B,
                                    int H, int K, int Sc, long long q_sb, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long p_sb, long long o_sb, long long o_sh,
                                    int dh, int window, float scale, int dtype,
                                    void* stream) {
  if (B == 0 || H == 0) return 0;
  const int G = H / K;
  if (G > kMaxG || G * K != H) return (int)cudaErrorInvalidValue;
  const long long st[11] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb,
                            v_ss, v_sh, p_sb, o_sb, o_sh};
  const int* kp = (const int*)kv_pos;
  const int* ps = (const int*)pos;
  cudaStream_t s = (cudaStream_t)stream;
#define DECODE_CASE(D)                                                              \
  case D:                                                                           \
    DISPATCH_DTYPE(dtype, return launch<scalar_t, D>(q, k, v, kp, ps, o, B, K, G, Sc, \
                                                     st, window, scale, s));        \
    break;
  switch (dh) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_CASE
  return 0;
}
