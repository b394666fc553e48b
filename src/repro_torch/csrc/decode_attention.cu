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
//
//  * Grid (splits, K, B). A CTA of 128 threads holds all G query heads of
//    one KV head, so each K/V row is read from device memory once (the
//    Pallas grid re-reads it per query head), and walks its split: a range
//    of whole 64-slot tiles. The wrapper picks the split count so that few
//    long sequences still fill the card (batch 1, 32 KV heads, 576 slots:
//    5 splits, 160 CTAs); at B * K >= the SM count it is 1 and the kernel
//    writes the output itself.
//  * A CTA first reads all positions of its range (one burst) into
//    per-tile validity masks, so a tile with no valid slot is skipped before
//    any K/V byte is read and a short sequence in a long cache costs its
//    length. The valid rows of the next non-empty tile are copied with
//    cp.async (16 bytes a thread, chunks XOR-swizzled per row against bank
//    conflicts) into the second stage of a two-stage ring while this tile is
//    computed.
//  * Scores: two threads per slot, shuffle-combined; softmax: one warp per
//    query head; mix: each thread a column pair over a group of rows, fully
//    unrolled (rows that were not copied are zeroed and have p = 0), the
//    row groups summed once at the end. G has a compile-time bound (1 for
//    MHA) so the loops over query heads carry no guard there.
//  * The merge is in the same launch: every split writes its f32 (m, l,
//    acc) to scratch, and the last CTA of a (row, KV head) to arrive (an
//    atomic counter taken after a fence) merges all splits in split order,
//    writes the output and resets the counter to 0. The fixed order makes
//    the output bit-identical from call to call; one launch per call keeps
//    the host-bound decode step at one launch per layer.
#include "common.cuh"

namespace {

constexpr int kTile = 64, kThreads = 128, kWarps = kThreads / 32, kMaxG = 8;
constexpr int kMaxSplits = 64;  // = kTile: the merge weights reuse the score buffer
constexpr int kPassTiles = 32;  // tiles whose positions one pass holds
constexpr unsigned kFull = 0xffffffffu;

// Two neighbouring elements of a row as f32.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// GMAX: a compile-time bound on G (1 for MHA, so its loops carry no guard).
template <typename T, int DH, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_pos,
                        const int* __restrict__ pos, T* __restrict__ o, float* __restrict__ part,
                        int* __restrict__ counters, int G, int Sc, int tiles_per_split,
                        long long q_sb, long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                        long long p_sb, long long o_sb, long long o_sh, int window,
                        float scale) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = DH / EPC;              // chunks per row
  constexpr int SWM = (CH < 8 ? CH : 8) - 1;  // chunk swizzle: c ^ (row & SWM)
  constexpr int ITERS = kTile * CH / kThreads;
  constexpr int PAIRS = DH / 2;          // mix: one thread per column pair ...
  constexpr int RG = kThreads / PAIRS;   // ... and row group
  constexpr int RPG = kTile / RG;        // rows per group
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [2][kTile][DH], raw cache dtype
  T* Vs = Ks + 2 * kTile * DH;
  float* red = reinterpret_cast<float*>(smem);  // [RG][GMAX][DH] after the last tile
  __shared__ __align__(16) float Qs[GMAX][DH];
  __shared__ float Ps[GMAX][kTile];  // scores, then probabilities; merge weights
  __shared__ uint32_t masks[2 * kPassTiles];
  __shared__ float g_m[GMAX], g_l[GMAX], g_c[GMAX];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y;
  const int qpos = pos[b];
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int* pb = kv_pos + b * p_sb;
  const int n_tiles = (Sc + kTile - 1) / kTile;
  const int t_lo = split * tiles_per_split, t_hi = min(t_lo + tiles_per_split, n_tiles);
  const int cp = tid % PAIRS, rg = tid / PAIRS;  // the mix's column pair and row group

  if (tid < G) {
    g_m[tid] = kNegInf;
    g_l[tid] = 0.f;
  }
  float acc[GMAX][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int pass_lo = t_lo; pass_lo < t_hi; pass_lo += kPassTiles) {
    const int pass_hi = min(pass_lo + kPassTiles, t_hi);
    // Validity of every slot of the pass, 32 slots a word: the position loads
    // are issued first, beside the first pass's Q load.
    {
      constexpr int PER_WARP = 2 * kPassTiles / kWarps;
      const int n_words = 2 * (pass_hi - pass_lo);
      int kp[PER_WARP];
#pragma unroll
      for (int it = 0; it < PER_WARP; ++it) {
        const int s = pass_lo * kTile + (warp + it * kWarps) * 32 + lane;
        kp[it] = (warp + it * kWarps < n_words && s < Sc) ? pb[s] : -1;
      }
      if (pass_lo == t_lo) {
        for (int i = tid; i < G * DH; i += kThreads) {
          const int g = i / DH, d = i % DH;
          Qs[g][d] = to_f32(q[b * q_sb + (kvh * G + g) * q_sh + d]);
        }
      }
#pragma unroll
      for (int it = 0; it < PER_WARP; ++it) {
        const bool ok = kp[it] >= 0 && kp[it] <= qpos && (window <= 0 || kp[it] > qpos - window);
        const uint32_t m = __ballot_sync(kFull, ok);
        if (lane == 0 && warp + it * kWarps < n_words) masks[warp + it * kWarps] = m;
      }
    }
    __syncthreads();

    auto lo_bits = [&](int t) { return masks[2 * (t - pass_lo)]; };
    auto hi_bits = [&](int t) { return masks[2 * (t - pass_lo) + 1]; };
    auto next_tile = [&](int t) {
      while (t < pass_hi && (lo_bits(t) | hi_bits(t)) == 0) ++t;
      return t;
    };
    // Copy the valid rows of tile t into stage st; zero the others, so that
    // the mix can run over all rows (their p is exactly 0).
    auto issue = [&](int t, int st) {
      const uint32_t lo = lo_bits(t), hi = hi_bits(t);
      T* kd = Ks + st * kTile * DH;
      T* vd = Vs + st * kTile * DH;
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int i = tid + it * kThreads, r = i / CH, c = i % CH;
        const int dst = r * DH + (c ^ (r & SWM)) * EPC;
        if ((r < 32 ? lo >> r : hi >> (r - 32)) & 1u) {
          const long long s = (long long)t * kTile + r;
          cp_async16(kd + dst, kb + s * k_ss + c * EPC);
          cp_async16(vd + dst, vb + s * v_ss + c * EPC);
        } else {
          *reinterpret_cast<uint4*>(vd + dst) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_commit();
    };

    int cur = next_tile(pass_lo), st = 0;
    if (cur < pass_hi) issue(cur, 0);
    while (cur < pass_hi) {
      const int nxt = next_tile(cur + 1);
      if (nxt < pass_hi) {
        issue(nxt, st ^ 1);  // stage st ^ 1 was released by the last tile's final barrier
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t lo = lo_bits(cur), hi = hi_bits(cur);
      const T* kt = Ks + st * kTile * DH;
      const T* vt = Vs + st * kTile * DH;

      // Scores: slot j on threads 2j, 2j + 1, each half of the chunks.
      {
        const int j = tid >> 1, half = tid & 1;
        const bool ok = ((j < 32 ? lo >> j : hi >> (j - 32)) & 1u) != 0;
        float part_s[GMAX];
#pragma unroll
        for (int g = 0; g < GMAX; ++g) part_s[g] = 0.f;
        if (ok) {
#pragma unroll
          for (int cc = 0; cc < CH / 2; ++cc) {
            const int c = 2 * cc + half;
            const uint4 raw = *reinterpret_cast<const uint4*>(kt + j * DH + (c ^ (j & SWM)) * EPC);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
              if (GMAX == 1 || g < G) {
#pragma unroll
                for (int x = 0; x < EPC; ++x)
                  part_s[g] = fmaf(Qs[g][c * EPC + x], to_f32(e[x]), part_s[g]);
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (GMAX == 1 || g < G) {
            const float sc = part_s[g] + __shfl_xor_sync(kFull, part_s[g], 1);
            if (half == 0) Ps[g][j] = ok ? sc * scale : kNegInf;
          }
        }
      }
      __syncthreads();

      // Online softmax: warp g takes query head g, two slots a lane.
      for (int g = warp; g < G; g += kWarps) {
        const float s0 = Ps[g][lane], s1 = Ps[g][lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
        const float m_prev = g_m[g];
        const float m_new = fmaxf(m_prev, mx);
        const bool dead = m_new <= kNegInf / 2;
        const float p0 = dead ? 0.f : expf(s0 - m_new), p1 = dead ? 0.f : expf(s1 - m_new);
        Ps[g][lane] = p0;
        Ps[g][lane + 32] = p1;
        const float sum = warp_sum(p0 + p1);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          g_l[g] = g_l[g] * corr + sum;
          g_m[g] = m_new;
          g_c[g] = corr;
        }
      }
      __syncthreads();

      // acc = acc * corr + P V over this thread's rows and column pair;
      // invalid rows hold zeros and p = 0, so every row is taken.
      {
        const int d = 2 * cp, c = d / EPC, x = d % EPC;
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (GMAX == 1 || g < G) {
            acc[g][0] *= g_c[g];
            acc[g][1] *= g_c[g];
          }
        }
#pragma unroll
        for (int jj = 0; jj < RPG; ++jj) {
          const int j = rg * RPG + jj;
          const float2 vv = load2(vt + j * DH + (c ^ (j & SWM)) * EPC + x);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (GMAX == 1 || g < G) {
              acc[g][0] = fmaf(Ps[g][j], vv.x, acc[g][0]);
              acc[g][1] = fmaf(Ps[g][j], vv.y, acc[g][1]);
            }
          }
        }
      }
      __syncthreads();  // releases stage st, Ps and (after the pass) the masks
      cur = nxt;
      st ^= 1;
    }
    __syncthreads();  // every thread is done with this pass's masks
  }

  // Sum the mix's row groups: red[rg][g][d], then thread i owns (g, d) = i.
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (GMAX == 1 || g < G) {
      red[(rg * GMAX + g) * DH + 2 * cp] = acc[g][0];
      red[(rg * GMAX + g) * DH + 2 * cp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  auto summed = [&](int g, int d) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < RG; ++r) a += red[(r * GMAX + g) * DH + d];
    return a;
  };

  if (splits == 1) {
    for (int i = tid; i < G * DH; i += kThreads) {
      const int g = i / DH, d = i % DH;
      const float inv = 1.f / fmaxf(g_l[g], 1e-30f);
      o[b * o_sb + (kvh * G + g) * o_sh + d] = from_f32<T>(summed(g, d) * inv);
    }
    return;
  }

  // Split partials: per (row, KV head, split) G x DH acc, then G m, G l.
  const int stride = G * (DH + 2);
  float* row_part = part + (long long)(b * K + kvh) * splits * stride;
  float* mine = row_part + split * stride;
  for (int i = tid; i < G * DH; i += kThreads) mine[i] = summed(i / DH, i % DH);
  if (tid < G) {
    mine[G * DH + tid] = g_m[tid];
    mine[G * DH + G + tid] = g_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[b * K + kvh], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // Merge in split order: weights exp(m_s - M) into Ps, 1 / L into g_c.
  if (tid < G) {
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, __ldcg(row_part + s * stride + G * DH + tid));
    const bool dead = M <= kNegInf / 2;  // no valid slot in any split: emit 0
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = dead ? 0.f : expf(__ldcg(row_part + s * stride + G * DH + tid) - M);
      Ps[tid][s] = w;
      L = fmaf(w, __ldcg(row_part + s * stride + G * DH + G + tid), L);
    }
    g_c[tid] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float a = 0.f;
    for (int s = 0; s < splits; ++s) a = fmaf(Ps[g][s], __ldcg(row_part + s * stride + i), a);
    o[b * o_sb + (kvh * G + g) * o_sh + d] = from_f32<T>(a * g_c[g]);
  }
  if (tid == 0) counters[b * K + kvh] = 0;  // every split has arrived: ready for the next call
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* kv_pos, const int* pos,
           void* o, float* part, int* counters, int B, int K, int G, int Sc, int splits,
           const long long* st, int window, float scale, cudaStream_t stream) {
  constexpr int bytes = 2 * 2 * kTile * DH * (int)sizeof(T);  // K and V, two stages
  static_assert(bytes >= (kThreads / (DH / 2)) * kMaxG * DH * 4, "row-group sums fit");
  auto kern = G == 1 ? decode_attention_kernel<T, DH, 1> : decode_attention_kernel<T, DH, kMaxG>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (Sc + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid((unsigned)splits, (unsigned)K, (unsigned)B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_pos, pos, (T*)o, part, counters, G, Sc,
      tiles_per_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, dh); k, v: (B, Sc, K, dh); kv_pos: (B, Sc) int32; pos: (B,)
// int32. Element strides: q (batch, head), k and v (batch, slot, head),
// kv_pos (batch), o (batch, head); the dh axis is contiguous, and k/v rows
// are 16-byte aligned (cp.async). H = K * G, G <= 8. With splits > 1,
// `part` holds B * K * splits * G * (dh + 2) floats and `counters` B * K
// int32 zeros, left zero on return.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_pos, const void* pos, void* o, void* part,
                                    void* counters, int B, int H, int K, int Sc, int splits,
                                    long long q_sb, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, long long p_sb,
                                    long long o_sb, long long o_sh, int dh, int window,
                                    float scale, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  const int G = H / K;
  if (G > kMaxG || G * K != H || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long st[11] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb,
                            v_ss, v_sh, p_sb, o_sb, o_sh};
  const int* kp = (const int*)kv_pos;
  const int* ps = (const int*)pos;
  float* pt = (float*)part;
  int* ct = (int*)counters;
  cudaStream_t s = (cudaStream_t)stream;
#define DECODE_CASE(D)                                                                   \
  case D:                                                                                \
    DISPATCH_DTYPE(dtype, return launch<scalar_t, D>(q, k, v, kp, ps, o, pt, ct, B, K, G, \
                                                     Sc, splits, st, window, scale, s)); \
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
