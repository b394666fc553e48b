// Flash-decoding for Hopper: one query token per sequence against its KV cache.
//
// Replaces src/repro/kernels/decode_attention.py:decode_attention (Pallas
// `_kernel`): slot validity from absolute positions (kv_pos < 0 empty,
// kv_pos > pos future, kv_pos <= pos - window outside a ring cache's
// window), online softmax with (m, l, acc) in f32, rows with no valid slot
// emit 0.
//
// Bound on the H100: bytes at long caches. Each valid cache slot's K and V
// row is used for G query heads' ~4 dh flops, about G flops per byte. At the
// serving shapes (caches of a few hundred slots) a call is a chain of
// dependent memory round trips, not a stream of bytes. Design:
//
//  * Grid (splits, K * head groups, B). A CTA of 128 threads holds GC = 1,
//    2 or 4 query heads of one KV head (a template parameter: its loops over
//    heads unroll with no guard); G is cut into G / GC head groups, which
//    read the KV head's rows once each (the second and later reads mostly
//    from L2; the Pallas grid re-reads them per query head). The wrapper
//    takes the largest GC that divides G (`head_groups`): on the H100 a CTA
//    of 4 heads was faster than one of all 16 at every glm4-9b shape timed,
//    576-slot caches and 8192-slot ones (PERF.md). A CTA walks its split: a
//    range of whole 64-slot tiles. The wrapper picks the split count so that
//    few long sequences still fill the card (batch 1, 32 KV heads, 576
//    slots: 5 splits, 160 CTAs); at B * K * groups >= the SM count it is 1
//    and the kernel writes the output itself.
//  * A CTA first reads all positions of its range (one burst) into
//    per-tile validity masks, so a tile with no valid slot is skipped before
//    any K/V byte is read and a short sequence in a long cache costs its
//    length. The valid rows of the next non-empty tile are copied with
//    cp.async (16 bytes a thread, chunks XOR-swizzled per row against bank
//    conflicts) into the second stage of a two-stage ring while this tile is
//    computed. A shared row is a power of two of chunks, so a row whose
//    chunks are not (dh = 112: 14 in bf16, 28 in f32) is padded, and the
//    swizzle stays inside it.
//  * Scores: two threads per slot, shuffle-combined; softmax: one warp per
//    query head; mix: each thread a column pair over a group of rows (at
//    dh = 112, 56 pairs in two groups: 16 threads sit out), fully
//    unrolled (rows that were not copied are zeroed and have p = 0), the
//    row groups summed once at the end.
//  * The merge is in the same launch: every split writes its f32 (m, l,
//    acc) to scratch (a split with no valid slot only m and l), and the
//    last CTA of a (row, head group) to arrive (an atomic counter taken
//    after a fence) reads every split's (m, l) in one round, merges the
//    splits that hold a valid slot in split order, writes the output and
//    resets the counter to 0. The fixed order makes the output
//    bit-identical from call to call; one launch per call keeps the
//    host-bound decode step at one launch per layer.
//  * With `lse` given (the sharded decode over a cache whose slots are cut
//    across ranks), the output is f32 and each (row, head) also gets the
//    log-sum-exp of its valid scores, m + log(l), written where the output
//    is written (by the single split, or by the merging CTA); a row with no
//    valid slot gets -inf and 0. The caller merges the ranks' parts by
//    weights exp(lse - max lse) and rounds the merged f32 output once.
#include "common.cuh"

namespace {

constexpr int kTile = 64, kThreads = 128, kWarps = kThreads / 32;
constexpr int kMaxSplits = 64;  // = kTile: the merge weights reuse the score buffer
constexpr int kPassTiles = 32;  // tiles whose positions one pass holds
constexpr unsigned kFull = 0xffffffffu;

// The least power of two >= n.
__host__ __device__ constexpr int pow2_ceil(int n) { return n <= 1 ? 1 : 2 * pow2_ceil((n + 1) / 2); }

// Two neighbouring elements of a row as f32.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// GC: the query heads of this CTA, heads blockIdx.y * GC + g of the KV head
// blockIdx.y / n_hg (n_hg head groups per KV head).
template <typename T, int DH, int GC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_pos,
                        const int* __restrict__ pos, T* __restrict__ o, float* __restrict__ of,
                        float* __restrict__ lse, float* __restrict__ part,
                        int* __restrict__ counters, int n_hg, int Sc, int tiles_per_split,
                        long long q_sb, long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                        long long p_sb, long long o_sb, long long o_sh, int window,
                        float scale) {
  constexpr int EPC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int CH = DH / EPC;              // chunks per row
  // A shared row holds CHP = a power of two of chunks (16 for a bf16 row of
  // dh = 112, which has 14), so that the swizzle c ^ (row & SWM) never leaves
  // its row; the chunks past CH are never written or read.
  constexpr int CHP = pow2_ceil(CH);
  constexpr int DS = CHP * EPC;  // shared row stride, elements
  constexpr int SWM = (CHP < 8 ? CHP : 8) - 1;  // chunk swizzle: c ^ (row & SWM)
  constexpr int ITERS = kTile * CH / kThreads;
  constexpr int PAIRS = DH / 2;          // mix: one thread per column pair ...
  constexpr int RG = kThreads / PAIRS;   // ... and row group; threads past RG * PAIRS
  constexpr int RPG = kTile / RG;        // rows per group     (16 at dh = 112) sit out
  static_assert(kTile * CH % kThreads == 0 && kTile % RG == 0 && RG >= 1, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);  // [2][kTile][DS], raw cache dtype
  T* Vs = Ks + 2 * kTile * DS;
  float* red = reinterpret_cast<float*>(smem);  // [RG][GC][DH] after the last tile
  __shared__ __align__(16) float Qs[GC][DH];
  __shared__ float Ps[GC][kTile];  // scores, then probabilities; merge weights
  __shared__ uint32_t masks[2 * kPassTiles];
  __shared__ float g_m[GC], g_l[GC], g_c[GC];
  __shared__ int is_last, n_live;
  __shared__ unsigned char live[kMaxSplits];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y = blockIdx.y, Y = gridDim.y;  // (KV head, head group): heads y * GC + g
  const int split = blockIdx.x, splits = gridDim.x, kvh = y / n_hg, b = blockIdx.z;
  const int qpos = pos[b];
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int* pb = kv_pos + b * p_sb;
  const int n_tiles = (Sc + kTile - 1) / kTile;
  const int t_lo = split * tiles_per_split, t_hi = min(t_lo + tiles_per_split, n_tiles);
  const int cp = tid % PAIRS, rg = tid / PAIRS;  // the mix's column pair and row group
  const bool mixer = rg < RG;

  if (tid < GC) {
    g_m[tid] = kNegInf;
    g_l[tid] = 0.f;
  }
  float acc[GC][2];
#pragma unroll
  for (int g = 0; g < GC; ++g) acc[g][0] = acc[g][1] = 0.f;

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
      if (pass_lo == t_lo) {  // Q in 16-byte chunks, all loads in flight at once
#pragma unroll
        for (int it = 0; it < (GC * CH + kThreads - 1) / kThreads; ++it) {
          const int i = tid + it * kThreads, g = i / CH, c = i % CH;
          if (i < GC * CH) {
            const uint4 raw =
                *reinterpret_cast<const uint4*>(q + b * q_sb + (y * GC + g) * q_sh + c * EPC);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int x = 0; x < EPC; ++x) Qs[g][c * EPC + x] = to_f32(e[x]);
          }
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
      T* kd = Ks + st * kTile * DS;
      T* vd = Vs + st * kTile * DS;
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int i = tid + it * kThreads, r = i / CH, c = i % CH;
        const int dst = r * DS + (c ^ (r & SWM)) * EPC;
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
      const T* kt = Ks + st * kTile * DS;
      const T* vt = Vs + st * kTile * DS;

      // Scores: slot j on threads 2j, 2j + 1, each half of the chunks.
      {
        const int j = tid >> 1, half = tid & 1;
        const bool ok = ((j < 32 ? lo >> j : hi >> (j - 32)) & 1u) != 0;
        float part_s[GC];
#pragma unroll
        for (int g = 0; g < GC; ++g) part_s[g] = 0.f;
        if (ok) {
#pragma unroll
          for (int cc = 0; cc < CH / 2; ++cc) {
            const int c = 2 * cc + half;
            const uint4 raw = *reinterpret_cast<const uint4*>(kt + j * DS + (c ^ (j & SWM)) * EPC);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int g = 0; g < GC; ++g) {
#pragma unroll
              for (int x = 0; x < EPC; ++x)
                part_s[g] = fmaf(Qs[g][c * EPC + x], to_f32(e[x]), part_s[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float sc = part_s[g] + __shfl_xor_sync(kFull, part_s[g], 1);
          if (half == 0) Ps[g][j] = ok ? sc * scale : kNegInf;
        }
      }
      __syncthreads();

      // Online softmax: warp g takes query head g, two slots a lane.
      for (int g = warp; g < GC; g += kWarps) {
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
      if (mixer) {
        const int d = 2 * cp, c = d / EPC, x = d % EPC;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          acc[g][0] *= g_c[g];
          acc[g][1] *= g_c[g];
        }
#pragma unroll
        for (int jj = 0; jj < RPG; ++jj) {
          const int j = rg * RPG + jj;
          const float2 vv = load2(vt + j * DS + (c ^ (j & SWM)) * EPC + x);
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            acc[g][0] = fmaf(Ps[g][j], vv.x, acc[g][0]);
            acc[g][1] = fmaf(Ps[g][j], vv.y, acc[g][1]);
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
  if (mixer) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      red[(rg * GC + g) * DH + 2 * cp] = acc[g][0];
      red[(rg * GC + g) * DH + 2 * cp + 1] = acc[g][1];
    }
  }
  __syncthreads();
  auto summed = [&](int g, int d) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < RG; ++r) a += red[(r * GC + g) * DH + d];
    return a;
  };
  // The GC x DH outputs, element i = tid + e * kThreads for e < PER.
  constexpr int PER = (GC * DH + kThreads - 1) / kThreads;
  // Output element (g, d): rounded to T, or f32 as it is when lse is asked for.
  auto put = [&](int g, int d, float val) {
    const long long at = b * o_sb + (y * GC + g) * o_sh + d;
    if (of != nullptr) of[at] = val;
    else o[at] = from_f32<T>(val);
  };
  // lse of query head g from its (m, l); -inf where no slot was valid.
  auto put_lse = [&](int g, float m, float l) {
    lse[(long long)b * Y * GC + y * GC + g] =
        m <= kNegInf / 2 ? __int_as_float(0xff800000) : m + logf(l);
  };

  if (splits == 1) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * kThreads, g = i / DH, d = i % DH;
      if (i < GC * DH) put(g, d, summed(g, d) * (1.f / fmaxf(g_l[g], 1e-30f)));
    }
    if (lse != nullptr && tid < GC) put_lse(tid, g_m[tid], g_l[tid]);
    return;
  }

  // Split partials: per (row, head group, split) GC x DH acc, then GC m, GC l.
  // A split with no valid slot (m = -1e30 for every head: validity is per
  // slot) writes m and l only; the merge skips it, as its weight is 0.
  const int stride = GC * (DH + 2);
  float* row_part = part + (long long)(b * Y + y) * splits * stride;
  float* mine = row_part + split * stride;
  if (g_m[0] > kNegInf / 2) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * kThreads;
      if (i < GC * DH) mine[i] = summed(i / DH, i % DH);
    }
  }
  if (tid < GC) {
    mine[GC * DH + tid] = g_m[tid];
    mine[GC * DH + GC + tid] = g_l[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[b * Y + y], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // Merge in split order. Every split's (m, l) in one round of loads into
  // shared memory (the row-group sums are spent): ml[s][0, GC) m, [GC, 2 GC) l.
  float* ml = red;
#pragma unroll
  for (int it = 0; it < 2 * GC * kMaxSplits / kThreads; ++it) {
    const int i = tid + it * kThreads;
    if (i < 2 * GC * splits)
      ml[i] = __ldcg(row_part + (i / (2 * GC)) * stride + GC * DH + i % (2 * GC));
  }
  __syncthreads();
  // Weights exp(m_s - M) into Ps, 1 / L into g_c; the live splits' indices.
  if (tid < GC) {
    float M = kNegInf;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, ml[s * 2 * GC + tid]);
    const bool dead = M <= kNegInf / 2;  // no valid slot in any split: emit 0
    float L = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float w = dead ? 0.f : expf(ml[s * 2 * GC + tid] - M);
      Ps[tid][s] = w;
      L = fmaf(w, ml[s * 2 * GC + GC + tid], L);
    }
    g_c[tid] = 1.f / fmaxf(L, 1e-30f);
    if (lse != nullptr) put_lse(tid, M, L);
  }
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < splits; ++s)
      if (ml[s * 2 * GC] > kNegInf / 2) live[n++] = s;
    n_live = n;
  }
  __syncthreads();
  // acc: the live splits in order, the loads of three splits in flight.
  float a[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) a[e] = 0.f;
#pragma unroll 3
  for (int n = 0; n < n_live; ++n) {
    const int s = live[n];
    float x[PER];
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * kThreads;
      x[e] = i < GC * DH ? __ldcg(row_part + s * stride + i) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = tid + e * kThreads;
      if (i < GC * DH) a[e] = fmaf(Ps[i / DH][s], x[e], a[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = tid + e * kThreads, g = i / DH, d = i % DH;
    if (i < GC * DH) put(g, d, a[e] * g_c[g]);
  }
  if (tid == 0) counters[b * Y + y] = 0;  // every split has arrived: ready for the next call
}

template <typename T, int DH, int GC>
constexpr int smem_bytes() {  // the K/V ring (two stages), then the row-group sums
  constexpr int ring = 2 * 2 * kTile * pow2_ceil(DH * (int)sizeof(T) / 16) * 16;
  constexpr int sums = (kThreads / (DH / 2)) * GC * DH * 4;
  static_assert(sums >= 2 * GC * kMaxSplits * 4, "the merge's (m, l) fit where the sums were");
  return ring > sums ? ring : sums;
}

template <typename T, int DH, int GC>
int launch_gc(const void* q, const void* k, const void* v, const int* kv_pos, const int* pos,
              void* o, float* lse, float* part, int* counters, int B, int K, int n_hg, int Sc,
              int splits, const long long* st, int window, float scale, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, DH, GC>;
  constexpr int bytes = smem_bytes<T, DH, GC>();
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (Sc + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid((unsigned)splits, (unsigned)(K * n_hg), (unsigned)B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_pos, pos, lse ? nullptr : (T*)o,
      lse ? (float*)o : nullptr, lse, part, counters, n_hg, Sc,
      tiles_per_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const int* kv_pos, const int* pos,
           void* o, float* lse, float* part, int* counters, int B, int K, int GC, int n_hg,
           int Sc, int splits, const long long* st, int window, float scale, cudaStream_t stream) {
  switch (GC) {
    case 1:
      return launch_gc<T, DH, 1>(q, k, v, kv_pos, pos, o, lse, part, counters, B, K, n_hg, Sc,
                                 splits, st, window, scale, stream);
    case 2:
      return launch_gc<T, DH, 2>(q, k, v, kv_pos, pos, o, lse, part, counters, B, K, n_hg, Sc,
                                 splits, st, window, scale, stream);
    case 4:
      return launch_gc<T, DH, 4>(q, k, v, kv_pos, pos, o, lse, part, counters, B, K, n_hg, Sc,
                                 splits, st, window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, H, dh); k, v: (B, Sc, K, dh); kv_pos: (B, Sc) int32; pos: (B,)
// int32. Element strides: q (batch, head), k and v (batch, slot, head),
// kv_pos (batch), o (batch, head); the dh axis is contiguous, and q, k and
// v rows are 16-byte aligned (16-byte loads, cp.async). H = K * G for any
// G; each KV head's G query heads go to n_hg CTAs of GC = G / n_hg heads,
// GC in {1, 2, 4}. With splits > 1, `part` holds B * K * splits * G *
// (dh + 2) floats and `counters` B * K * n_hg int32 zeros, left zero on
// return. With `lse` (B, H) f32 (contiguous), o is f32 and lse gets each
// (row, head)'s log-sum-exp of its valid scores (-inf where none is).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_pos, const void* pos, void* o, void* lse,
                                    void* part,
                                    void* counters, int B, int H, int K, int n_hg, int Sc,
                                    int splits,
                                    long long q_sb, long long q_sh, long long k_sb,
                                    long long k_ss, long long k_sh, long long v_sb,
                                    long long v_ss, long long v_sh, long long p_sb,
                                    long long o_sb, long long o_sh, int dh, int window,
                                    float scale, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (K < 1 || n_hg < 1 || H % (K * n_hg) != 0) return (int)cudaErrorInvalidValue;
  const int GC = H / (K * n_hg);  // query heads per CTA
  if ((GC != 1 && GC != 2 && GC != 4) || splits < 1 || splits > kMaxSplits ||
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
    DISPATCH_DTYPE(dtype, return launch<scalar_t, D>(q, k, v, kp, ps, o, (float*)lse, pt, ct, \
                                                     B, K, GC, n_hg, Sc, splits, st,      \
                                                     window, scale, s));                   \
    break;
  switch (dh) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(112)
    DECODE_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_CASE
  return 0;
}
