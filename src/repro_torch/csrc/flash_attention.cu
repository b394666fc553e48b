// Prefill flash attention for Hopper: tiled online softmax, f32 accumulation.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (Pallas
// `_kernel`): causal, sliding-window and padded-KV (kv_len) masks over
// arange positions, GQA by head h -> h / G, (m, l, acc) kept in f32, and
// rows with no valid key emit 0 (m starts at -1e30 and p is zeroed while
// m <= -5e29). Query row i sits at position q_off + i, key j at j: q may be
// one rank's block of rows of a longer sequence (context parallelism), and
// every mask and tile range below reads the shifted positions.
//
// Bound on the H100: operations at long prompts (~4 Sq Sk dh flops per head
// against ~(Sq + 2 Sk) dh elements read; S = 2048 is bound by the tensor
// cores), bytes at short ones. Two kernels, chosen by dtype in
// flash_attention_fwd; a bf16 or f16 call never reaches the FMA kernel:
//
//  * bf16 and f16: the tensor-core kernel. One CTA of one warpgroup (128
//    threads) per (64-row query tile, head, batch). TMA brings the Q tile
//    once and K/V tiles of 64 keys into a two-stage ring (one mbarrier per
//    stage, armed with expect_tx); tile j+1 is in flight while tile j is
//    computed. The maps span (dh, heads, S, B) with the tensors' own
//    strides, so the model layout needs no transpose, and rows past the end
//    arrive as zeros, so the ragged last tile needs no padding copy. Shared
//    tiles use the widest swizzle a row allows (128 B at dh >= 64, so a
//    dh = 128 row arrives as two 64-column boxes, and a dh = 112 row as two
//    boxes whose last 16 columns TMA fills with zeros). S = Q K^T is
//    wgmma.m64n64k16 with both operands in shared memory (K rows are
//    dh-contiguous: a K-major B). Masking and the online softmax run on the
//    accumulator fragment in registers (a row lives on the four threads of
//    a quad); P is rounded to q's dtype and fed back as the register A
//    operand of wgmma.m64n{dh}k16 against V read MN-major (transpose bit),
//    so V needs no transpose either. Rounding P to bf16/f16 before P.V is
//    the one deliberate change from the Pallas kernel, which keeps P in f32;
//    the kernel still meets the bf16 tolerance (2e-2) against its plain
//    version. Two CTAs share an SM, so one's softmax overlaps the other's
//    wgmma; at long prompts the softmax's exp2 throughput (MUFU), not the
//    tensor cores, sets the pace, so the running max is kept in raw score
//    units and each p costs one FFMA and one ex2.approx. Not yet: a producer
//    warp, ping-pong between two consumer warpgroups (in lockstep, without
//    it, they ran slower than two CTAs), persistent CTAs.
//  * f32: the FMA kernel (TF32 cannot meet the f32 tolerance of 2e-5). One
//    CTA of 256 threads per query tile; K/V tiles staged in shared memory as
//    f32; scores and P.V as plain f32 FMA, each thread owning a 4 x 4 block
//    of scores and a 4 x dh/16 block of the accumulator.
//
// Both skip tiles wholly above the (shifted) causal diagonal or before the
// window, which changes no result (their p is exactly 0), and mask element
// by element only on tiles that straddle a mask edge.
#include <cuda.h>

#include <type_traits>

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
                       long long o_sh, int causal, int window, int kv_len, int q_off,
                       float scale) {
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
  const int p0 = q_off + q0;  // position of the tile's first row
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
  if (causal) k_end = min(k_end, p0 + kBQ);
  int k_begin = window > 0 ? max(0, p0 - window + 1) : 0;
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
      const int r = ty + 16 * i, qpos = p0 + r;
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

template <int DH>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
               int Sq, int Sk, const long long* st, int causal, int window, int kv_len,
               int q_off, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<float, DH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, H / K, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], causal,
      window, kv_len, q_off, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, f16)
// ---------------------------------------------------------------------------

constexpr int kTcThreads = 128;  // one warpgroup

// Accumulator constraint lists for the wgmma asm below.
#define WG_ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_ACC16(i) WG_ACC8(i), WG_ACC8(i + 8)
#define WG_ACC32(i) WG_ACC16(i), WG_ACC16(i + 16)
#define WG_ACC64(i) WG_ACC32(i), WG_ACC32(i + 32)
#define WG_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define WG_R16 WG_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_R32 WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_R64                                                                              \
  WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
         "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d(64 x 64) (+)= A(64 x 16) B(16 x 64), A and B K-major in shared memory;
// scale_d = 0 overwrites d.
template <bool F16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
#define WG_ASM(TY)                                                                  \
  asm volatile("{ .reg .pred p; setp.ne.b32 p, %34, 0;\n"                          \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" WG_R32 \
               "}, %32, %33, p, 1, 1, 0, 0; }\n"                                   \
               : WG_ACC32(0)                                                       \
               : "l"(da), "l"(db), "r"(scale_d))
  if constexpr (F16) WG_ASM("f16"); else WG_ASM("bf16");
#undef WG_ASM
}

// d(64 x N) += A(64 x 16) B(16 x N), A from registers (the accumulator
// fragment layout), B MN-major in shared memory (transpose bit set).
#define WG_RS(N, NR, REGS, ACC, AOPS, DB, SC)                                              \
  template <bool F16>                                                                      \
  __device__ __forceinline__ void wgmma_rs_n##N(float (&d)[NR], const uint32_t (&a)[4],   \
                                                uint64_t db) {                             \
    if constexpr (F16)                                                                     \
      asm volatile("{ .reg .pred p; setp.ne.b32 p, " SC ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.f16.f16 {" REGS "}, {" \
                   AOPS "}, " DB ", p, 1, 1, 1; }\n"                                       \
                   : ACC                                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));         \
    else                                                                                   \
      asm volatile("{ .reg .pred p; setp.ne.b32 p, " SC ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" REGS       \
                   "}, {" AOPS "}, " DB ", p, 1, 1, 1; }\n"                                \
                   : ACC                                                                   \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));         \
  }
WG_RS(16, 8, WG_R8, WG_ACC8(0), "%8, %9, %10, %11", "%12", "%13")
WG_RS(32, 16, WG_R16, WG_ACC16(0), "%16, %17, %18, %19", "%20", "%21")
WG_RS(64, 32, WG_R32, WG_ACC32(0), "%32, %33, %34, %35", "%36", "%37")
WG_RS(128, 64, WG_R64, WG_ACC64(0), "%64, %65, %66, %67", "%68", "%69")
#undef WG_RS

template <bool F16, int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (DH == 16) wgmma_rs_n16<F16>(d, a, db);
  else if constexpr (DH == 32) wgmma_rs_n32<F16>(d, a, db);
  else if constexpr (DH == 64) wgmma_rs_n64<F16>(d, a, db);
  else wgmma_rs_n128<F16>(d, a, db);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi, std::true_type /*f16*/) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, std::false_type /*bf16*/) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Shared layout of one 64-row tile of a (rows, dh) operand as TMA writes it:
// NCH column chunks of CW elements, each 64 rows x SW bytes, swizzled SW. A
// dh that is not a whole number of chunks (112 = 64 + 48) takes PW columns:
// the last box reaches past the map's dh, and TMA fills those columns with
// zeros, so Q K^T runs dh / 16 k-steps over real columns only and P.V runs at
// N = PW, its columns past dh zero and never stored.
template <int DH>
struct TcTile {
  static constexpr int CW = DH < 64 ? DH : 64;  // columns per TMA box
  static constexpr int SW = CW * 2;              // bytes per row of a chunk = swizzle span
  static constexpr int NCH = (DH + CW - 1) / CW;
  static constexpr int PW = NCH * CW;  // padded columns: 128 at dh = 112
  static constexpr int CHUNK = 64 * SW;
  static constexpr int BYTES = NCH * CHUNK;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, T* __restrict__ o, int G,
                          int Sq, int Sk, long long o_sb, long long o_ss, long long o_sh,
                          int causal, int window, int kv_len, int q_off,
                          float scale_log2) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  using L = TcTile<DH>;
  constexpr int NO = L::PW / 2;  // accumulator floats per thread

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[3];  // Q, K/V stage 0, K/V stage 1
  // Tiles start 1024-aligned in the shared window: the swizzle atoms' origin.
  uint8_t* base = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* Qs = base;
  uint8_t* Ks = base + L::BYTES;      // 2 stages
  uint8_t* Vs = base + 3 * L::BYTES;  // 2 stages

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int p0 = q_off + q0;  // position of the tile's first row
  const int ra = warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);  // rows ra, ra + 8

  const int klim = min(Sk, kv_len);
  const int k_end = causal ? min(klim, p0 + kBQ) : klim;
  const int k_begin = (window > 0 ? max(0, p0 - window + 1) : 0) / kBK * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  auto load_kv = [&](int t, int st) {
    mbar_expect_tx(&bars[1 + st], 2 * L::BYTES);
#pragma unroll
    for (int c = 0; c < L::NCH; ++c) {
      tma_load_4d(Ks + st * L::BYTES + c * L::CHUNK, &kmap, &bars[1 + st], c * L::CW, kvh,
                  k_begin + t * kBK, b);
      tma_load_4d(Vs + st * L::BYTES + c * L::CHUNK, &vmap, &bars[1 + st], c * L::CW, kvh,
                  k_begin + t * kBK, b);
    }
  };

  if (n_tiles > 0) {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(&bars[0], L::BYTES);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c)
        tma_load_4d(Qs + c * L::CHUNK, &qmap, &bars[0], c * L::CW, h, q0, b);
      load_kv(0, 0);
    }
    mbar_wait(&bars[0], 0);
  }

  // Descriptors. K-major (Q, K): k-step kk reads 16 columns, 32 bytes into
  // a swizzled row of chunk kk / (SW / 32); 8-row groups are 8 SW apart.
  // MN-major (V): k-step kk reads 16 keys = 16 rows; dh chunks are CHUNK
  // apart (LBO), 8-key groups 8 SW apart (SBO).
  constexpr int KPR = L::SW / 32;  // k-steps per chunk row
  auto kmajor = [&](const uint8_t* tile, int kk) {
    return smem_desc(smem_addr(tile) + (kk / KPR) * L::CHUNK + (kk % KPR) * 32, 16, 8 * L::SW,
                     L::SW);
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1, k0 = k_begin + t * kBK;
    __syncthreads();  // every warp is done with tile t - 1, which used stage st ^ 1
    if (tid == 0 && t + 1 < n_tiles) load_kv(t + 1, st ^ 1);
    mbar_wait(&bars[1 + st], (t >> 1) & 1);

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint8_t* Kt = Ks + st * L::BYTES;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss_n64<F16>(s, kmajor(Qs, kk), kmajor(Kt, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Mask and online softmax on the fragment: s[4i + e] is row ra + 8 (e >> 1),
    // key k0 + 8 i + col0 + (e & 1). m is kept in raw score units (masked
    // scores are -1e30 there, so a row is dead while m <= -5e29), and each p
    // is one FFMA and one exp2: exp2((s - m) * scale * log2 e).
    if (!(k0 + kBK <= klim && (!causal || k0 + kBK - 1 <= p0) &&
          (window <= 0 || k0 > p0 + kBQ - 1 - window))) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * i + col0 + (e & 1), qp = p0 + ra + 8 * (e >> 1);
          const bool ok = kp < klim && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          if (!ok) s[4 * i + e] = kNegInf;
        }
      }
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2], neg_m[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m_run[j], mx[j]);
      corr[j] = exp2_approx((m_run[j] - m_new) * scale_log2);
      m_run[j] = m_new;
      // A dead row's scores are all -1e30: with m taken as 0 its p is 0.
      neg_m[j] = m_new <= kNegInf / 2 ? 0.f : -m_new * scale_log2;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      const float p = exp2_approx(fmaf(s[i], scale_log2, neg_m[j]));
      s[i] = p;
      psum[j] += p;
    }
    // l is kept per thread (this thread's keys) and summed over the quad at
    // the end: the correction is the same on all four threads of a row.
    l_run[0] = l_run[0] * corr[0] + psum[0];
    l_run[1] = l_run[1] * corr[1] + psum[1];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];

    // O += P V: P rounded to T, in the A-fragment layout, which is the
    // accumulator's: k-step kk takes s[8 kk .. 8 kk + 7].
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], std::integral_constant<bool, F16>());
    const uint32_t vt = smem_addr(Vs + st * L::BYTES);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<F16, L::PW>(acc, pa[kk], smem_desc(vt + kk * 16 * L::SW, L::CHUNK, 8 * L::SW, L::SW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // Epilogue: l summed over the quad, divide, round, store rows below Sq.
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 1);
    l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 2);
  }
  const float inv[2] = {1.f / fmaxf(l_run[0], 1e-30f), 1.f / fmaxf(l_run[1], 1e-30f)};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + ra + 8 * j;
    if (qi >= Sq) continue;
    T* orow = o + b * o_sb + qi * o_ss + h * o_sh + col0;
#pragma unroll
    for (int i = 0; i < DH / 8; ++i)
      *reinterpret_cast<uint32_t*>(orow + 8 * i) =
          pack2(acc[4 * i + 2 * j] * inv[j], acc[4 * i + 2 * j + 1] * inv[j],
                std::integral_constant<bool, F16>());
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API, reached through the
// runtime so that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Map over a (B, S, heads, dh) tensor given element strides (batch, seq,
// head): dims (dh, heads, S, B) innermost first, boxes of (CW, 1, 64, 1).
template <typename T, int DH>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int S, int B, long long sb,
              long long ss, long long sh) {
  using L = TcTile<DH>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::CW, 1, (cuuint32_t)kBK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = L::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType ty = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, ty, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DH>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
              int Sq, int Sk, const long long* st, int causal, int window, int kv_len,
              int q_off, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_map<T, DH>(&qm, q, H, Sq, B, st[0], st[1], st[2]) ||
      !make_map<T, DH>(&km, k, K, Sk, B, st[3], st[4], st[5]) ||
      !make_map<T, DH>(&vm, v, K, Sk, B, st[6], st[7], st[8]))
    return (int)cudaErrorInvalidValue;
  constexpr int bytes = 5 * TcTile<DH>::BYTES + 1024;  // Q, 2 x K, 2 x V, alignment slack
  auto kern = flash_attention_tc_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  kern<<<grid, kTcThreads, bytes, stream>>>(qm, km, vm, (T*)o, H / K, Sq, Sk, st[9], st[10],
                                            st[11], causal, window, kv_len, q_off,
                                            scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Sq, H, dh); k, v: (B, Sk, K, dh); element strides (batch, seq,
// head) for q, k, v, o in that order; the dh axis is contiguous; query row i
// sits at position q_off + i. f32 takes
// the FMA kernel, bf16 and f16 the tensor-core kernel, whose TMA maps need
// 16-byte aligned q/k/v base pointers and strides (checked by the wrapper).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int K, int Sq, int Sk,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   int dh, int causal, int window, int kv_len, int q_off,
                                   float scale, int dtype, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(D)                                                                     \
  case D:                                                                                 \
    if (dtype == kF32)                                                                    \
      return launch_fma<D>(q, k, v, o, B, H, K, Sq, Sk, st, causal, window, kv_len, q_off, \
                           scale, s);                                                     \
    if (dtype == kBF16)                                                                   \
      return launch_tc<__nv_bfloat16, D>(q, k, v, o, B, H, K, Sq, Sk, st, causal, window, \
                                         kv_len, q_off, scale, s);                        \
    if (dtype == kF16)                                                                    \
      return launch_tc<__half, D>(q, k, v, o, B, H, K, Sq, Sk, st, causal, window, kv_len, \
                                  q_off, scale, s);                                       \
    return (int)cudaErrorInvalidValue;
  switch (dh) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(112)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
