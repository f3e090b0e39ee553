// K3-f32: the clamped-softmax flash-attention backward in float32, for
// sm_90a, on the tensor cores in 3xTF32, at head dims 16, 32, 64, 128 and
// 192 (the UNet trained with training.dtype float32; the legacy UNet, the
// one model at D = 24, only samples).
//
// Replaces, in weatherconverter_tpu/ops/attention.py, the resident backward
// `_flash_attention_bwd_impl` (:645; kernels `_flash_bwd_kernel` :244 and
// `_flash_bwd_kernel_v2` :305) and the streaming backward
// `_flash_stream_bwd_impl` (:585; kernels `_flash_bwd_dq_kernel_stream` :533
// and `_flash_bwd_dkv_kernel_stream` :555) where JAX runs them on f32 tiles:
// the UNet its DDPM loop trains in f32
// (weatherconverter_tpu/training/loop_diffusion.py:114-119). With
// s = Q K^T * scale, p = exp(clip(s, -60, 60)), l = row sum of p (from
// K1-f32), Dv = rowsum(dO o O) and m = p o (dO V^T - Dv), zeroed where
// |s| > 60:
//   dQ = (m K) * scale / l,   dK = m^T (Q * scale / l),   dV = p^T (dO / l),
// every sum in f32 and every product in 3xTF32 (flash_tf32.cuh), as the
// plain version `flash_attention_bwd_plain` computes it in f32. The bf16 K3
// (flash_bwd.cu) serves bf16 models.
//
// What bounds it on the H100: five N x N x D products a head, each formed
// as three TF32 products (fifteen TF32 products a score element, 30 N^2 D
// FLOPs, at 494.7 TFLOP/s), and N^2 exponentials. This two-pass form spends
// seven products (S and dO V^T twice; eight at D = 128 and 192, below) and
// 2 N^2 exponentials against that bound.
//
// Two passes, as K3's, so there are no atomics and the gradients repeat bit
// for bit:
//   * Pass 1 (dQ): a consumer owns 64 query rows; per tile of keys S = Q K^T
//     and dP = dO V^T, m in registers, dQ += m K; it also writes Dv and 1/l
//     of its rows to an f32 scratch for pass 2.
//   * Pass 2 (dK, dV): a consumer owns 64 keys; per tile of queries S^T =
//     K Q^T and dP^T = V dO^T, so p^T and m^T come out with keys as rows,
//     then dV += (p^T / l) dO and dK += (m^T scale / l) Q, the query's 1/l
//     and scale multiplied into the A operand before it is split.
//
// The Hopper design (D = 16, 32, 64, 128; flash_tf32.cuh's second half):
//   * A block is one producer warpgroup and kC consumer warpgroups (two up to
//     D = 64 and in D = 128's dV launch, one otherwise). The producer loads
//     f32 rows with 16-byte loads, all issued before it waits for the
//     consumers, splits each element once for the block into TF32 hi and lo,
//     and stores the planes in the 128-byte-swizzled K-major layout wgmma
//     reads: each consumer's own rows once (Q and dO, or K and V; Q and K
//     times scale log2 e), then for every tile two plane groups, each behind
//     its own FULL / EMPTY named barriers, so that it fills one while the
//     consumers read the other: group A the tile as it lies (B of the score
//     products), group B the tile transposed (B of m K, p^T dO, m^T Q: tf32
//     wgmma takes K-major operands only) with the tile's 1/l and Dv.
//   * A consumer runs every product as wgmma.mma_async m64nNk8 .tf32, three a
//     k-step: the score products with both operands from shared memory, the
//     others with A (p, m and their transposes, straight from the score
//     accumulators, c_to_a) from registers. Each sum runs in chains of four
//     k-steps, each chain its own accumulator, joined by FADD after the wait.
//   * Two consumers overlap one's exponentials, splits and FADD joins with
//     the other's MMAs. ptxas compiles a 384-thread block at 168 registers a
//     thread; setmaxnreg then gives the producer 128 (88 in pass 2 at D = 64,
//     112 in D = 128's dV launch) and each consumer the rest of the block's
//     168 x 384: 188 (208, 192). The producer at 104 spilled 76-352 bytes
//     (ptxas allocates each region to its setmaxnreg count); a budget past
//     the block's registers made setmaxnreg.inc wait forever.
//   * Walked tiles of 64 rows at D <= 32 and 32 from D = 64 on: 64 spilled
//     412 bytes in pass 1's 188-register consumers at D = 64, and at D = 128
//     and pass 2 at 64 two consumers' planes leave no room for 64. At D = 128
//     dK and dV together are 128 registers of running sums and their own K
//     and V planes 128 KB a consumer: pass 2 is launched twice there, once
//     for dV (S^T and p^T dO) and once for dK (S^T, dP^T and m^T Q), and S^T
//     is formed twice.
//   * Shared memory (the 1024-byte alignment included), pass 1 / pass 2: D =
//     16 58 / 66 KB, 32 114 / 130 KB, 64 178 / 193 KB, 128 226 / 193 (dV) and
//     225 KB (dK).
//   * What binds it (PERF.md section 6; H100 80GB HBM3 at 700 W): at (4096,
//     64), B*H = 32, pass 1 takes 2.67 ms and pass 2 3.35 ms against 1.25
//     and 1.67 ms of their own tensor time: each consumer's serial chain of
//     MMA waits, exponentials, splits and FADD joins, which two consumers
//     only partly overlap. 1.31-1.76x the mma.sync passes' speed at the
//     four path shapes (probes/time_flash.py beside a checkout with them).
// D = 192 keeps the first design (mma.sync.m16n8k8.tf32, a block of 4
// warps each owning 16 rows, operands staged raw by cp.async and split as
// each fragment loads; pass 2 as two launches): the wgmma design's own planes
// alone, Q and dO in hi and lo for 64 rows, are 4 x 64 x 192 x 4 bytes = 192
// KB of the 227 a block may have, with no room left for a tile's six planes
// (24 KB at 16 keys).
#include <cuda_runtime.h>

#include "flash_tf32.cuh"

namespace wcbwd32 {

using wcflash::cp_async16;
using wcflash::cp_async_commit;
using wcflash::cp_async_wait;
using wcflash::kClampLog2;
using wcflash::kLog2e;
using wcflash::smem_u32;
using wctf32::c_to_a;
using wctf32::Cols;
using wctf32::ex2;
using wctf32::Fill;
using wctf32::kEmptyA;
using wctf32::kEmptyB;
using wctf32::kFullA;
using wctf32::kFullB;
using wctf32::Plane;
using wctf32::SmemBase;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // a block's own rows: queries in pass 1, keys in pass 2

template <int D>
struct Cfg {
  static constexpr int kTile = D <= 32 ? 64 : 32;          // rows of a walked tile in pass 2
  static constexpr int kTileDq = D > 128 ? 16 : kTile;     // and in pass 1
  static constexpr int kStride = D + 4;
  static constexpr int kNt = kTile / 8;
  // pass 1: Q and dO rows, then [buffer][K, V] tiles
  static constexpr int kDqSmemBytes = (2 * kRows + 4 * kTileDq) * kStride * 4;
  // pass 2: K and V rows, [buffer][Q, dO] tiles, then [buffer][1/l, Dv] vectors
  static constexpr int kDkvSmemBytes = ((2 * kRows + 4 * kTile) * kStride + 4 * kTile) * 4;
};

// The head dims that take the wgmma passes; D = 192 keeps the mma.sync passes (see the note at the top).
template <int D>
constexpr bool kWgmma = D <= 128;

// exp2-domain score y -> p = exp2(clip(y)), and whether the clamp left it alone
__device__ __forceinline__ float clamped_exp2(float y, bool& inside) {
  inside = fabsf(y) <= kClampLog2;
  return ex2(fminf(fmaxf(y, -kClampLog2), kClampLog2));
}

// Pass 1: dQ for a block's 64 query rows; also writes Dv and 1/l of its rows
// to dvec and linv_out.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ o, const float* __restrict__ d_o, const float* __restrict__ l,
                            float* __restrict__ dq, float* __restrict__ dvec, float* __restrict__ linv_out, int n,
                            float scale, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kStride = C::kStride, kTile = C::kTileDq, kNt = kTile / 8, kSteps = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [kRows][kStride]
  float* dos = qs + kRows * kStride;    // [kRows][kStride]
  float* kv = dos + kRows * kStride;    // [2][K, V][kTile][kStride]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int block_row0 = blockIdx.x * kRows;
  const float* kg = k + head;
  const float* vg = v + head;

  auto stage = [&](int tile, int buf) {
    float* dst = kv + buf * 2 * kTile * kStride;
    wctf32::stage_rows<D>(dst, kg + (size_t)tile * kTile * D, kTile, kStride, tid, kThreads);
    wctf32::stage_rows<D>(dst + kTile * kStride, vg + (size_t)tile * kTile * D, kTile, kStride, tid, kThreads);
    cp_async_commit();
  };
  wctf32::stage_rows<D>(qs, q + head + (size_t)block_row0 * D, kRows, kStride, tid, kThreads);
  wctf32::stage_rows<D>(dos, d_o + head + (size_t)block_row0 * D, kRows, kStride, tid, kThreads);
  cp_async_commit();
  stage(0, 0);

  // Dv and 1/l of this thread's rows g and g + 8 of its warp's 16
  const int r0 = block_row0 + warp * 16;
  const float* qw = qs + warp * 16 * kStride;
  const float* dow = dos + warp * 16 * kStride;
  cp_async_wait<1>();  // Q and dO have landed (this thread's copies)
  __syncthreads();     // and every thread's
  float dv_r[2], linv_r[2];
  {
    const float* og = o + head + (size_t)r0 * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += 4) acc += dow[row * kStride + c + t] * og[row * D + c + t];
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      dv_r[h] = acc;
      linv_r[h] = 1.f / l[(size_t)blockIdx.y * n + r0 + row];
    }
    if (t == 0) {
      const size_t at = (size_t)blockIdx.y * n + r0 + g;
      dvec[at] = dv_r[0];
      dvec[at + 8] = dv_r[1];
      linv_out[at] = linv_r[0];
      linv_out[at + 8] = linv_r[1];
    }
  }

  const float ones[kNt][2] = {};  // product_nn's row multipliers: unused here
  float tot[kSteps][4] = {};      // dQ's n-tiles (m K), summed over the tiles
  const int tiles = n / kTile;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed for every thread; every warp is done with the previous one
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    const float* ks = kv + buf * 2 * kTile * kStride;
    const float* vs = ks + kTile * kStride;

    float sc[kNt][4], dp[kNt][4];
    wctf32::product_nt<D, kNt>(sc, qw, scale_log2, ks, kStride, g, t);  // S, exp2 domain
    wctf32::product_nt<D, kNt>(dp, dow, 1.f, vs, kStride, g, t);        // dO V^T
    uint32_t mh[kNt][4], ml[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      float m[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool inside;
        const float p = clamped_exp2(sc[j][e], inside);
        m[e] = inside ? p * (dp[j][e] - dv_r[e / 2]) : 0.f;
      }
      c_to_a(m, mh[j], ml[j]);
    }
    wctf32::product_nn<D, kNt, false>(tot, mh, ml, ks, kStride, g, t, ones);
  }

  const float mul[2] = {scale * linv_r[0], scale * linv_r[1]};
  float* out = dq + head + (size_t)r0 * D;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int col = 8 * s + 2 * t;
    *reinterpret_cast<float2*>(out + g * D + col) = make_float2(tot[s][0] * mul[0], tot[s][1] * mul[0]);
    *reinterpret_cast<float2*>(out + (g + 8) * D + col) = make_float2(tot[s][2] * mul[1], tot[s][3] * mul[1]);
  }
}

// Pass 2: for a block's 64 keys, dV (kOut & 1) and dK (kOut & 2), walking the
// query tiles with their 1/l and Dv from pass 1.
template <int D, int kOut>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ d_o, const float* __restrict__ linv,
                             const float* __restrict__ dvec, float* __restrict__ dk, float* __restrict__ dv, int n,
                             float scale, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kStride = C::kStride, kTile = C::kTile, kNt = C::kNt, kSteps = D / 8;
  constexpr bool kDoDv = kOut & 1, kDoDk = kOut & 2;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // [kRows][kStride]
  float* vs = ks + kRows * kStride;      // [kRows][kStride] (dK only)
  float* qd = vs + kRows * kStride;      // [2][Q, dO][kTile][kStride]
  float* vec = qd + 4 * kTile * kStride;  // [2][1/l, Dv][kTile]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const size_t head = (size_t)blockIdx.y * n * D;
  const size_t rows = (size_t)blockIdx.y * n;
  const int block_key0 = blockIdx.x * kRows;
  const float* qg = q + head;
  const float* dog = d_o + head;

  auto stage = [&](int tile, int buf) {
    float* dst = qd + buf * 2 * kTile * kStride;
    wctf32::stage_rows<D>(dst, qg + (size_t)tile * kTile * D, kTile, kStride, tid, kThreads);
    wctf32::stage_rows<D>(dst + kTile * kStride, dog + (size_t)tile * kTile * D, kTile, kStride, tid, kThreads);
    if (tid < kTile / 4) {
      float* vd = vec + buf * 2 * kTile;
      cp_async16(smem_u32(vd + 4 * tid), linv + rows + (size_t)tile * kTile + 4 * tid);
      cp_async16(smem_u32(vd + kTile + 4 * tid), dvec + rows + (size_t)tile * kTile + 4 * tid);
    }
    cp_async_commit();
  };
  wctf32::stage_rows<D>(ks, k + head + (size_t)block_key0 * D, kRows, kStride, tid, kThreads);
  if constexpr (kDoDk) wctf32::stage_rows<D>(vs, v + head + (size_t)block_key0 * D, kRows, kStride, tid, kThreads);
  stage(0, 0);  // the own rows' copies join the first tile's group

  const float* kw = ks + warp * 16 * kStride;  // this warp's 16 keys
  const float* vw = vs + warp * 16 * kStride;
  float tot_v[kDoDv ? kSteps : 1][4] = {};     // dV's n-tiles
  float tot_k[kDoDk ? kSteps : 1][4] = {};     // dK's n-tiles
  const int tiles = n / kTile;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed for every thread; every warp is done with the previous one
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    const float* qt = qd + buf * 2 * kTile * kStride;
    const float* dot = qt + kTile * kStride;
    const float* linv_t = vec + buf * 2 * kTile;
    const float* dv_t = linv_t + kTile;

    float sc[kNt][4];  // S^T: rows the warp's keys, columns the tile's queries
    wctf32::product_nt<D, kNt>(sc, kw, scale_log2, qt, kStride, g, t);
    if constexpr (kDoDv) {
      uint32_t ph[kNt][4], pl[kNt][4];
      float rmul[kNt][2];  // 1/l of the queries (rows of dO) a thread's B fragments read
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool inside;
          p[e] = clamped_exp2(sc[j][e], inside);
        }
        c_to_a(p, ph[j], pl[j]);
        rmul[j][0] = linv_t[8 * j + 2 * t];
        rmul[j][1] = linv_t[8 * j + 2 * t + 1];
      }
      wctf32::product_nn<D, kNt, true>(tot_v, ph, pl, dot, kStride, g, t, rmul);
    }
    if constexpr (kDoDk) {
      float dp[kNt][4];  // dP^T = V dO^T
      wctf32::product_nt<D, kNt>(dp, vw, 1.f, dot, kStride, g, t);
      uint32_t mh[kNt][4], ml[kNt][4];
      float rmul[kNt][2];  // scale / l of the queries (rows of Q) a thread's B fragments read
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const float dv0 = dv_t[8 * j + 2 * t], dv1 = dv_t[8 * j + 2 * t + 1];  // columns 2t, 2t + 1
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool inside;
          const float p = clamped_exp2(sc[j][e], inside);
          m[e] = inside ? p * (dp[j][e] - (e % 2 ? dv1 : dv0)) : 0.f;
        }
        c_to_a(m, mh[j], ml[j]);
        rmul[j][0] = scale * linv_t[8 * j + 2 * t];
        rmul[j][1] = scale * linv_t[8 * j + 2 * t + 1];
      }
      wctf32::product_nn<D, kNt, true>(tot_k, mh, ml, qt, kStride, g, t, rmul);
    }
  }

  const size_t out = head + (size_t)(block_key0 + warp * 16) * D;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int col = 8 * s + 2 * t;
    if constexpr (kDoDv) {
      *reinterpret_cast<float2*>(dv + out + g * D + col) = make_float2(tot_v[s][0], tot_v[s][1]);
      *reinterpret_cast<float2*>(dv + out + (g + 8) * D + col) = make_float2(tot_v[s][2], tot_v[s][3]);
    }
    if constexpr (kDoDk) {
      *reinterpret_cast<float2*>(dk + out + g * D + col) = make_float2(tot_k[s][0], tot_k[s][1]);
      *reinterpret_cast<float2*>(dk + out + (g + 8) * D + col) = make_float2(tot_k[s][2], tot_k[s][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The wgmma passes (D = 16, 32, 64, 128; see the note at the top).

template <int D>
struct Wg {
  static constexpr int kDqC = D <= 64 ? 2 : 1;  // consumer warpgroups of pass 1 (64 own rows each)
  using DqTeam = wctf32::Team<kDqC>;
  using Own = Plane<kRows, D>;  // a consumer's own rows, as they lie
  // pass 1: tiles of kTile keys (32 at D = 64: 64 spilled 412 bytes in the consumers' 188 registers); [consumer]
  // own Q (x scale log2 e) and dO planes, [consumer] Dv and 1/l of the own rows (1024 bytes), group A (K, V
  // planes), group B (K^T planes)
  struct Dq {
    static constexpr int kTile = D <= 32 ? 64 : 32;
    using Rows = Plane<kTile, D>;  // a walked tile, as it lies
    using Tr = Plane<D, kTile>;    // and transposed
    static constexpr int kVec = kDqC * 4 * Own::kBytes;
    static constexpr int kA = kVec + 1024;
    static constexpr int kB = kA + 4 * Rows::kBytes;
    static constexpr int kBytes = kB + 2 * Tr::kBytes;
  };
  // pass 2: tiles of kTile queries; [consumer] own K (x scale log2 e) [, V] planes, group A (Q [, dO] planes),
  // group B ([dO^T,] [Q^T] planes, then the tile's 1/l and Dv)
  template <int kOut>
  struct Dkv {
    static constexpr bool kDoDv = kOut & 1, kDoDk = kOut & 2;
    // two consumers up to D = 64 and in D = 128's dV launch (there one n-chunk of dV in flight, for registers);
    // the producer keeps 88 registers at D = 64, so that the consumers hold 208 (128 and 188 elsewhere)
    static constexpr int kC = D <= 64 || kOut == 1 ? 2 : 1;
    using Team = wctf32::Team<kC, D == 64 ? 88 : 128>;
    static constexpr int kTile = D <= 32 ? 64 : 32;
    static constexpr int kNg = D == 128 && kC == 2 ? 1 : Cols<D>::kNc;  // n-chunks of dV, dK in flight
    using Rows = Plane<kTile, D>;
    using Tr = Plane<D, kTile>;
    static constexpr int kOwnStride = (kDoDk ? 4 : 2) * Own::kBytes;
    static constexpr int kA = kC * kOwnStride;
    static constexpr int kB = kA + (kDoDk ? 4 : 2) * Rows::kBytes;
    static constexpr int kVec = kB + ((kDoDv ? 2 : 0) + (kDoDk ? 2 : 0)) * Tr::kBytes;
    static constexpr int kBytes = kVec + 2 * kTile * 4;
  };
};

// Pass 1: dQ for a block's kDqC x 64 query rows; also writes Dv and 1/l of its rows to dvec and linv_out.
template <int D>
__global__ void __launch_bounds__(Wg<D>::DqTeam::kThreads, 1)
    flash_bwd_f32_dq_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ o,
                                  const float* __restrict__ d_o, const float* __restrict__ l, float* __restrict__ dq,
                                  float* __restrict__ dvec, float* __restrict__ linv_out, int n, float scale,
                                  float scale_log2) {
  using W = Wg<D>;
  using L = typename W::Dq;
  using Own = typename W::Own;
  using Rows = typename L::Rows;
  using Tr = typename L::Tr;
  constexpr int kC = W::kDqC, kTile = L::kTile, kNw = Cols<D>::kNw, kNc = Cols<D>::kNc;
  using Team = typename W::DqTeam;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm(smem_raw);
  // consumer c's own planes: Q hi, lo, dO hi, lo from sm.addr + 4 c Own::kBytes
  float* const dv_s = sm.floats(L::kVec);  // [consumer][64]: Dv of the own rows
  float* const linv_s = dv_s + kC * kRows;  // and their 1/l
  const uint32_t kh = sm.addr + L::kA, kl = kh + Rows::kBytes, vh = kl + Rows::kBytes, vl = vh + Rows::kBytes;
  const uint32_t kth = sm.addr + L::kB, ktl = kth + Tr::kBytes;

  const size_t head = (size_t)blockIdx.y * n * D, rows = (size_t)blockIdx.y * n;
  const int row0 = blockIdx.x * kC * kRows, tiles = n / kTile;
  if (Team::producer()) {
    Team::producer_regs();
    const int ptid = threadIdx.x - kC * 128;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int crow0 = row0 + c * kRows;
      if (crow0 >= n) break;
      const uint32_t qh = sm.addr + 4 * c * Own::kBytes, ql = qh + Own::kBytes, doh = ql + Own::kBytes,
                     dol = doh + Own::kBytes;
      {
        Fill<kRows, D, false> dox, ox;
        dox.load(d_o + head + (size_t)crow0 * D, ptid);
        ox.load(o + head + (size_t)crow0 * D, ptid);
        dox.store(doh, dol, 1.f, ptid);
        // Dv of each row: a row's D / 4 chunks lie in consecutive threads of one warp
        constexpr int kC4 = D / 4;
        static_assert(32 % kC4 == 0, "a row's chunks in one warp");
#pragma unroll
        for (int it = 0; it < decltype(dox)::kPer; ++it) {
          const float4 a = dox.x[it], b = ox.x[it];
          float acc = a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
#pragma unroll
          for (int off = kC4 / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
          const int r = (ptid + 128 * it) / kC4;
          if (ptid % kC4 == 0) {
            dv_s[c * kRows + r] = acc;
            dvec[rows + crow0 + r] = acc;
          }
        }
        if (ptid < kRows) {
          const float li = 1.f / l[rows + crow0 + ptid];
          linv_s[c * kRows + ptid] = li;
          linv_out[rows + crow0 + ptid] = li;
        }
      }
      Fill<kRows, D, false> qx;
      qx.load(q + head + (size_t)crow0 * D, ptid);
      qx.store(qh, ql, scale_log2, ptid);
    }
    for (int t = 0; t < tiles; ++t) {
      const float* kg = k + head + (size_t)t * kTile * D;
      {
        Fill<kTile, D, false> kx, vx;
        kx.load(kg, ptid);
        vx.load(v + head + (size_t)t * kTile * D, ptid);
        if (t > 0) Team::sync(kEmptyA);
        kx.store(kh, kl, 1.f, ptid);
        vx.store(vh, vl, 1.f, ptid);
        wcflash::fence_async_proxy();
        Team::arrive(kFullA);
      }
      Fill<kTile, D, true> ktx;
      ktx.load(kg, ptid);
      if (t > 0) Team::sync(kEmptyB);
      ktx.store(kth, ktl, 1.f, ptid);
      wcflash::fence_async_proxy();
      Team::arrive(kFullB);
    }
    return;
  }

  // consumer c: warp w owns query rows 16w..16w+15 of its 64; this thread rows g and g + 8. A consumer past the
  // last row (n an odd multiple of 64) runs on whatever its planes hold and stores nothing.
  Team::consumer_regs();
  const int c = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32, g = lane / 4;
  const int t4 = lane % 4, crow0 = row0 + c * kRows;
  const uint32_t qh = sm.addr + 4 * c * Own::kBytes, ql = qh + Own::kBytes, doh = ql + Own::kBytes,
                 dol = doh + Own::kBytes;
  float tot[kNc][kNw / 2] = {};  // dQ (m K), summed over the tiles
  float dv_r[2], linv_r[2];
  for (int t = 0; t < tiles; ++t) {
    Team::sync(kFullA);
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dv_r[h] = dv_s[c * kRows + warp * 16 + g + 8 * h];
        linv_r[h] = linv_s[c * kRows + warp * 16 + g + 8 * h];
      }
    }
    float s[2][kTile / 2];  // S (exp2 domain) and dP = dO V^T
    wctf32::scores<D, kTile, 2>(s, {{qh, ql}, {doh, dol}}, {{kh, kl}, {vh, vl}});
    if (t + 1 < tiles) Team::arrive(kEmptyA);
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {  // m, in S's place
      bool inside;
      const float p = clamped_exp2(s[0][i], inside);
      s[0][i] = inside ? p * (s[1][i] - dv_r[(i >> 1) & 1]) : 0.f;
    }
    Team::sync(kFullB);
    wctf32::accumulate<D, kTile / 8, Cols<D>::kNc>(tot, kth, ktl, [&](int j, uint32_t(&ah)[4], uint32_t(&al)[4]) {
      const float cf[4] = {s[0][4 * j], s[0][4 * j + 1], s[0][4 * j + 2], s[0][4 * j + 3]};
      c_to_a(cf, ah, al);
    });
    if (t + 1 < tiles) Team::arrive(kEmptyB);
  }
  if (crow0 >= n) return;

  const float mul[2] = {scale * linv_r[0], scale * linv_r[1]};
  float* out = dq + head + (size_t)(crow0 + warp * 16) * D;
#pragma unroll
  for (int h = 0; h < kNc; ++h)
#pragma unroll
    for (int j = 0; j < kNw / 8; ++j) {
      const int col = h * kNw + 8 * j + 2 * t4;
      const float* cf = &tot[h][4 * j];
      *reinterpret_cast<float2*>(out + g * D + col) = make_float2(cf[0] * mul[0], cf[1] * mul[0]);
      *reinterpret_cast<float2*>(out + (g + 8) * D + col) = make_float2(cf[2] * mul[1], cf[3] * mul[1]);
    }
}

// Pass 2: for a block's kC x 64 keys, dV (kOut & 1) and dK (kOut & 2), walking the query tiles with their 1/l
// and Dv from pass 1.
template <int D, int kOut>
__global__ void __launch_bounds__(Wg<D>::template Dkv<kOut>::Team::kThreads, 1)
    flash_bwd_f32_dkv_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ d_o,
                                   const float* __restrict__ linv, const float* __restrict__ dvec,
                                   float* __restrict__ dk, float* __restrict__ dv, int n, float scale,
                                   float scale_log2) {
  using W = Wg<D>;
  using L = typename W::template Dkv<kOut>;
  using Own = typename W::Own;
  using Rows = typename L::Rows;
  using Tr = typename L::Tr;
  constexpr int kC = L::kC, kTile = L::kTile, kNw = Cols<D>::kNw, kNc = Cols<D>::kNc;
  constexpr bool kDoDv = L::kDoDv, kDoDk = L::kDoDk;
  constexpr int kScores = kDoDk ? 2 : 1;  // S^T, and dP^T for dK
  using Team = typename L::Team;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm(smem_raw);
  // consumer c's own planes: K hi, lo [, V hi, lo] from sm.addr + c L::kOwnStride
  const uint32_t qh = sm.addr + L::kA, ql = qh + Rows::kBytes, doh = ql + Rows::kBytes, dol = doh + Rows::kBytes;
  const uint32_t dth = sm.addr + L::kB, dtl = dth + Tr::kBytes;                     // dO^T (dV)
  const uint32_t qth = dth + (kDoDv ? 2 : 0) * Tr::kBytes, qtl = qth + Tr::kBytes;  // Q^T (dK)
  float* const linv_t = sm.floats(L::kVec);  // the tile's 1/l
  float* const dv_t = linv_t + kTile;        // and Dv

  const size_t head = (size_t)blockIdx.y * n * D, rows = (size_t)blockIdx.y * n;
  const int key0 = blockIdx.x * kC * kRows, tiles = n / kTile;
  if (Team::producer()) {
    Team::producer_regs();
    const int ptid = threadIdx.x - kC * 128;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int ckey0 = key0 + c * kRows;
      if (ckey0 >= n) break;
      const uint32_t kh = sm.addr + c * L::kOwnStride, kl = kh + Own::kBytes;
      wctf32::fill_own<D>(k + head + (size_t)ckey0 * D, kh, kl, scale_log2, ptid);
      if constexpr (kDoDk)
        wctf32::fill_own<D>(v + head + (size_t)ckey0 * D, kl + Own::kBytes, kl + 2 * Own::kBytes, 1.f, ptid);
    }
    for (int t = 0; t < tiles; ++t) {
      const float* qg = q + head + (size_t)t * kTile * D;
      const float* dog = d_o + head + (size_t)t * kTile * D;
      {
        Fill<kTile, D, false> qx, dox;
        qx.load(qg, ptid);
        if constexpr (kDoDk) dox.load(dog, ptid);
        if (t > 0) Team::sync(kEmptyA);
        qx.store(qh, ql, 1.f, ptid);
        if constexpr (kDoDk) dox.store(doh, dol, 1.f, ptid);
        wcflash::fence_async_proxy();
        Team::arrive(kFullA);
      }
      Fill<kTile, D, true> dotx, qtx;
      if constexpr (kDoDv) dotx.load(dog, ptid);
      if constexpr (kDoDk) qtx.load(qg, ptid);
      float li = 0.f, dvv = 0.f;
      if (ptid < kTile) {
        li = linv[rows + (size_t)t * kTile + ptid];
        if constexpr (kDoDk) dvv = dvec[rows + (size_t)t * kTile + ptid];
      }
      if (t > 0) Team::sync(kEmptyB);
      if constexpr (kDoDv) dotx.store(dth, dtl, 1.f, ptid);
      if constexpr (kDoDk) qtx.store(qth, qtl, 1.f, ptid);
      if (ptid < kTile) {
        linv_t[ptid] = li;
        dv_t[ptid] = dvv;
      }
      wcflash::fence_async_proxy();
      Team::arrive(kFullB);
    }
    return;
  }

  // consumer c: warp w owns keys 16w..16w+15 of its 64; S^T has keys as rows, the tile's queries as columns
  // (this thread's: 8j + 2 t4 and 8j + 2 t4 + 1 of step j). A consumer past the last key runs on whatever its
  // planes hold and stores nothing.
  Team::consumer_regs();
  const int c = threadIdx.x / 128, warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32, g = lane / 4;
  const int t4 = lane % 4, ckey0 = key0 + c * kRows;
  const uint32_t kh = sm.addr + c * L::kOwnStride, kl = kh + Own::kBytes, vh = kl + Own::kBytes,
                 vl = vh + Own::kBytes;
  float tot_v[kDoDv ? kNc : 1][kNw / 2] = {};  // dV
  float tot_k[kDoDk ? kNc : 1][kNw / 2] = {};  // dK
  for (int t = 0; t < tiles; ++t) {
    Team::sync(kFullA);
    float s[kScores][kTile / 2];  // S^T = K Q^T (exp2 domain) [and dP^T = V dO^T]
    if constexpr (kDoDk)
      wctf32::scores<D, kTile, 2>(s, {{kh, kl}, {vh, vl}}, {{qh, ql}, {doh, dol}});
    else
      wctf32::scores<D, kTile, 1>(s, {{kh, kl}}, {{qh, ql}});
    if (t + 1 < tiles) Team::arrive(kEmptyA);
    Team::sync(kFullB);
    // the A operands in place: p^T / l (dV) in S^T's, m^T scale / l (dK) in dP^T's, the query's 1/l and Dv
    // from group B
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * t4 + (i & 1);
      const float li = linv_t[col];
      bool inside;
      const float p = clamped_exp2(s[0][i], inside);
      if constexpr (kDoDk) s[1][i] = inside ? p * (s[1][i] - dv_t[col]) * (scale * li) : 0.f;
      s[0][i] = p * li;
    }
    if constexpr (kDoDv)  // dV += (p^T / l) dO
      wctf32::accumulate<D, kTile / 8, L::kNg>(tot_v, dth, dtl, [&](int j, uint32_t(&ah)[4], uint32_t(&al)[4]) {
        const float cf[4] = {s[0][4 * j], s[0][4 * j + 1], s[0][4 * j + 2], s[0][4 * j + 3]};
        c_to_a(cf, ah, al);
      });
    if constexpr (kDoDk)  // dK += (m^T scale / l) Q
      wctf32::accumulate<D, kTile / 8, L::kNg>(tot_k, qth, qtl, [&](int j, uint32_t(&ah)[4], uint32_t(&al)[4]) {
        const float cf[4] = {s[1][4 * j], s[1][4 * j + 1], s[1][4 * j + 2], s[1][4 * j + 3]};
        c_to_a(cf, ah, al);
      });
    if (t + 1 < tiles) Team::arrive(kEmptyB);
  }
  if (ckey0 >= n) return;

  const size_t out = head + (size_t)(ckey0 + warp * 16) * D;
#pragma unroll
  for (int h = 0; h < kNc; ++h)
#pragma unroll
    for (int j = 0; j < kNw / 8; ++j) {
      const int col = h * kNw + 8 * j + 2 * t4;
      if constexpr (kDoDv) {
        const float* cf = &tot_v[h][4 * j];
        *reinterpret_cast<float2*>(dv + out + g * D + col) = make_float2(cf[0], cf[1]);
        *reinterpret_cast<float2*>(dv + out + (g + 8) * D + col) = make_float2(cf[2], cf[3]);
      }
      if constexpr (kDoDk) {
        const float* cf = &tot_k[h][4 * j];
        *reinterpret_cast<float2*>(dk + out + g * D + col) = make_float2(cf[0], cf[1]);
        *reinterpret_cast<float2*>(dk + out + (g + 8) * D + col) = make_float2(cf[2], cf[3]);
      }
    }
}

// Sets a kernel's dynamic shared memory (1024 bytes more than its layout, for the alignment) and launches it.
template <class Kernel, class... Args>
cudaError_t launch_smem(Kernel kernel, int bytes, int threads, dim3 grid, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, int kOut>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* d_o, const float* linv,
                       const float* dvec, float* dk, float* dv, dim3 grid, int n, float scale, cudaStream_t stream) {
  if constexpr (kWgmma<D>) {
    using L = typename Wg<D>::template Dkv<kOut>;
    constexpr int smem = L::kBytes + 1024, kC = L::kC;
    static_assert(smem <= 232448, "a block's shared memory");
    return launch_smem(flash_bwd_f32_dkv_wgmma_kernel<D, kOut>, smem, L::Team::kThreads,
                       dim3((grid.x + kC - 1) / kC, grid.y), stream, q, k, v, d_o, linv, dvec, dk, dv, n, scale,
                       scale * kLog2e);
  } else {
    return launch_smem(flash_bwd_f32_dkv_kernel<D, kOut>, Cfg<D>::kDkvSmemBytes, kThreads, grid, stream, q, k, v,
                       d_o, linv, dvec, dk, dv, n, scale, scale * kLog2e);
  }
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o, const float* d_o,
                       const float* l, float* dq, float* dk, float* dv, float* scratch, int bh, int n, float scale,
                       cudaStream_t stream) {
  float* dvec = scratch;                   // Dv, pass 1 -> pass 2
  float* linv = scratch + (size_t)bh * n;  // 1 / l, pass 1 -> pass 2
  const dim3 grid(n / kRows, bh);
  cudaError_t err;
  if constexpr (kWgmma<D>) {
    constexpr int smem = Wg<D>::Dq::kBytes + 1024, kC = Wg<D>::kDqC;
    static_assert(smem <= 232448, "a block's shared memory");
    err = launch_smem(flash_bwd_f32_dq_wgmma_kernel<D>, smem, Wg<D>::DqTeam::kThreads,
                      dim3((grid.x + kC - 1) / kC, grid.y), stream, q, k, v, o, d_o, l, dq, dvec, linv, n, scale,
                      scale * kLog2e);
  } else {
    err = launch_smem(flash_bwd_f32_dq_kernel<D>, Cfg<D>::kDqSmemBytes, kThreads, grid, stream, q, k, v, o, d_o, l,
                      dq, dvec, linv, n, scale, scale * kLog2e);
  }
  if (err != cudaSuccess) return err;
  if constexpr (D >= 128) {  // pass 2 as a dV and a dK launch (see the note at the top)
    err = launch_dkv<D, 1>(q, k, v, d_o, linv, dvec, dk, dv, grid, n, scale, stream);
    if (err != cudaSuccess) return err;
    return launch_dkv<D, 2>(q, k, v, d_o, linv, dvec, dk, dv, grid, n, scale, stream);
  } else {
    return launch_dkv<D, 3>(q, k, v, d_o, linv, dvec, dk, dv, grid, n, scale, stream);
  }
}

// The build (ops/cuda_build.VARIANTS) compiles this file once for each head
// dim with -DWC_BWD_F32_D=<d>, which instantiates that head dim's kernels, and
// once without, which holds the entry point: in one object the five head dims
// were the build's longest compile by far (chip_smoke.py's phase 1 prints the
// build's time).
#define WC_BWD_F32_LAUNCH(D)                                                                                       \
  cudaError_t launch_bwd<D>(const float*, const float*, const float*, const float*, const float*, const float*,  \
                            float*, float*, float*, float*, int, int, float, cudaStream_t)
#ifdef WC_BWD_F32_D
template WC_BWD_F32_LAUNCH(WC_BWD_F32_D);
#else
extern template WC_BWD_F32_LAUNCH(16);
extern template WC_BWD_F32_LAUNCH(32);
extern template WC_BWD_F32_LAUNCH(64);
extern template WC_BWD_F32_LAUNCH(128);
extern template WC_BWD_F32_LAUNCH(192);
#endif

}  // namespace wcbwd32

#ifndef WC_BWD_F32_D
// q, k, v, o, d_o, dq, dk, dv: contiguous f32 (bh, n, d), 16-byte aligned.
// l: f32 (bh, n), the forward's row sums. dvec: f32 (2, bh, n) scratch for Dv
// and 1/l, written by pass 1 and read by pass 2. d in (16, 32, 64, 128, 192),
// n a multiple of 64. Returns the cudaError_t of the launches.
extern "C" int wc_flash_bwd_f32(const float* q, const float* k, const float* v, const float* o, const float* d_o,
                                const float* l, float* dq, float* dk, float* dv, float* dvec, int bh, int n, int d,
                                float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcbwd32::kRows != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return wcbwd32::launch_bwd<16>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, s);
    case 32: return wcbwd32::launch_bwd<32>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, s);
    case 64: return wcbwd32::launch_bwd<64>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, s);
    case 128: return wcbwd32::launch_bwd<128>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, s);
    case 192: return wcbwd32::launch_bwd<192>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif
