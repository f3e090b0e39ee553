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
// seven products (S and dO V^T twice; eight at D = 128, below) and 2 N^2
// exponentials against that bound.
//
// Two passes, as K3's, so there are no atomics and the gradients repeat bit
// for bit:
//   * Pass 1 (dQ): a block owns 64 query rows; per tile of keys S = Q K^T
//     and dP = dO V^T, m in registers, dQ += m K; it also writes Dv and 1/l
//     of its rows to an f32 scratch for pass 2.
//   * Pass 2 (dK, dV): a block owns 64 keys; per tile of queries S^T = K Q^T
//     and dP^T = V dO^T, so p^T and m^T come out with keys as rows, then dV
//     += (p^T / l) dO and dK += (m^T scale / l) Q, the query's 1/l and scale
//     multiplied into p^T and m^T before they are split.
//
// The Hopper design (D = 16, 32, 64, 128; flash_tf32.cuh's second half):
//   * A block is one producer warpgroup and kC consumer warpgroups (two up to
//     D = 64 and in D = 128's dV launch, one otherwise), each consumer 64 own
//     rows. The producer loads f32 rows with 16-byte loads, all issued before
//     it waits for the consumers, splits each element once for the block into
//     TF32 hi and lo, and stores the planes in the 128-byte-swizzled K-major
//     layout wgmma reads: each consumer's own rows once (Q and dO, or K and V;
//     Q and K times scale log2 e), then for every tile two plane groups, each
//     behind its own FULL / EMPTY named barriers, so that it fills one while
//     the consumers read the other: group A the tile as it lies (B of the
//     score products), group B the tile transposed (B of m K, p^T dO, m^T Q:
//     tf32 wgmma takes K-major operands only) with the tile's 1/l and Dv.
//   * A consumer runs every product as wgmma.mma_async m64nNk8 .tf32, three a
//     k-step: the score products with both operands from shared memory, the
//     others with A (p, m and their transposes, straight from the score
//     accumulators, c_to_a) from registers. Each sum runs in chains of four
//     k-steps, each chain its own accumulator, joined by FADD after the wait.
//   * Two consumers overlap one's exponentials, splits and FADD joins with
//     the other's MMAs. ptxas compiles a 384-thread block at 168 registers a
//     thread; setmaxnreg then gives the producer 128 (88 in pass 2 at D = 64,
//     112 in D = 128's dV launch) and each consumer the rest of the block's
//     168 x 384, in multiples of 8: 184 (208, 192). The producer at 104
//     spilled 76-352 bytes (ptxas allocates each region to its setmaxnreg
//     count); a budget past the block's registers made setmaxnreg.inc wait
//     forever.
//   * Walked tiles of 64 rows at D <= 32 and 32 from D = 64 on: 64 spilled
//     412 bytes in pass 1's consumers at D = 64, and at D = 128 and pass 2 at
//     64 two consumers' planes leave no room for 64. At D = 128 dK and dV
//     together are 128 registers of running sums and their own K and V planes
//     128 KB a consumer: pass 2 is launched twice there, once for dV (S^T and
//     p^T dO) and once for dK (S^T, dP^T and m^T Q), and S^T is formed twice.
//   * Shared memory (the 1024-byte alignment included), pass 1 / pass 2: D =
//     16 58 / 66 KB, 32 114 / 130 KB, 64 178 / 193 KB, 128 226 / 193 (dV) and
//     225 KB (dK).
//   * What binds it (PERF.md section 6; H100 80GB HBM3 at 700 W): at (4096,
//     64), B*H = 32, pass 1 takes 2.67 ms and pass 2 3.35 ms against 1.25
//     and 1.67 ms of their own tensor time: each consumer's serial chain of
//     MMA waits, exponentials, splits and FADD joins, which two consumers
//     only partly overlap.
//
// The pair design (D = 192): there the own rows in hi and lo, 64 x 192 x 8
// bytes = 96 KB an operand, leave no room for the walked tiles (two operands:
// 192 of the 227 KB a block may have). So:
//   * A block is a producer and two consumer warpgroups that share the
//     block's 64 rows and split the products: in pass 1 consumer 0 forms S
//     and p, consumer 1 dP and m; in pass 2 consumer 0 forms S^T and p^T / l
//     and sums dV, consumer 1 forms dP^T and m^T scale / l and sums dK, in
//     one launch: seven products in all. Values pass between the two threads
//     of one tid, which hold the same elements of their accumulators, through
//     shared memory; each consumer needs one own operand alone.
//   * The own rows stay raw f32, 48 KB an operand, in the order of the
//     register A fragments (fill_own_raw), and a consumer splits each
//     k-step's fragment as it loads (one 16-byte load and four splits a
//     k-step): a split of the own rows per walked tile instead of one per
//     block, in exchange for 32-row tiles.
//   * The products whose reduction runs along the walked tile are formed
//     transposed: dQ^T = K^T m^T, dV^T = dO^T (p^T / l), dK^T = Q^T (m^T
//     scale / l). Their A operand is the tile's own planes read transposed
//     into registers (accumulate_tn) and their B the 64 x 32 plane pair of m
//     or p that a consumer stores from its accumulators: no transposed tile
//     planes. dQ is summed in halves, 32 queries a consumer.
//   * Shared memory, pass 1 / pass 2: 218 / 226 KB (own rows 96, tile planes
//     96, m or p and m planes 16 / 32, the rest p, the mask, 1/l and Dv).
//     Registers as in the Hopper design: 184 a consumer, 128 the producer.
#include <cuda_runtime.h>

#include "flash_tf32.cuh"

namespace wcbwd32 {

using wcflash::kClampLog2;
using wcflash::kLog2e;
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

constexpr int kRows = 64;  // a block's own rows, or a consumer's: queries in pass 1, keys in pass 2

// exp2-domain score y -> p = exp2(clip(y)), and whether the clamp left it alone
__device__ __forceinline__ float clamped_exp2(float y, bool& inside) {
  inside = fabsf(y) <= kClampLog2;
  return ex2(fminf(fmaxf(y, -kClampLog2), kClampLog2));
}

// ---------------------------------------------------------------------------
// The wgmma passes (D = 16, 32, 64, 128; see the note at the top).

template <int D>
struct Wg {
  static constexpr int kDqC = D <= 64 ? 2 : 1;  // consumer warpgroups of pass 1 (64 own rows each)
  using DqTeam = wctf32::Team<kDqC>;
  using Own = Plane<kRows, D>;  // a consumer's own rows, as they lie
  // pass 1: tiles of kTile keys (32 at D = 64: 64 spilled 412 bytes in the consumers' 184 registers); [consumer]
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
    // the producer keeps 88 registers at D = 64, so that the consumers hold 208 (128 and 184 elsewhere)
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

// ---------------------------------------------------------------------------
// The pair passes (D = 192; see the note at the top).

// Named barriers among part of the block (Team's count every thread of it): `bar_sync` waits until kCount threads
// have come, `bar_arrive` counts this one and goes on.
template <int kCount>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kCount) : "memory");
}
template <int kCount>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kCount) : "memory");
}
// the consumers' own barriers, beside the Team's kFullA .. kEmptyB: the score consumer's values are stored (256
// threads), the m planes are stored (256), and each consumer's stores are done (128 each)
enum : int { kPFull = 5, kMFull = 6, kStored0 = 7, kStored1 = 8 };

template <int D>
struct Pair {
  static constexpr int kTile = 32;     // rows of a walked tile
  static constexpr int kH = D / 64;    // m-blocks of the transposed products (64 of the D columns each)
  using Team = wctf32::Team<2>;
  using Rows = Plane<kTile, D>;        // a walked tile, as it lies
  using Sq = Plane<kRows, kTile>;      // p or m: the own rows x the tile, tile rows in column_of order
  static constexpr int kOwnBytes = kRows * D * 4;  // one operand's own rows, raw f32 in fragment order
  // pass 1: own Q (x scale log2 e), own dO, K planes (group A), V planes (group B), m planes, the S consumer's p
  // (thread order, signed by the clamp), Dv and 1/l of the own rows
  struct Dq {
    static constexpr int kA = 2 * kOwnBytes;
    static constexpr int kB = kA + 2 * Rows::kBytes;
    static constexpr int kM = kB + 2 * Rows::kBytes;
    static constexpr int kP = kM + 2 * Sq::kBytes;
    static constexpr int kVec = kP + kTile / 2 * 128 * 4;
    static constexpr int kBytes = kVec + 2 * kRows * 4;
  };
  // pass 2: own K (x scale log2 e), own V, Q planes (group A), dO planes (group B), p^T / l planes, m^T scale / l
  // planes, the clamp's mask (a word a consumer thread), the tile's 1/l and Dv (group A)
  struct Dkv {
    static constexpr int kA = 2 * kOwnBytes;
    static constexpr int kB = kA + 2 * Rows::kBytes;
    static constexpr int kP = kB + 2 * Rows::kBytes;
    static constexpr int kM = kP + 2 * Sq::kBytes;
    static constexpr int kMask = kM + 2 * Sq::kBytes;
    static constexpr int kVec = kMask + 128 * 4;
    static constexpr int kBytes = kVec + 2 * kTile * 4;
  };
};

// The block's 64 own rows (row stride D at src), times mul, raw f32 in the consumers' fragment order: the A fragment
// of k-step s for consumer thread i (rows 16w + g and 16w + g + 8, columns 8s + t and 8s + t + 4: the mma.sync A
// layout, w = i / 32, lane = 4g + t) as one float4 at own[128 s + i], stored by producer thread i. Loads in rounds of
// eight k-steps, a round's all issued before any is stored.
template <int D>
__device__ __forceinline__ void fill_own_raw(const float* __restrict__ src, float4* own, float mul, int ptid) {
  constexpr int kRound = 8;
  static_assert(D / 8 % kRound == 0, "whole rounds");
  const float* r0 = src + (size_t)(16 * (ptid / 32) + ptid % 32 / 4) * D + ptid % 4;
  const float* r1 = r0 + 8 * D;
#pragma unroll
  for (int s0 = 0; s0 < D / 8; s0 += kRound) {
    float4 x[kRound];
#pragma unroll
    for (int j = 0; j < kRound; ++j) {
      const int c = 8 * (s0 + j);
      x[j] = make_float4(__ldg(r0 + c), __ldg(r1 + c), __ldg(r0 + c + 4), __ldg(r1 + c + 4));
    }
#pragma unroll
    for (int j = 0; j < kRound; ++j)
      own[128 * (s0 + j) + ptid] = make_float4(x[j].x * mul, x[j].y * mul, x[j].z * mul, x[j].w * mul);
  }
}

// out (64 x N) = A B^T over D: A the consumer's own rows (fill_own_raw's order), each k-step's fragment split into
// TF32 hi and lo as it loads; B N staged rows (planes b_hi, b_lo, Plane<N, D>). One chain of kChain k-steps in flight
// (two spilled in pass 1's 184-register consumers), each into an accumulator of its own, joined by FADD in order
// after its wait.
template <int D, int N>
__device__ __forceinline__ void scores_own(float (&out)[N / 2], const float4* own, int tid, uint32_t b_hi,
                                           uint32_t b_lo) {
  using PB = Plane<N, D>;
  constexpr int kChain = wctf32::kChain;
  static_assert(D / 8 % kChain == 0, "whole chains");
#pragma unroll
  for (int c0 = 0; c0 < D / 8; c0 += kChain) {
    uint32_t ah[kChain][4], al[kChain][4];
#pragma unroll
    for (int j = 0; j < kChain; ++j) {
      const float4 x = own[128 * (c0 + j) + tid];
      wctf32::split(x.x, ah[j][0], al[j][0]);
      wctf32::split(x.y, ah[j][1], al[j][1]);
      wctf32::split(x.z, ah[j][2], al[j][2]);
      wctf32::split(x.w, ah[j][3], al[j][3]);
    }
    float part[N / 2];
    wcflash::fence_regs(part);
    wctf32::fence_frags(ah);
    wctf32::fence_frags(al);
    wcflash::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kChain; ++j)
      wctf32::wgmma_3xtf32(part, ah[j], al[j], PB::desc(b_hi, 0, c0 + j), PB::desc(b_lo, 0, c0 + j), j > 0);
    wcflash::wgmma_commit();
    wcflash::wgmma_wait<0>();
    wcflash::fence_regs(part);
    wctf32::fence_frags(ah);  // the MMAs read the fragments until the wait
    wctf32::fence_frags(al);
#pragma unroll
    for (int r = 0; r < N / 2; ++r) out[r] = c0 == 0 ? part[r] : out[r] + part[r];
  }
}

// tot[h] (64 x N) += A_h B over a walked tile of T = 8 kChain rows, h = 0 .. D / 64 - 1: A_h(d, k) = tile[row k][64 h
// + d], gathered from the tile's planes as the producer split them (a_hi, a_lo: Plane<T, D>, generic pointers), the
// k-step's rows in column_of order (slot t <- row 2t, slot t + 4 <- row 2t + 1, so that a warp's 32 loads hit 32
// banks); B rows n0 .. n0 + N - 1 of an Sq plane pair (row n, tile row r at column column_of(r)). One chain a tile;
// each h's partial joins tot[h] by FADD.
template <int D, int T, int N>
__device__ __forceinline__ void accumulate_tn(float (&tot)[D / 64][N / 2], const unsigned char* a_hi,
                                              const unsigned char* a_lo, uint32_t b_hi, uint32_t b_lo, int n0, int tid) {
  using PA = Plane<T, D>;
  using PB = Plane<kRows, T>;
  constexpr int kKs = T / 8;
  static_assert(kKs == wctf32::kChain && PA::kPanelCols == 32, "one chain a tile; 32-column panels");
  // the byte offsets of rows 2t (+1) and columns 16 (w % 2) + g (+8) of panel w / 2 of each 64-column block: a
  // k-step adds 8 rows (1024 bytes), a block two panels; the swizzle depends on the row's low three bits alone
  const int w = tid / 32, g = tid % 32 / 4, t4 = tid % 4;
  int off[2][2];  // [row 2t + e][column + 8 f]
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int f = 0; f < 2; ++f) off[e][f] = w / 2 * PA::kPanelBytes + PA::at(2 * t4 + e, 16 * (w % 2) + g + 8 * f);
#pragma unroll
  for (int h = 0; h < D / 64; ++h) {
    uint32_t ah[kKs][4], al[kKs][4];
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      const int base = 2 * h * PA::kPanelBytes + 8 * ks * PA::kRowBytes;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int f = 0; f < 2; ++f) {  // a0 (row g, slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          ah[ks][2 * e + f] = *reinterpret_cast<const uint32_t*>(a_hi + base + off[e][f]);
          al[ks][2 * e + f] = *reinterpret_cast<const uint32_t*>(a_lo + base + off[e][f]);
        }
    }
    float part[N / 2];
    wcflash::fence_regs(part);
    wctf32::fence_frags(ah);
    wctf32::fence_frags(al);
    wcflash::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks)
      wctf32::wgmma_3xtf32(part, ah[ks], al[ks], PB::desc(b_hi, n0, ks), PB::desc(b_lo, n0, ks), ks > 0);
    wcflash::wgmma_commit();
    wcflash::wgmma_wait<0>();
    wcflash::fence_regs(part);
    wctf32::fence_frags(ah);
    wctf32::fence_frags(al);
#pragma unroll
    for (int r = 0; r < N / 2; ++r) tot[h][r] += part[r];
  }
}

// Byte offset in an Sq plane of accumulator value i (row 16w + g + 8 ((i >> 1) & 1), tile column 8 (i / 4) + 2t +
// (i & 1)) of consumer thread tid, its column at column_of.
template <class Sq>
__device__ __forceinline__ uint32_t sq_at(int tid, int i) {
  const int row = 16 * (tid / 32) + tid % 32 / 4 + 8 * ((i >> 1) & 1), col = 8 * (i / 4) + 2 * (tid % 4) + (i & 1);
  return Sq::at(row, wctf32::column_of(col));
}

// Pass 1: dQ for a block's 64 query rows, by two consumers on the same rows: consumer 0 forms S and p, consumer 1
// dP and m; each sums half of dQ^T (its 32 queries). Also writes Dv and 1/l of the rows to dvec and linv_out.
template <int D>
__global__ void __launch_bounds__(Pair<D>::Team::kThreads, 1)
    flash_bwd_f32_dq_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ o,
                                 const float* __restrict__ d_o, const float* __restrict__ l, float* __restrict__ dq,
                                 float* __restrict__ dvec, float* __restrict__ linv_out, int n, float scale,
                                 float scale_log2) {
  using P = Pair<D>;
  using L = typename P::Dq;
  using Rows = typename P::Rows;
  using Sq = typename P::Sq;
  using Team = typename P::Team;
  constexpr int kTile = P::kTile, kH = P::kH, kHalf = kRows / 2;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm(smem_raw);
  float4* const own_q = reinterpret_cast<float4*>(sm.ptr);
  float4* const own_do = reinterpret_cast<float4*>(sm.ptr + P::kOwnBytes);
  const uint32_t kh = sm.addr + L::kA, kl = kh + Rows::kBytes, vh = sm.addr + L::kB, vl = vh + Rows::kBytes;
  const uint32_t mh = sm.addr + L::kM, ml = mh + Sq::kBytes;
  float4* const xp = reinterpret_cast<float4*>(sm.ptr + L::kP);  // [4][consumer thread]
  float* const dv_s = sm.floats(L::kVec);                        // Dv of the own rows
  float* const linv_s = dv_s + kRows;                            // and their 1/l

  const size_t head = (size_t)blockIdx.y * n * D, rows = (size_t)blockIdx.y * n;
  const int row0 = blockIdx.x * kRows, tiles = n / kTile;
  if (Team::producer()) {
    Team::producer_regs();
    const int ptid = threadIdx.x - 256;
    fill_own_raw<D>(q + head + (size_t)row0 * D, own_q, scale_log2, ptid);
    fill_own_raw<D>(d_o + head + (size_t)row0 * D, own_do, 1.f, ptid);
    {  // Dv and 1/l of the own rows: two threads a row, each over half of it, joined by one shuffle
      const int r = ptid / 2, half = ptid % 2;
      const size_t at = head + (size_t)(row0 + r) * D + half * (D / 2);
      const float4* a = reinterpret_cast<const float4*>(d_o + at);
      const float4* b = reinterpret_cast<const float4*>(o + at);
      float acc = 0.f;
#pragma unroll 8
      for (int i = 0; i < D / 8; ++i) {
        const float4 x = __ldg(a + i), y = __ldg(b + i);
        acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        dv_s[r] = acc;
        dvec[rows + row0 + r] = acc;
      } else {
        const float li = 1.f / l[rows + row0 + r];
        linv_s[r] = li;
        linv_out[rows + row0 + r] = li;
      }
    }
    for (int t = 0; t < tiles; ++t) {
      const size_t at = head + (size_t)t * kTile * D;
      {  // V for consumer 1's dP; it lets go of them early
        Fill<kTile, D, false> vx;
        vx.load(v + at, ptid);
        if (t > 0) bar_sync<256>(kEmptyB);
        vx.store(vh, vl, 1.f, ptid);
        wcflash::fence_async_proxy();
        bar_arrive<256>(kFullB);
      }
      Fill<kTile, D, false> kx;  // K for consumer 0's S and both consumers' dQ^T
      kx.load(k + at, ptid);
      if (t > 0) Team::sync(kEmptyA);
      kx.store(kh, kl, 1.f, ptid);
      wcflash::fence_async_proxy();
      bar_arrive<256>(kFullA);
    }
    return;
  }

  // Both consumers hold the block's 64 rows as the score accumulators lay them (warp w rows 16w .. 16w + 15; this
  // thread rows g and g + 8, tile columns 8j + 2t and 8j + 2t + 1), so a value passes between the two threads of one
  // tid. Consumer c sums dQ^T for queries 32c .. 32c + 31 (rows d, columns those queries).
  Team::consumer_regs();
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const unsigned char* const kh_p = sm.ptr + L::kA;
  const unsigned char* const kl_p = kh_p + Rows::kBytes;
  float tot[kH][kHalf / 2] = {};
  if (c == 0) {
    for (int t = 0; t < tiles; ++t) {
      bar_sync<256>(kFullA);
      float s[kTile / 2];  // S, exp2 domain
      scores_own<D, kTile>(s, own_q, tid, kh, kl);
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {  // p, its sign the clamp's: negative where |s| > 60 (p > 0)
        bool inside;
        const float p = clamped_exp2(s[i], inside);
        s[i] = inside ? p : -p;
      }
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) xp[128 * j + tid] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      bar_arrive<256>(kPFull);
      bar_sync<256>(kMFull);
      accumulate_tn<D, kTile, kHalf>(tot, kh_p, kl_p, mh, ml, 0, tid);
      if (t + 1 < tiles) Team::arrive(kEmptyA);
    }
  } else {
    float dv_r[2];
    for (int t = 0; t < tiles; ++t) {
      bar_sync<256>(kFullB);
      if (t == 0) {
        dv_r[0] = dv_s[tid / 32 * 16 + tid % 32 / 4];
        dv_r[1] = dv_s[tid / 32 * 16 + tid % 32 / 4 + 8];
      }
      float s[kTile / 2];  // dP = dO V^T
      scores_own<D, kTile>(s, own_do, tid, vh, vl);
      if (t + 1 < tiles) bar_arrive<256>(kEmptyB);
      bar_sync<256>(kPFull);
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {  // m = p (dP - Dv), zeroed where |s| > 60, into the m planes
        const float4 x = xp[128 * j + tid];
        const float pv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float m = pv[e] > 0.f ? pv[e] * (s[i] - dv_r[e >> 1]) : 0.f;
          uint32_t hi, lo;
          wctf32::split(m, hi, lo);
          const uint32_t at = sq_at<Sq>(tid, i);
          wctf32::st_shared(mh + at, hi);
          wctf32::st_shared(ml + at, lo);
        }
      }
      wcflash::fence_async_proxy();
      bar_sync<256>(kMFull);
      accumulate_tn<D, kTile, kHalf>(tot, kh_p, kl_p, mh, ml, kHalf, tid);
      if (t + 1 < tiles) Team::arrive(kEmptyA);
    }
  }

  // dQ = dQ^T's transpose * scale / l: value 4j + e of block h is d = 64h + 16w + g + 8 (e >> 1), query 32c + 8j + 2t
  // + (e & 1)
  const int w = tid / 32, g = tid % 32 / 4, t4 = tid % 4;
#pragma unroll
  for (int j = 0; j < kHalf / 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int qr = c * kHalf + 8 * j + 2 * t4 + e1;
      const float mul = scale * linv_s[qr];
      float* out = dq + head + (size_t)(row0 + qr) * D + 16 * w + g;
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        out[64 * h] = tot[h][4 * j + e1] * mul;
        out[64 * h + 8] = tot[h][4 * j + 2 + e1] * mul;
      }
    }
}

// Pass 2: dK and dV for a block's 64 keys, by two consumers on the same keys: consumer 0 forms S^T and p^T / l and
// sums dV^T, consumer 1 forms dP^T and m^T scale / l and sums dK^T; the query tiles' 1/l and Dv from pass 1.
template <int D>
__global__ void __launch_bounds__(Pair<D>::Team::kThreads, 1)
    flash_bwd_f32_dkv_pair_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ d_o,
                                  const float* __restrict__ linv, const float* __restrict__ dvec,
                                  float* __restrict__ dk, float* __restrict__ dv, int n, float scale,
                                  float scale_log2) {
  using P = Pair<D>;
  using L = typename P::Dkv;
  using Rows = typename P::Rows;
  using Sq = typename P::Sq;
  using Team = typename P::Team;
  constexpr int kTile = P::kTile, kH = P::kH;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm(smem_raw);
  float4* const own_k = reinterpret_cast<float4*>(sm.ptr);
  float4* const own_v = reinterpret_cast<float4*>(sm.ptr + P::kOwnBytes);
  const uint32_t qh = sm.addr + L::kA, ql = qh + Rows::kBytes, doh = sm.addr + L::kB, dol = doh + Rows::kBytes;
  const uint32_t ph = sm.addr + L::kP, pl = ph + Sq::kBytes, mh = sm.addr + L::kM, ml = mh + Sq::kBytes;
  uint32_t* const mask = reinterpret_cast<uint32_t*>(sm.ptr + L::kMask);  // [consumer thread]
  float* const linv_t = sm.floats(L::kVec);                                // the tile's 1/l
  float* const dv_t = linv_t + kTile;                                      // and Dv

  const size_t head = (size_t)blockIdx.y * n * D, rows = (size_t)blockIdx.y * n;
  const int key0 = blockIdx.x * kRows, tiles = n / kTile;
  if (Team::producer()) {
    Team::producer_regs();
    const int ptid = threadIdx.x - 256;
    fill_own_raw<D>(k + head + (size_t)key0 * D, own_k, scale_log2, ptid);
    fill_own_raw<D>(v + head + (size_t)key0 * D, own_v, 1.f, ptid);
    for (int t = 0; t < tiles; ++t) {
      const size_t at = head + (size_t)t * kTile * D;
      {  // dO for consumer 1's dP^T and consumer 0's dV^T
        Fill<kTile, D, false> dox;
        dox.load(d_o + at, ptid);
        if (t > 0) Team::sync(kEmptyB);
        dox.store(doh, dol, 1.f, ptid);
        wcflash::fence_async_proxy();
        Team::arrive(kFullB);
      }
      Fill<kTile, D, false> qx;  // Q for consumer 0's S^T and consumer 1's dK^T, with the tile's 1/l and Dv
      qx.load(q + at, ptid);
      float li = 0.f, dvv = 0.f;
      if (ptid < kTile) {
        li = linv[rows + (size_t)t * kTile + ptid];
        dvv = dvec[rows + (size_t)t * kTile + ptid];
      }
      if (t > 0) Team::sync(kEmptyA);
      qx.store(qh, ql, 1.f, ptid);
      if (ptid < kTile) {
        linv_t[ptid] = li;
        dv_t[ptid] = dvv;
      }
      wcflash::fence_async_proxy();
      bar_arrive<256>(kFullA);
    }
    return;
  }

  // Both consumers hold S^T's layout (warp w keys 16w .. 16w + 15; this thread keys g and g + 8, the tile's queries
  // 8j + 2t and 8j + 2t + 1). Consumer 1 sees group A (Q, 1/l, Dv) through consumer 0, which passed its FULL
  // barrier before arriving at kPFull.
  Team::consumer_regs();
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  float tot[kH][kRows / 2] = {};  // dV^T (consumer 0) or dK^T (consumer 1): rows d, the block's keys
  if (c == 0) {
    const unsigned char* const doh_p = sm.ptr + L::kB;
    for (int t = 0; t < tiles; ++t) {
      Team::sync(kFullB);
      bar_sync<256>(kFullA);
      float s[kTile / 2];  // S^T = K Q^T, exp2 domain
      scores_own<D, kTile>(s, own_k, tid, qh, ql);
      uint32_t inside_bits = 0;
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {  // p^T / l into the p planes, the clamp's mask beside
        bool inside;
        const float p = clamped_exp2(s[i], inside) * linv_t[8 * (i / 4) + 2 * (tid % 4) + (i & 1)];
        inside_bits |= (uint32_t)inside << i;
        uint32_t hi, lo;
        wctf32::split(p, hi, lo);
        const uint32_t at = sq_at<Sq>(tid, i);
        wctf32::st_shared(ph + at, hi);
        wctf32::st_shared(pl + at, lo);
      }
      mask[tid] = inside_bits;
      wcflash::fence_async_proxy();
      bar_sync<128>(kStored0);
      bar_arrive<256>(kPFull);
      if (t + 1 < tiles) Team::arrive(kEmptyA);
      accumulate_tn<D, kTile, kRows>(tot, doh_p, doh_p + Rows::kBytes, ph, pl, 0, tid);  // dV^T += dO^T (p^T / l)
      if (t + 1 < tiles) Team::arrive(kEmptyB);
    }
  } else {
    const unsigned char* const qh_p = sm.ptr + L::kA;
    const unsigned char* const ph_p = sm.ptr + L::kP;
    for (int t = 0; t < tiles; ++t) {
      Team::sync(kFullB);
      float s[kTile / 2];  // dP^T = V dO^T
      scores_own<D, kTile>(s, own_v, tid, doh, dol);
      if (t + 1 < tiles) Team::arrive(kEmptyB);
      bar_sync<256>(kPFull);
      const uint32_t inside_bits = mask[tid];
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {  // m^T scale / l = (p^T / l) (dP^T - Dv) scale, zeroed where |s| > 60
        const uint32_t at = sq_at<Sq>(tid, i);
        const float pv = *reinterpret_cast<const float*>(ph_p + at) + *reinterpret_cast<const float*>(ph_p + Sq::kBytes + at);
        const float m = (inside_bits >> i & 1u) ? pv * (s[i] - dv_t[8 * (i / 4) + 2 * (tid % 4) + (i & 1)]) * scale : 0.f;
        uint32_t hi, lo;
        wctf32::split(m, hi, lo);
        wctf32::st_shared(mh + at, hi);
        wctf32::st_shared(ml + at, lo);
      }
      wcflash::fence_async_proxy();
      bar_sync<128>(kStored1);
      accumulate_tn<D, kTile, kRows>(tot, qh_p, qh_p + Rows::kBytes, mh, ml, 0, tid);  // dK^T += Q^T (m^T scale / l)
      if (t + 1 < tiles) Team::arrive(kEmptyA);
    }
  }

  // value 4j + e of block h is d = 64h + 16w + g + 8 (e >> 1), key 8j + 2t + (e & 1)
  const int w = tid / 32, g = tid % 32 / 4, t4 = tid % 4;
  float* const grad = c == 0 ? dv : dk;
#pragma unroll
  for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      float* out = grad + head + (size_t)(key0 + 8 * j + 2 * t4 + e1) * D + 16 * w + g;
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        out[64 * h] = tot[h][4 * j + e1];
        out[64 * h + 8] = tot[h][4 * j + 2 + e1];
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
                       const float* dvec, float* dk, float* dv, int bh, int n, float scale, cudaStream_t stream) {
  using L = typename Wg<D>::template Dkv<kOut>;
  constexpr int smem = L::kBytes + 1024, kC = L::kC;
  static_assert(smem <= 232448, "a block's shared memory");
  return launch_smem(flash_bwd_f32_dkv_wgmma_kernel<D, kOut>, smem, L::Team::kThreads,
                     dim3((n / kRows + kC - 1) / kC, bh), stream, q, k, v, d_o, linv, dvec, dk, dv, n, scale,
                     scale * kLog2e);
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o, const float* d_o,
                       const float* l, float* dq, float* dk, float* dv, float* scratch, int bh, int n, float scale,
                       cudaStream_t stream) {
  float* dvec = scratch;                   // Dv, pass 1 -> pass 2
  float* linv = scratch + (size_t)bh * n;  // 1 / l, pass 1 -> pass 2
  cudaError_t err;
  if constexpr (D == 192) {  // the pair passes, a block of 64 rows each
    using P = Pair<D>;
    constexpr int dq_smem = P::Dq::kBytes + 1024, dkv_smem = P::Dkv::kBytes + 1024;
    static_assert(dq_smem <= 232448 && dkv_smem <= 232448, "a block's shared memory");
    const dim3 grid(n / kRows, bh);
    err = launch_smem(flash_bwd_f32_dq_pair_kernel<D>, dq_smem, P::Team::kThreads, grid, stream, q, k, v, o, d_o, l,
                      dq, dvec, linv, n, scale, scale * kLog2e);
    if (err != cudaSuccess) return err;
    return launch_smem(flash_bwd_f32_dkv_pair_kernel<D>, dkv_smem, P::Team::kThreads, grid, stream, q, k, v, d_o,
                       linv, dvec, dk, dv, n, scale, scale * kLog2e);
  } else {
    constexpr int smem = Wg<D>::Dq::kBytes + 1024, kC = Wg<D>::kDqC;
    static_assert(smem <= 232448, "a block's shared memory");
    err = launch_smem(flash_bwd_f32_dq_wgmma_kernel<D>, smem, Wg<D>::DqTeam::kThreads,
                      dim3((n / kRows + kC - 1) / kC, bh), stream, q, k, v, o, d_o, l, dq, dvec, linv, n, scale,
                      scale * kLog2e);
    if (err != cudaSuccess) return err;
    if constexpr (D == 128) {  // pass 2 as a dV and a dK launch (see the note at the top)
      err = launch_dkv<D, 1>(q, k, v, d_o, linv, dvec, dk, dv, bh, n, scale, stream);
      if (err != cudaSuccess) return err;
      return launch_dkv<D, 2>(q, k, v, d_o, linv, dvec, dk, dv, bh, n, scale, stream);
    } else {
      return launch_dkv<D, 3>(q, k, v, d_o, linv, dvec, dk, dv, bh, n, scale, stream);
    }
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
// and 1/l, written by pass 1 and read by pass 2. d in (16, 32, 64, 128, 192).
// n a multiple of 64: every pass's blocks own 64 rows (a consumer's, or at d =
// 192 both consumers' of a block) and walk tiles of 64 or 32 rows. bh at most
// 65535, the grid's second dimension; a block pairs no heads, so any bh runs.
// Two launches (three at d = 128). Returns the cudaError_t of the launches.
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
