// K1-f32 and K2-f32: the clamped-softmax flash-attention forward with f32 V
// and O, for sm_90a, P V on the tensor cores in 3xTF32, at every head dim of
// the repo's models: 16 and 24 (the legacy UNet) and 32, 64, 128 and 192 (the
// UNet: its default ladder attends at flash length at D = 64, 128, 32 and
// 16, the 256 px ladder also at 192). The two differ in their score product
// alone, a policy of the two kernels below: K1-f32 forms S = Q K^T * D^-1/2
// in 3xTF32 from f32 Q and K (`F32Narrow`, `F32Wide`), K2-f32 from int8 Q8
// and K8 (`I8Scores`, after the note on K2-f32 further down).
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel` (:78, via
// `_flash_attention_fwd_impl`) and `_flash_kernel_stream_fwd` (:456, which
// also returns l) where JAX runs them on f32 tiles: the legacy UNet
// (weatherconverter_tpu/models/unet_legacy.py:151) and the UNet its DDPM loop
// trains in f32 (weatherconverter_tpu/training/loop_diffusion.py:114-119):
//   O = (exp(clip(Q K^T * D^-1/2, -60, 60)) V) / l,   l = row sum of the exponentials,
// every sum in f32, as K1's plain version computes it in f32. The bf16 K1
// (flash_fwd.cu) serves bf16 models. The backward of this forward is K3-f32
// (flash_bwd_f32.cu), which takes l.
//
// What bounds it on the H100: per head N^2 exponentials (3.86e12/s) and
// 4*N^2*D products, each formed as three TF32 products (flash_tf32.cuh) at
// 494.7 TFLOP/s in place of one f32 FMA at 67 (the first design, one thread
// a query row on the CUDA cores, ran at 34-36 % of that FMA bound: its
// serial chain of D dependent FMAs a score, and ~250 threads an SM, could
// not hide latency).
//
// Two designs, one a head-dim range. The wide kernel also compiles and
// passes at D = 16 and 24 (108 and 179 registers, no spill), but at B*H = 32
// it took 0.7823 / 0.0577 / 0.0760 ms at (N, D) = (4096, 16) / (1024, 16) /
// (1024, 24) where the narrow kernel took 0.7364 / 0.0548 / 0.0760 in the
// same runs (probes/time_flash.py, H100 80GB HBM3 at 700 W; PERF.md
// section 6): 5-6 % slower at D = 16, where the narrow kernel splits each
// tile once for the block and not in every warp.
// Both: a block is 4 warps, each owning 16 query rows, and walks the keys in
// tiles staged by cp.async, double buffered (tile t+1 is in flight while
// tile t is used), into rows padded to D + 4 floats, so every fragment load
// is free of bank conflicts. No running max: as in K1, O and l add up
// unscaled. P's fragment comes straight from S's accumulators
// (flash_tf32.cuh).
//
// The narrow kernel (D = 16, 24): 64-key tiles. Once a tile has landed, the
// block splits it once: hi over the staged value in place, lo into a second
// buffer. Each warp keeps its Q fragments, scaled by D^-1/2 * log2(e) and
// split, in registers for the whole walk. Per tile a warp forms S = Q K^T
// (16 x 64: eight n-tiles of mma.sync.m16n8k8.tf32, D/8 k-steps each, three
// products a step), takes p = exp2(clamp(S)) in registers, splits p there,
// and adds P V (eight k-steps, D/8 n-tiles) into two sets of accumulators
// (even and odd key steps, two independent chains an n-tile), which join
// the running sum by FADD at the end of the tile. That last step is for
// precision: the tensor cores' f32 accumulation does not round to nearest,
// and one chain of MMAs over all N keys left O 3-7e-6 of max|O| from the
// plain version (f32) at N = 1024, where a tile's chain of eight k-steps
// leaves 1-2e-6 (ablations timed once on the H100, PERF.md section 6; fresh
// accumulators for each k-step of S left the error as it was and cost
// 2-13 %). __launch_bounds__ asks for 4 blocks an SM (at most 128
// registers): the legacy UNet's batch 8 makes 512 blocks, one wave of 528;
// ptxas's own choice at D = 24, 133 registers and 3 blocks, took 30 % longer.
//
// The wide kernel (D = 32-192). Carried over, that design would not fit: Q's
// split fragments (D registers a thread) beside the two O chains (another D)
// and S (32) pass the 255 registers a thread may have from D = 128 on, and
// two staged (K, V) tile sets plus a lo buffer, 64 keys x (D + 4) floats
// each, take 203 KB at D = 128 and 301 KB at 192 of a block's 227. So:
//   * Q stays in shared memory (64 rows x (D + 4), raw f32) and each A
//     fragment is scaled and split as it is loaded, once a k-step for all of
//     a tile's key n-tiles; the K and V fragments are split as they are
//     loaded too, so no lo buffer is staged (each warp splits the tile
//     anew: 5 operations an element, about as many instructions as the
//     MMAs it feeds);
//   * tiles of 64 keys at D <= 64 and 32 at D >= 128; shared memory 46, 87,
//     101 and 150 KB at D = 32, 64, 128, 192;
//   * O's n-tiles are formed one at a time: all of a tile's P fragments
//     (split, one register a key) stay in registers, and each n-tile's sum
//     over the tile runs in chains of four k-steps joined to the running O
//     by FADD, as the narrow kernel's two chains do; S's sum over D runs in
//     chains of four k-steps joined by FADD as well (24 k-steps at D = 192);
//   * __launch_bounds__ asks for 2 blocks an SM (at most 255 registers):
//     running O (D/2 registers) and P (one a key) dominate.
//
// K2-f32 replaces weatherconverter_tpu/ops/attention.py `_flash_kernel_qk_i8`
// (:125, via `_flash_attention_fwd_i8_impl` :167, pv_int8=False) where JAX
// runs it on an f32 V: every inference command of the JAX CLI builds its
// UNet in f32 and takes the int8 kernel on its accelerator (sample,
// translate, serve, export-hlo --attn int8, the legacy sampler):
//   s = int32(Q8 K8^T) * qk_scale;  O = (exp(clip(s, -60, 60)) V) / l,
// Q8, K8 and qk_scale = qs * ks * D^-1/2 from the quantizer (quantize_i8.cu),
// one scale a tensor or one a batch row (head bh reads
// qk_scale[bh / heads_per_scale] from the device: nothing synchronises).
// The bf16 K2 (flash_fwd_qk_i8.cu) forms P V in bf16 wgmma, whose one f32
// operand type, tf32, would keep 10 bits of P and V: one TF32 pass misses
// the f32 plain version by 5e-4-2e-3 of max |O| (K3-f32's planted fault in
// chip_smoke.py phase 2), where this kernel's 3xTF32 P V keeps 1-3e-6. So
// the score product is the only change from K1-f32:
//   * S from m16n8k32 s8 x s8 -> s32 mma.sync: Q8 and K8 are K-major as they
//     lie, so nothing is transposed. Each warp holds its 16 rows of Q8 as A
//     fragments in registers for the whole walk (D/8 registers a thread);
//     K8 tiles are staged by cp.async (16-byte pieces, 8-byte at D = 24)
//     into rows padded to a stride of 4 (mod 8) words, so every B fragment
//     load is free of bank conflicts. At D = 16 the k32 step has a zero
//     half, at D = 24 a zero fourth 8-byte piece: Q8's A fragment is zero
//     there (in registers), so whatever the padding of K8 holds adds 0.
//   * The s32 accumulators have the f32 m16n8 layout, so a score goes, as in
//     K1-f32, through p = exp2(clamp) straight into the split A fragments of
//     P V. The score is converted exactly: |s| <= 127 * 127 * 192 < 2^22,
//     so int_as_float(s + 0x4B400000) - 1.5 * 2^23 = s (an integer add and
//     a subtraction), then scaled by one multiply. K2's magic-bias FMA, which
//     folds the subtraction into the scaling, rounds its constant: every
//     score moves alike, a common factor of p and l that cancels in O, but
//     not where the clamp fires, and at the clamp rails it missed the f32
//     plain version by 7e-4-1.4e-3 of max |O| (tests/test_torch_kernels.py).
//     cvt.rn.f32.s32 and a multiply, as exact, spilled 4 bytes at D = 24,
//     where the narrow kernel holds 128 registers for its 4 blocks an SM (as
//     did this exact form, so K2-f32 takes the wide kernel there);
//     timed once against the FMA on an H100 (700 W, the forward alone, B*H =
//     32, probes/time_flash.py beside a copy of this file) it took
//     0.984-1.003x the FMA's time at the seven shapes of chip_smoke.py's
//     phase 2.
// What bounds it: the int8 products are 1/12 of the 3xTF32 ones (2 N^2 D a
// head at 1,979 TOP/s against 3 x 2 N^2 D at 494.7 TFLOP/s), so the bound is
// about half K1-f32's: at (4096, 64), B*H = 32, 0.035 + 0.417 ms of tensor
// work against 0.139 ms of exponentials. Both kernels keep their K1-f32
// tiling: the narrow kernel (K2-f32 at D = 16) splits each staged V tile
// once for the block, the wide kernel (D = 24-192) splits V as it loads it
// and needs no Q staging (Q8 lives in registers).
// Measured on an H100 (700 W, B*H = 32, chip_smoke.py phase 2; PERF.md
// section 6), K2-f32 whole (its quantizer included) is 1.0-2.0x faster than
// K1-f32 at the UNet's four shapes and (1024, 192), at 18-26 % of its bound
// (equal to K1-f32 at (4096, 16), where the exponentials and the split bind).
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_tf32.cuh"

namespace wcflash32 {

using wcflash::cp_async16;
using wcflash::cp_async8_zfill;
using wcflash::cp_async_commit;
using wcflash::cp_async_wait;
using wcflash::kClampLog2;
using wcflash::kLog2e;
using wcflash::ld32;
using wcflash::mma_s8;
using wcflash::smem_u32;
using wctf32::c_to_a;
using wctf32::ex2;
using wctf32::mma_3xtf32;
using wctf32::split;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block

// The score products. Each is made in the kernel by Policy(k, scale_log2,
// qk_scale, heads_per_scale, bh, n) from the kernel's arguments (head bh;
// scale_log2 the f32 products', qk_scale and heads_per_scale the int8
// ones'), takes its share of Q with load_q(q, bh, n, row0, warp, g, t, smem,
// tid) (the block's first query row row0; smem the wide kernel's Q region),
// stages a K tile of `rows` keys from key0 into shared memory with stage_k
// (the caller commits; the narrow kernel copies f32 K itself, beside V), and
// forms S, in the exp2 domain, for this warp's 16 rows against kNt * 8
// staged keys with scores<kNt> (klo: the narrow kernel's lo parts of the
// tile, where kSplitK). T is the element type of Q and K.

// K1-f32 narrow: Q's A fragments, times D^-1/2 log2(e), split once into registers; the staged K tile split once
// for the block (kSplitK) into hi in place and lo.
template <int D>
struct F32Narrow {
  using T = float;
  static constexpr bool kSplitK = true;
  static constexpr int kSteps = D / 8;  // k-steps of Q K^T
  static constexpr int kStride = D + 4;
  float scale_log2;
  uint32_t qh[kSteps][4], ql[kSteps][4];

  __device__ __forceinline__ F32Narrow(const float*, float scale_log2_, const float*, int, int, int)
      : scale_log2(scale_log2_) {}
  __device__ __forceinline__ void load_q(const float* __restrict__ q, int bh, int n, int row0, int warp, int g,
                                         int t, float*, int) {
    const float* qr = q + (size_t)bh * n * D + (size_t)(row0 + warp * 16) * D;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float x[4] = {qr[g * D + 8 * s + t], qr[(g + 8) * D + 8 * s + t], qr[g * D + 8 * s + t + 4],
                          qr[(g + 8) * D + 8 * s + t + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e] * scale_log2, qh[s][e], ql[s][e]);
    }
  }
  template <int kNt>
  __device__ __forceinline__ void scores(float (&sc)[kNt][4], const float* khi, const float* klo, int g,
                                         int t) const {
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int at = (8 * j + g) * kStride + 8 * s + t;
        mma_3xtf32(sc[j], qh[s], ql[s], __float_as_uint(khi[at]), __float_as_uint(khi[at + 4]),
                   __float_as_uint(klo[at]), __float_as_uint(klo[at + 4]));
      }
    }
  }
};

// K1-f32 wide: Q's 64 rows staged raw in shared memory (the copies join the first tile's group), each A
// fragment scaled and split as it is loaded, as are K's B fragments (wctf32::product_nt).
template <int D>
struct F32Wide {
  using T = float;
  static constexpr int kStride = D + 4;
  static constexpr int kQFloats = kRows * kStride;
  template <int kTileKeys>
  static constexpr int tile_floats() { return kTileKeys * kStride; }
  const float* qw;  // this warp's 16 rows
  const float* k_head;
  float scale_log2;

  __device__ __forceinline__ F32Wide(const float* k, float scale_log2_, const float*, int, int bh, int n)
      : qw(nullptr), k_head(k + (size_t)bh * n * D), scale_log2(scale_log2_) {}
  __device__ __forceinline__ void load_q(const float* __restrict__ q, int bh, int n, int row0, int warp, int, int,
                                         float* smem, int tid) {
    qw = smem + warp * 16 * kStride;
    wctf32::stage_rows<D>(smem, q + (size_t)bh * n * D + (size_t)row0 * D, kRows, kStride, tid, kThreads);
  }
  __device__ __forceinline__ void stage_k(float* dst, int key0, int rows, int tid) const {
    wctf32::stage_rows<D>(dst, k_head + (size_t)key0 * D, rows, kStride, tid, kThreads);
  }
  template <int kNt>
  __device__ __forceinline__ void scores(float (&sc)[kNt][4], const float* ks, const float*, int g, int t) const {
    wctf32::product_nt<D, kNt>(sc, qw, scale_log2, ks, kStride, g, t);
  }
};

// K2-f32, in both kernels: S = int32(Q8 K8^T) * qk_scale on m16n8k32 s8 mma.sync (see the note above).
template <int D>
struct I8Scores {
  using T = int8_t;
  static constexpr bool kSplitK = false;
  static constexpr int kQFloats = 0;
  static constexpr int kSteps = (D + 31) / 32;  // k32 steps; D = 16 and 24 take one with a zero tail
  // words a staged K8 row: at least D / 4, and 4 (mod 8), so the 8 rows g of a B fragment fall in distinct banks
  static constexpr int kRowWords = (D / 4 + 3) / 8 * 8 + 4;
  static constexpr int kPiece = D % 16 == 0 ? 16 : 8;  // cp.async bytes
  template <int kTileKeys>
  static constexpr int tile_floats() { return kTileKeys * kRowWords; }
  const int8_t* k_head;
  float scale_log2;  // qk_scale * log2 e
  uint32_t qa[kSteps][4];

  __device__ __forceinline__ I8Scores(const int8_t* k8, float, const float* qk_scale, int heads_per_scale, int bh,
                                      int n)
      : k_head(k8 + (size_t)bh * n * D), scale_log2(qk_scale[bh / heads_per_scale] * kLog2e) {}
  __device__ __forceinline__ void load_q(const int8_t* __restrict__ q8, int bh, int n, int row0, int warp, int g,
                                         int t, float*, int) {
    const int8_t* qr = q8 + ((size_t)bh * n + row0 + warp * 16) * D;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c0 = 32 * s + 4 * t, c1 = c0 + 16;  // a0/a1 and a2/a3 columns; c0 < D always
      qa[s][0] = ld32(qr + g * D + c0);
      qa[s][1] = ld32(qr + (g + 8) * D + c0);
      qa[s][2] = c1 < D ? ld32(qr + g * D + c1) : 0u;
      qa[s][3] = c1 < D ? ld32(qr + (g + 8) * D + c1) : 0u;
    }
  }
  __device__ __forceinline__ void stage_k(float* dst, int key0, int rows, int tid) const {
    constexpr int kPieces = D / kPiece;  // a row's
    const int8_t* src = k_head + (size_t)key0 * D;
    for (int i = tid; i < rows * kPieces; i += kThreads) {
      const uint32_t at = smem_u32(dst + i / kPieces * kRowWords + i % kPieces * (kPiece / 4));
      if constexpr (kPiece == 16)
        cp_async16(at, src + 16 * i);
      else
        cp_async8_zfill(at, src + 8 * i, true);
    }
  }
  template <int kNt>
  __device__ __forceinline__ void scores(float (&sc)[kNt][4], const float* ktile, const float*, int g,
                                         int t) const {
    const uint32_t* kw = reinterpret_cast<const uint32_t*>(ktile);
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const uint32_t* r = kw + (8 * j + g) * kRowWords + 8 * s + t;
        // b1 (bytes 16 + 4t of the step): past the row at D = 16; at D = 24 padding for t >= 2, where Q8's a2/a3 are 0
        const uint32_t b[2] = {r[0], 32 * s + 16 < D ? r[4] : 0u};
        mma_s8(c, qa[s], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = (__int_as_float(c[e] + 0x4B400000) - 12582912.f) * scale_log2;
    }
  }
};

// The narrow kernel (D = 16, 24), see above: 64-key tiles, each staged V tile (and an f32 K tile) split once for
// the block, P V in two chains a tile joined by FADD. scale_log2 is K1-f32's, qk_scale and heads_per_scale
// K2-f32's.
template <int D, class Score>
__global__ void __launch_bounds__(kThreads, 4)
    flash_fwd_f32_kernel(const typename Score::T* __restrict__ q, const typename Score::T* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, float* __restrict__ l_out, int n,
                         float scale_log2, const float* __restrict__ qk_scale, int heads_per_scale) {
  static_assert(D % 8 == 0, "whole k-steps of 8");
  constexpr int kKeys = 64;                     // keys a shared-memory tile
  constexpr int kStride = D + 4;                // floats a staged row: conflict-free fragment loads
  constexpr int kTile = kKeys * kStride;        // floats a staged tile
  constexpr int kRowChunks = D / 4;             // 16-byte chunks a row
  constexpr int kChunks = kKeys * kRowChunks;   // of K, and of V, a tile
  constexpr int kSteps = D / 8;                 // n-tiles of P V
  // [buffer][K, V]: the staged tile (an f32 one overwritten in place by its hi parts; K8 bytes in K's place for
  // K2-f32); lo[K, V]: the current tile's lo parts
  __shared__ __align__(16) float hi[2][2][kTile];
  __shared__ __align__(16) float lo[2][kTile];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int r0 = blockIdx.x * kRows + warp * 16;
  const typename Score::T* kg = k + head;
  const float* vg = v + head;
  Score score(k, scale_log2, qk_scale, heads_per_scale, blockIdx.y, n);

  auto stage = [&](int tile, int buf) {
    const float* vs = vg + (size_t)tile * kKeys * D;
    if constexpr (Score::kSplitK) {  // f32 K: rows as V's, one copy loop for both
      const float* ks = kg + (size_t)tile * kKeys * D;
      for (int i = threadIdx.x; i < kChunks; i += kThreads) {
        const int at = i / kRowChunks * kStride + i % kRowChunks * 4;
        cp_async16(smem_u32(&hi[buf][0][at]), ks + 4 * i);
        cp_async16(smem_u32(&hi[buf][1][at]), vs + 4 * i);
      }
    } else {
      score.stage_k(hi[buf][0], tile * kKeys, kKeys, threadIdx.x);
      wctf32::stage_rows<D>(hi[buf][1], vs, kKeys, kStride, threadIdx.x, kThreads);
    }
    cp_async_commit();
  };
  stage(0, 0);
  score.load_q(q, blockIdx.y, n, blockIdx.x * kRows, warp, g, t, nullptr, threadIdx.x);

  float tot[kSteps][4] = {};  // O's n-tiles, summed over the tiles
  float l_g = 0.f, l_g8 = 0.f;  // rows g and g+8: this thread's columns

  const int tiles = n / kKeys;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed for every thread; every warp is done with the previous one
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    for (int i = threadIdx.x; i < kChunks; i += kThreads) {
      const int at = i / kRowChunks * kStride + i % kRowChunks * 4;
#pragma unroll
      for (int m = Score::kSplitK ? 0 : 1; m < 2; ++m) {
        float4* h4 = reinterpret_cast<float4*>(&hi[buf][m][at]);
        const float4 x = *h4;
        uint4 a, b;
        split(x.x, a.x, b.x);
        split(x.y, a.y, b.y);
        split(x.z, a.z, b.z);
        split(x.w, a.w, b.w);
        *reinterpret_cast<uint4*>(h4) = a;
        *reinterpret_cast<uint4*>(&lo[m][at]) = b;
      }
    }
    __syncthreads();
    const float* vhi = hi[buf][1];
    const float* vlo = lo[1];

    float sc[8][4];  // S for the tile's 64 keys: n-tile j holds keys 8j..8j+7
    score.template scores<8>(sc, hi[buf][0], lo[0], g, t);
    float acc[kSteps][2][4] = {};  // this tile's P V: one set for even and one for odd key steps
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ex2(fminf(fmaxf(sc[j][e], -kClampLog2), kClampLog2));
      l_g += p[0] + p[1];
      l_g8 += p[2] + p[3];
      // A fragment columns t, t+4 <- keys 2t, 2t+1 of this step
      uint32_t ph[4], pl[4];
      c_to_a(p, ph, pl);
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int at = (8 * j + 2 * t) * kStride + 8 * s + g;  // V rows 2t and 2t+1 of the step, column g
        mma_3xtf32(acc[s][j & 1], ph, pl, __float_as_uint(vhi[at]), __float_as_uint(vhi[at + kStride]),
                   __float_as_uint(vlo[at]), __float_as_uint(vlo[at + kStride]));
      }
    }
    // the tile's sums join the running sum in f32, rounded to nearest
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[s][e] += acc[s][0][e] + acc[s][1][e];
  }

  // a row's l: the four threads of its group hold its columns
  l_g += __shfl_xor_sync(0xffffffffu, l_g, 1);
  l_g += __shfl_xor_sync(0xffffffffu, l_g, 2);
  l_g8 += __shfl_xor_sync(0xffffffffu, l_g8, 1);
  l_g8 += __shfl_xor_sync(0xffffffffu, l_g8, 2);
  if (l_out != nullptr && t == 0) {
    l_out[(size_t)blockIdx.y * n + r0 + g] = l_g;
    l_out[(size_t)blockIdx.y * n + r0 + g + 8] = l_g8;
  }
  const float inv_g = 1.f / l_g, inv_g8 = 1.f / l_g8;
  float* og = o + head + (size_t)r0 * D;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int col = 8 * s + 2 * t;
    *reinterpret_cast<float2*>(og + g * D + col) = make_float2(tot[s][0] * inv_g, tot[s][1] * inv_g);
    *reinterpret_cast<float2*>(og + (g + 8) * D + col) = make_float2(tot[s][2] * inv_g8, tot[s][3] * inv_g8);
  }
}

// The wide kernel's tile and shared memory at head dim D, with score product Score.
template <int D, class Score>
struct Wide {
  static constexpr int kKeys = D <= 64 ? 64 : 32;  // keys a staged tile
  static constexpr int kStride = D + 4;            // floats a staged V row
  static constexpr int kNt = kKeys / 8;            // S's n-tiles, P V's k-steps, a tile
  static constexpr int kKFloats = Score::template tile_floats<kKeys>();
  static constexpr int kBufFloats = kKFloats + kKeys * kStride;  // a staged (K, V) pair
  // Score's Q region, then [buffer][K, V] tiles
  static constexpr int kSmemBytes = (Score::kQFloats + 2 * kBufFloats) * 4;
};

template <int D, class Score>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32_wide_kernel(const typename Score::T* __restrict__ q, const typename Score::T* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ l_out, int n,
                              float scale_log2, const float* __restrict__ qk_scale, int heads_per_scale) {
  using W = Wide<D, Score>;
  constexpr int kStride = W::kStride, kKeysW = W::kKeys, kNt = W::kNt, kSteps = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* kv = smem + Score::kQFloats;  // [2][K, V]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int r0 = blockIdx.x * kRows + warp * 16;
  const float* vg = v + head;

  Score score(k, scale_log2, qk_scale, heads_per_scale, blockIdx.y, n);
  score.load_q(q, blockIdx.y, n, blockIdx.x * kRows, warp, g, t, smem, threadIdx.x);
  auto stage = [&](int tile, int buf) {
    float* dst = kv + buf * W::kBufFloats;
    score.stage_k(dst, tile * kKeysW, kKeysW, threadIdx.x);
    wctf32::stage_rows<D>(dst + W::kKFloats, vg + (size_t)tile * kKeysW * D, kKeysW, kStride, threadIdx.x,
                          kThreads);
    cp_async_commit();
  };
  stage(0, 0);  // a staged Q's copies join the first tile's group

  const float ones[kNt][2] = {};               // product_nn's row multipliers: unused here
  float tot[kSteps][4] = {};                   // O's n-tiles, summed over the tiles
  float l_g = 0.f, l_g8 = 0.f;                 // rows g and g+8: this thread's columns

  const int tiles = n / kKeysW;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed for every thread; every warp is done with the previous one
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    const float* ks = kv + buf * W::kBufFloats;
    const float* vs = ks + W::kKFloats;

    float sc[kNt][4];  // S (exp2 domain) for the tile's keys: n-tile j holds keys 8j..8j+7
    score.template scores<kNt>(sc, ks, nullptr, g, t);
    uint32_t ph[kNt][4], pl[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = ex2(fminf(fmaxf(sc[j][e], -kClampLog2), kClampLog2));
      l_g += p[0] + p[1];
      l_g8 += p[2] + p[3];
      c_to_a(p, ph[j], pl[j]);
    }
    wctf32::product_nn<D, kNt, false>(tot, ph, pl, vs, kStride, g, t, ones);
  }

  l_g += __shfl_xor_sync(0xffffffffu, l_g, 1);
  l_g += __shfl_xor_sync(0xffffffffu, l_g, 2);
  l_g8 += __shfl_xor_sync(0xffffffffu, l_g8, 1);
  l_g8 += __shfl_xor_sync(0xffffffffu, l_g8, 2);
  if (l_out != nullptr && t == 0) {
    l_out[(size_t)blockIdx.y * n + r0 + g] = l_g;
    l_out[(size_t)blockIdx.y * n + r0 + g + 8] = l_g8;
  }
  const float inv_g = 1.f / l_g, inv_g8 = 1.f / l_g8;
  float* og = o + head + (size_t)r0 * D;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int col = 8 * s + 2 * t;
    *reinterpret_cast<float2*>(og + g * D + col) = make_float2(tot[s][0] * inv_g, tot[s][1] * inv_g);
    *reinterpret_cast<float2*>(og + (g + 8) * D + col) = make_float2(tot[s][2] * inv_g8, tot[s][3] * inv_g8);
  }
}

// One launch at head dim D with score product Score: the narrow kernel if kNarrow, else the wide one.
template <int D, class Score, bool kNarrow>
cudaError_t launch(const typename Score::T* q, const typename Score::T* k, const float* v, float* o, float* l,
                   int bh, int n, float scale_log2, const float* qk_scale, int heads_per_scale, cudaStream_t stream) {
  const dim3 grid(n / kRows, bh);
  if constexpr (kNarrow) {
    flash_fwd_f32_kernel<D, Score>
        <<<grid, kThreads, 0, stream>>>(q, k, v, o, l, n, scale_log2, qk_scale, heads_per_scale);
  } else {
    constexpr int smem = Wide<D, Score>::kSmemBytes;
    static_assert(smem <= 232448, "a block's shared memory");
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_wide_kernel<D, Score>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32_wide_kernel<D, Score>
        <<<grid, kThreads, smem, stream>>>(q, k, v, o, l, n, scale_log2, qk_scale, heads_per_scale);
  }
  return cudaGetLastError();
}

// K1-f32 at head dim D
template <int D>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n,
                       float scale, cudaStream_t stream) {
  using Score = std::conditional_t<(D < 32), F32Narrow<D>, F32Wide<D>>;
  return launch<D, Score, (D < 32)>(q, k, v, o, l, bh, n, scale * kLog2e, nullptr, 1, stream);
}

// K2-f32 at head dim D: the narrow kernel at D = 16 only. At D = 24 it spilled 4 bytes in the narrow kernel's 128
// registers (4 blocks an SM); the wide kernel there ran K1-f32 as fast as the narrow one (the note above).
template <int D>
cudaError_t launch_i8(const int8_t* q8, const int8_t* k8, const float* v, const float* qk_scale, float* o, int bh,
                      int n, int heads_per_scale, cudaStream_t stream) {
  return launch<D, I8Scores<D>, (D == 16)>(q8, k8, v, o, nullptr, bh, n, 0.f, qk_scale, heads_per_scale, stream);
}

// The build (ops/cuda_build.VARIANTS) compiles this file once for each head
// dim with -DWC_FWD_F32_D=<d>, which instantiates that head dim's kernels
// (K1-f32 and K2-f32), and once without, which holds the entry points, so
// that nvcc compiles the six head dims in parallel.
#define WC_F32_LAUNCH(D) \
  cudaError_t launch_f32<D>(const float*, const float*, const float*, float*, float*, int, int, float, cudaStream_t)
#define WC_I8_LAUNCH(D)                                                                                            \
  cudaError_t launch_i8<D>(const int8_t*, const int8_t*, const float*, const float*, float*, int, int, int,       \
                           cudaStream_t)
#ifdef WC_FWD_F32_D
template WC_F32_LAUNCH(WC_FWD_F32_D);
template WC_I8_LAUNCH(WC_FWD_F32_D);
#else
extern template WC_F32_LAUNCH(16);
extern template WC_F32_LAUNCH(24);
extern template WC_F32_LAUNCH(32);
extern template WC_F32_LAUNCH(64);
extern template WC_F32_LAUNCH(128);
extern template WC_F32_LAUNCH(192);
extern template WC_I8_LAUNCH(16);
extern template WC_I8_LAUNCH(24);
extern template WC_I8_LAUNCH(32);
extern template WC_I8_LAUNCH(64);
extern template WC_I8_LAUNCH(128);
extern template WC_I8_LAUNCH(192);
#endif

}  // namespace wcflash32

#ifndef WC_FWD_F32_D
// q, k, v, o: contiguous f32 (bh, n, d), 16-byte aligned; l: f32 (bh, n) or
// null. d in (16, 24, 32, 64, 128, 192), n a multiple of 64 (kRows, and the
// narrow kernel's tile). Returns the
// cudaError_t of the launch.
extern "C" int wc_flash_fwd_f32(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n,
                                int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash32::kRows != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return wcflash32::launch_f32<16>(q, k, v, o, l, bh, n, scale, s);
    case 24: return wcflash32::launch_f32<24>(q, k, v, o, l, bh, n, scale, s);
    case 32: return wcflash32::launch_f32<32>(q, k, v, o, l, bh, n, scale, s);
    case 64: return wcflash32::launch_f32<64>(q, k, v, o, l, bh, n, scale, s);
    case 128: return wcflash32::launch_f32<128>(q, k, v, o, l, bh, n, scale, s);
    case 192: return wcflash32::launch_f32<192>(q, k, v, o, l, bh, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// K2-f32. q8, k8: contiguous int8 (bh, n, d); v, o: contiguous f32 (bh, n,
// d), 16-byte aligned; qk_scale: bh / heads_per_scale f32 on the device (as
// K2's, flash_fwd_qk_i8.cu, whose entry point sends f32 V here). d in (16,
// 24, 32, 64, 128, 192), n a multiple of 64. Returns the cudaError_t of the
// launch.
extern "C" int wc_flash_fwd_qk_i8_f32(const void* q8, const void* k8, const float* v, const float* qk_scale,
                                      float* o, int bh, int n, int d, int heads_per_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash32::kRows != 0 || heads_per_scale <= 0 ||
      bh % heads_per_scale != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(q8);
  const int8_t* k = static_cast<const int8_t*>(k8);
  switch (d) {
    case 16: return wcflash32::launch_i8<16>(q, k, v, qk_scale, o, bh, n, heads_per_scale, s);
    case 24: return wcflash32::launch_i8<24>(q, k, v, qk_scale, o, bh, n, heads_per_scale, s);
    case 32: return wcflash32::launch_i8<32>(q, k, v, qk_scale, o, bh, n, heads_per_scale, s);
    case 64: return wcflash32::launch_i8<64>(q, k, v, qk_scale, o, bh, n, heads_per_scale, s);
    case 128: return wcflash32::launch_i8<128>(q, k, v, qk_scale, o, bh, n, heads_per_scale, s);
    case 192: return wcflash32::launch_i8<192>(q, k, v, qk_scale, o, bh, n, heads_per_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif
