// K1-f32: the clamped-softmax flash-attention forward in float32, for
// sm_90a, on the tensor cores in 3xTF32, at every head dim of the repo's
// models: 16 and 24 (the legacy UNet, which samples in f32) and 32, 64, 128
// and 192 (the UNet trained with training.dtype float32: its default ladder
// attends at flash length at D = 64, 128, 32 and 16, the 256 px ladder also
// at 192).
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
#include <cuda_runtime.h>

#include "flash_tf32.cuh"

namespace wcflash32 {

using wcflash::cp_async16;
using wcflash::cp_async_commit;
using wcflash::cp_async_wait;
using wcflash::kClampLog2;
using wcflash::kLog2e;
using wcflash::smem_u32;
using wctf32::c_to_a;
using wctf32::ex2;
using wctf32::mma_3xtf32;
using wctf32::split;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block
constexpr int kKeys = 64;           // keys a shared-memory tile of the narrow kernel

template <int D>
__global__ void __launch_bounds__(kThreads, 4)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ l_out, int n, float scale_log2) {
  static_assert(D % 8 == 0, "whole k-steps of 8");
  constexpr int kStride = D + 4;                // floats a staged row: conflict-free fragment loads
  constexpr int kTile = kKeys * kStride;        // floats a staged tile
  constexpr int kRowChunks = D / 4;             // 16-byte chunks a row
  constexpr int kChunks = kKeys * kRowChunks;   // of K, and of V, a tile
  constexpr int kSteps = D / 8;                 // k-steps of Q K^T, n-tiles of P V
  // [buffer][K, V]: the staged f32 tile, overwritten in place by its hi parts; lo[K, V]: the current tile's lo parts
  __shared__ __align__(16) float hi[2][2][kTile];
  __shared__ __align__(16) float lo[2][kTile];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int r0 = blockIdx.x * kRows + warp * 16;
  const float* kg = k + head;
  const float* vg = v + head;

  auto stage = [&](int tile, int buf) {
    const float* ks = kg + (size_t)tile * kKeys * D;
    const float* vs = vg + (size_t)tile * kKeys * D;
    for (int i = threadIdx.x; i < kChunks; i += kThreads) {
      const int at = i / kRowChunks * kStride + i % kRowChunks * 4;
      cp_async16(smem_u32(&hi[buf][0][at]), ks + 4 * i);
      cp_async16(smem_u32(&hi[buf][1][at]), vs + 4 * i);
    }
    cp_async_commit();
  };
  stage(0, 0);

  // Q's A fragments, times D^-1/2 log2(e), split once
  uint32_t qh[kSteps][4], ql[kSteps][4];
  {
    const float* qr = q + head + (size_t)r0 * D;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float x[4] = {qr[g * D + 8 * s + t], qr[(g + 8) * D + 8 * s + t], qr[g * D + 8 * s + t + 4],
                          qr[(g + 8) * D + 8 * s + t + 4]};
#pragma unroll
      for (int e = 0; e < 4; ++e) split(x[e] * scale_log2, qh[s][e], ql[s][e]);
    }
  }

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
      for (int m = 0; m < 2; ++m) {
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
    const float* khi = hi[buf][0];
    const float* vhi = hi[buf][1];
    const float* klo = lo[0];
    const float* vlo = lo[1];

    float sc[8][4];  // S for the tile's 64 keys: n-tile j holds keys 8j..8j+7
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int at = (8 * j + g) * kStride + 8 * s + t;
        mma_3xtf32(sc[j], qh[s], ql[s], __float_as_uint(khi[at]), __float_as_uint(khi[at + 4]),
                   __float_as_uint(klo[at]), __float_as_uint(klo[at + 4]));
      }
    }
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
      split(p[0], ph[0], pl[0]);
      split(p[2], ph[1], pl[1]);
      split(p[1], ph[2], pl[2]);
      split(p[3], ph[3], pl[3]);
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

// The wide kernel's tile and shared memory at head dim D.
template <int D>
struct Wide {
  static constexpr int kKeys = D <= 64 ? 64 : 32;  // keys a staged tile
  static constexpr int kStride = D + 4;            // floats a staged row
  static constexpr int kNt = kKeys / 8;            // S's n-tiles, P V's k-steps, a tile
  // Q's 64 rows, then [buffer][K, V] tiles
  static constexpr int kSmemBytes = (kRows + 4 * kKeys) * kStride * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                              float* __restrict__ o, float* __restrict__ l_out, int n, float scale_log2) {
  using W = Wide<D>;
  constexpr int kStride = W::kStride, kKeysW = W::kKeys, kNt = W::kNt, kSteps = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [kRows][kStride]
  float* kv = smem + kRows * kStride;  // [2][K, V][kKeysW][kStride]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int r0 = blockIdx.x * kRows + warp * 16;
  const float* kg = k + head;
  const float* vg = v + head;

  auto stage = [&](int tile, int buf) {
    float* dst = kv + buf * 2 * kKeysW * kStride;
    wctf32::stage_rows<D>(dst, kg + (size_t)tile * kKeysW * D, kKeysW, kStride, threadIdx.x, kThreads);
    wctf32::stage_rows<D>(dst + kKeysW * kStride, vg + (size_t)tile * kKeysW * D, kKeysW, kStride, threadIdx.x,
                          kThreads);
    cp_async_commit();
  };
  wctf32::stage_rows<D>(qs, q + head + (size_t)blockIdx.x * kRows * D, kRows, kStride, threadIdx.x, kThreads);
  stage(0, 0);  // Q's copies join the first tile's group

  const float* qw = qs + warp * 16 * kStride;  // this warp's 16 rows
  const float ones[kNt][2] = {};               // product_nn's row multipliers: unused here
  float tot[kSteps][4] = {};                   // O's n-tiles, summed over the tiles
  float l_g = 0.f, l_g8 = 0.f;                 // rows g and g+8: this thread's columns

  const int tiles = n / kKeysW;
  for (int tile = 0; tile < tiles; ++tile) {
    const int buf = tile & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile `tile` has landed for every thread; every warp is done with the previous one
    if (tile + 1 < tiles) stage(tile + 1, buf ^ 1);
    const float* ks = kv + buf * 2 * kKeysW * kStride;
    const float* vs = ks + kKeysW * kStride;

    float sc[kNt][4];  // S (exp2 domain) for the tile's keys: n-tile j holds keys 8j..8j+7
    wctf32::product_nt<D, kNt>(sc, qw, scale_log2, ks, kStride, g, t);
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

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n, float scale,
                   cudaStream_t stream) {
  flash_fwd_f32_kernel<D><<<dim3(n / kRows, bh), kThreads, 0, stream>>>(q, k, v, o, l, n, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wide(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n,
                        float scale, cudaStream_t stream) {
  constexpr int smem = Wide<D>::kSmemBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_f32_wide_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_wide_kernel<D><<<dim3(n / kRows, bh), kThreads, smem, stream>>>(q, k, v, o, l, n, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wcflash32

// q, k, v, o: contiguous f32 (bh, n, d), 16-byte aligned; l: f32 (bh, n) or
// null. d in (16, 24, 32, 64, 128, 192), n a multiple of 64. Returns the
// cudaError_t of the launch.
extern "C" int wc_flash_fwd_f32(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n,
                                int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash32::kKeys != 0 || n % wcflash32::kRows != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return wcflash32::launch<16>(q, k, v, o, l, bh, n, scale, s);
    case 24: return wcflash32::launch<24>(q, k, v, o, l, bh, n, scale, s);
    case 32: return wcflash32::launch_wide<32>(q, k, v, o, l, bh, n, scale, s);
    case 64: return wcflash32::launch_wide<64>(q, k, v, o, l, bh, n, scale, s);
    case 128: return wcflash32::launch_wide<128>(q, k, v, o, l, bh, n, scale, s);
    case 192: return wcflash32::launch_wide<192>(q, k, v, o, l, bh, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
