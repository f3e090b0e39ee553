// K1-f32: the clamped-softmax flash-attention forward in float32, for
// sm_90a, at the legacy UNet's head dims (16: attn_down3, 24: attn_up2), on
// the tensor cores in 3xTF32.
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel` (:78, via
// `_flash_attention_fwd_impl`) where the JAX legacy UNet runs it, in f32
// (weatherconverter_tpu/models/unet_legacy.py:151):
//   O = (exp(clip(Q K^T * D^-1/2, -60, 60)) V) / l,   l = row sum of the exponentials,
// every sum in f32, as K1's plain version computes it in f32. The bf16 K1
// (flash_fwd.cu) serves bf16 models; this one serves the legacy UNet run in
// f32, as JAX runs it (probes/legacy_precision.py holds its bf16 chain
// against its f32 chain). Forward only: the legacy UNet only samples.
//
// What bounds it on the H100: per head N^2 exponentials (3.86e12/s) and
// 4*N^2*D products. One TF32 pass would round the scores to 10 bits, which
// is the precision this kernel exists to keep; so each operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), and each product is formed as
// lo*hi + hi*lo + hi*hi, accumulated in f32 (about 21 bits of the product:
// the dropped lo*lo term is below 2^-22 of it): three TF32 products at
// 494.7 TFLOP/s in place of one f32 FMA at 67 (the first design, one thread
// a query row on the CUDA cores, ran at 34-36 % of that FMA bound: its
// serial chain of D dependent FMAs a score, and ~250 threads an SM, could
// not hide latency).
//
// The design: a block is 4 warps, each owning 16 query rows, and walks the
// keys in 64-key tiles. Tiles of K and V are staged by cp.async, double
// buffered (tile t+1 is in flight while tile t is split and used), into rows
// padded to D + 4 floats, so every fragment load below is free of bank
// conflicts. Once a tile has landed, the block splits it once: hi over the
// staged value in place, lo into a second buffer. Each warp keeps its Q
// fragments, scaled by D^-1/2 * log2(e) and split, in registers for the
// whole walk. Per tile a warp forms S = Q K^T (16 x 64: eight n-tiles of
// mma.sync.m16n8k8.tf32, D/8 k-steps each, three products a step), takes
// p = exp2(clamp(S)) in registers (no running max: as in K1, O and l add up
// unscaled), splits p there, and adds P V (eight k-steps, D/8 n-tiles) into
// two sets of accumulators (even and odd key steps, two independent chains
// an n-tile), which join the running sum by FADD at the end of the tile.
// That last step is for precision: the tensor cores' f32 accumulation does
// not round to nearest, and one chain of MMAs over all N keys left O 3-7e-6
// of max|O| from the plain version (f32) at N = 1024, where a tile's chain
// of eight k-steps leaves 1-2e-6 (ablations timed once on the H100, PERF.md
// section 6; fresh accumulators for each k-step of S left the error as it
// was and cost 2-13 %). __launch_bounds__ asks for 4 blocks an SM (at most
// 128 registers): the legacy UNet's batch 8 makes 512 blocks, one wave of
// 528; ptxas's own choice at D = 24, 133 registers and 3 blocks, took 30 %
// longer. P's fragment comes straight from S's accumulators: a thread
// holds keys 2t and 2t+1 of each 8-key step, which it feeds as the A
// fragment's columns t and t+4; V's B fragment reads the same keys (rows 2t
// and 2t+1 of the step), so the reduction pairs them up.
//
// mma.sync.m16n8k8 with .tf32 (PTX ISA), lane = 4*g + t:
//   A (16x8):  a0 (row g, col t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8x8):   b0 (k t, n g)      b1 (k t+4, n g)
//   C (16x8):  c0, c1 (row g, cols 2t, 2t+1)   c2, c3 (row g+8, cols 2t, 2t+1)
#include <cuda_runtime.h>

#include "flash_wgmma.cuh"

namespace wcflash32 {

using wcflash::cp_async16;
using wcflash::cp_async_commit;
using wcflash::cp_async_wait;
using wcflash::kClampLog2;
using wcflash::kLog2e;
using wcflash::smem_u32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block
constexpr int kKeys = 64;           // keys a shared-memory tile

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to the nearest TF32 value (ties away from zero), its low 13 bits zero.
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo to about 2^-22 of x: hi its TF32 rounding, lo that of the (exact) rest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

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

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n, float scale,
                   cudaStream_t stream) {
  flash_fwd_f32_kernel<D><<<dim3(n / kRows, bh), kThreads, 0, stream>>>(q, k, v, o, l, n, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wcflash32

// q, k, v, o: contiguous f32 (bh, n, d), 16-byte aligned; l: f32 (bh, n) or
// null. d in (16, 24), n a multiple of 64. Returns the cudaError_t of the launch.
extern "C" int wc_flash_fwd_f32(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n,
                                int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash32::kKeys != 0 || n % wcflash32::kRows != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return wcflash32::launch<16>(q, k, v, o, l, bh, n, scale, s);
    case 24: return wcflash32::launch<24>(q, k, v, o, l, bh, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
