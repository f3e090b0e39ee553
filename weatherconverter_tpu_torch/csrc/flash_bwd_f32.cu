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
// seven products (S and dO V^T twice; eight at D >= 128, below) and 2 N^2
// exponentials against that bound.
//
// The design follows K3's two passes, so there are no atomics and the
// gradients repeat bit for bit:
//   * Pass 1 (dQ): a block is 4 warps, each owning 16 query rows; it stages
//     its 64 rows of Q and dO once, computes Dv and 1/l of its rows (and
//     writes them to an f32 scratch for pass 2), then walks K and V in
//     tiles: S = Q K^T and dP = dO V^T for the tile, m in registers, and
//     dQ += m K.
//   * Pass 2 (dK, dV): a block owns 64 keys (16 a warp) with their K and V
//     rows staged once, and walks Q, dO, 1/l and Dv in tiles: S^T = K Q^T
//     and dP^T = V dO^T, so p^T and m^T come out with keys as rows, then
//     dV += p^T (dO / l) and dK += m^T (Q * scale / l), 1/l (and scale)
//     multiplied into the B fragments as they are loaded.
//   * Every operand is staged as raw f32 rows padded to D + 4 floats
//     (cp.async, tiles double buffered) and split into TF32 hi and lo as its
//     fragment is loaded; p, m and their transposes go from the score
//     products' accumulators into the next product's A fragment without
//     leaving registers. Each product's sum runs in chains of four k-steps
//     joined by FADD, for the precision K1-f32 measured (flash_tf32.cuh).
//   * Walked tiles of 64 rows at D <= 32 and 32 from D = 64 on (16 in pass
//     1 at D = 192, where 32 spilled 28 bytes at 255 registers), so that the
//     scores (S and dP, one register each a row pair), the split m or p (one
//     register a row) and the running sums (D / 2 registers an output) fit
//     a thread's 255 registers. At D = 128 and 192 dK and dV together would
//     be 128 and 192 registers of running sums: pass 2 is launched twice
//     there, once for dV (S^T and p^T dO) and once for dK (S^T, dP^T and
//     m^T Q), as the bf16 K3 does at D = 192; S^T is then formed twice.
//   * Shared memory: pass 1 (Q, dO and two (K, V) tiles) 31, 55, 70, 135 and
//     150 KB at D = 16, 32, 64, 128, 192; pass 2 (K, V, two (Q, dO) tiles
//     and their 1/l and Dv) 32, 56, 70, 136 and 201 KB.
// A first version that is right and simple; wgmma with tf32 operands, and
// splitting each staged tile once for all four warps, are later work.
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
using wctf32::ex2;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // a block's own rows: queries in pass 1, keys in pass 2

template <int D>
struct Cfg {
  static constexpr int kTile = D <= 32 ? 64 : 32;          // rows of a walked tile in pass 2
  static constexpr int kTileDq = D > 128 ? 16 : kTile;     // and in pass 1
  static constexpr int kStride = D + 4;
  static constexpr int kNt = kTile / 8;
  static constexpr bool kSplitDkv = D >= 128;
  // pass 1: Q and dO rows, then [buffer][K, V] tiles
  static constexpr int kDqSmemBytes = (2 * kRows + 4 * kTileDq) * kStride * 4;
  // pass 2: K and V rows, [buffer][Q, dO] tiles, then [buffer][1/l, Dv] vectors
  static constexpr int kDkvSmemBytes = ((2 * kRows + 4 * kTile) * kStride + 4 * kTile) * 4;
};

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

template <int D, int kOut>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* d_o, const float* linv,
                       const float* dvec, float* dk, float* dv, dim3 grid, int n, float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::kDkvSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_f32_dkv_kernel<D, kOut>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_f32_dkv_kernel<D, kOut>
      <<<grid, kThreads, smem, stream>>>(q, k, v, d_o, linv, dvec, dk, dv, n, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* q, const float* k, const float* v, const float* o, const float* d_o,
                       const float* l, float* dq, float* dk, float* dv, float* scratch, int bh, int n, float scale,
                       cudaStream_t stream) {
  constexpr int smem1 = Cfg<D>::kDqSmemBytes;
  float* dvec = scratch;                   // Dv, pass 1 -> pass 2
  float* linv = scratch + (size_t)bh * n;  // 1 / l, pass 1 -> pass 2
  const dim3 grid(n / kRows, bh);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_f32_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  flash_bwd_f32_dq_kernel<D>
      <<<grid, kThreads, smem1, stream>>>(q, k, v, o, d_o, l, dq, dvec, linv, n, scale, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (Cfg<D>::kSplitDkv) {
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
