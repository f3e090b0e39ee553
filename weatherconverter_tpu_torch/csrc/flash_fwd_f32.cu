// K1-f32: the clamped-softmax flash-attention forward in float32, plain FMA,
// for sm_90a, at the legacy UNet's head dims (16: attn_down3, 24: attn_up2).
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel` (:78, via
// `_flash_attention_fwd_impl`) where the JAX legacy UNet runs it, in f32
// (weatherconverter_tpu/models/unet_legacy.py:151):
//   O = (exp(clip(Q K^T * D^-1/2, -60, 60)) V) / l,   l = row sum of the exponentials,
// every product and sum in f32, as K1's plain version computes it in f32.
// The bf16 K1 (flash_fwd.cu) serves bf16 models; this one serves the
// legacy UNet run in f32, as JAX runs it (probes/legacy_precision.py holds
// its bf16 chain against its f32 chain). Forward only: the legacy UNet only
// samples.
//
// What bounds it on the H100: per head 4*N^2*D f32 FLOPs on the CUDA cores
// (67 TFLOP/s; the tensor cores' TF32 would round the scores to 10 bits,
// which is the precision this kernel exists to keep) and N^2 exponentials,
// against 4*N*D*4 bytes: operations, by three orders of magnitude.
// The design is the simple one: one thread owns one query row (its q, o and
// l in registers) and walks the keys; a block of 64 threads stages each
// 64-key tile of K and V in shared memory with 16-byte loads, and every
// thread reads the same key at once (a broadcast, no bank conflicts), 16
// bytes a read. No running max: as in K1, O and l add up unscaled. Left for
// later: splitting a row's keys over several threads (N * B * H threads is
// about 250 a SM at the legacy UNet's batch 8, too few to hide latency), and
// double-buffered tiles.
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace wcflash32 {

constexpr int kRows = 64;  // query rows (threads) a block
constexpr int kKeys = 64;  // keys a shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLog2 = wcflash::kClamp * kLog2e;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kRows)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ o, float* __restrict__ l_out, int n, float scale_log2) {
  static_assert(D % 4 == 0, "rows of whole 16-byte chunks");
  constexpr int kChunks = kKeys * D / 4;  // float4s a tile
  __shared__ float4 ks[kChunks], vs[kChunks];
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row = blockIdx.x * kRows + threadIdx.x;
  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = reinterpret_cast<const float4*>(q + head + (size_t)row * D)[c];
    qr[4 * c] = x.x, qr[4 * c + 1] = x.y, qr[4 * c + 2] = x.z, qr[4 * c + 3] = x.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float l = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(k + head);
  const float4* v4 = reinterpret_cast<const float4*>(v + head);
  for (int t0 = 0; t0 < n; t0 += kKeys) {
    __syncthreads();  // everyone is done with the previous tile
    for (int i = threadIdx.x; i < kChunks; i += kRows) {
      ks[i] = k4[(size_t)t0 * D / 4 + i];
      vs[i] = v4[(size_t)t0 * D / 4 + i];
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 x = ks[j * D / 4 + c];
        s = fmaf(qr[4 * c], x.x, s);
        s = fmaf(qr[4 * c + 1], x.y, s);
        s = fmaf(qr[4 * c + 2], x.z, s);
        s = fmaf(qr[4 * c + 3], x.w, s);
      }
      const float p = ex2(fminf(fmaxf(s * scale_log2, -kClampLog2), kClampLog2));
      l += p;
#pragma unroll
      for (int c = 0; c < D / 4; ++c) {
        const float4 x = vs[j * D / 4 + c];
        acc[4 * c] = fmaf(p, x.x, acc[4 * c]);
        acc[4 * c + 1] = fmaf(p, x.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, x.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, x.w, acc[4 * c + 3]);
      }
    }
  }
  if (l_out != nullptr) l_out[(size_t)blockIdx.y * n + row] = l;
  const float inv = 1.f / l;
  float4* o4 = reinterpret_cast<float4*>(o + head + (size_t)row * D);
#pragma unroll
  for (int c = 0; c < D / 4; ++c)
    o4[c] = make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv, acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n, float scale,
                   cudaStream_t stream) {
  flash_fwd_f32_kernel<D><<<dim3(n / kRows, bh), kRows, 0, stream>>>(q, k, v, o, l, n, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace wcflash32

// q, k, v, o: contiguous f32 (bh, n, d); l: f32 (bh, n) or null. d in (16, 24),
// n a multiple of 64. Returns the cudaError_t of the launch.
extern "C" int wc_flash_fwd_f32(const float* q, const float* k, const float* v, float* o, float* l, int bh, int n,
                                int d, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash32::kKeys != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return wcflash32::launch<16>(q, k, v, o, l, bh, n, scale, s);
    case 24: return wcflash32::launch<24>(q, k, v, o, l, bh, n, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
