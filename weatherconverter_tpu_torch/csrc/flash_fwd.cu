// K1: clamped-softmax flash-attention forward, bf16/f16, for sm_90a.
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel` (:78, via
// `_flash_attention_fwd_impl`) and `_flash_kernel_stream_fwd` (:456, via
// `_flash_stream_fwd_impl`):
//   O = (exp(clip(Q K^T * D^-1/2, -60, 60)) V) / l,   l = row sum of the f32 exponentials,
// with p cast to the input type before the PV product and O normalised after it.
//
// What bounds it on the H100: at the UNet's shapes (N = 1024/4096, D = 16..128)
// the work is 4*N^2*D tensor-core FLOPs plus N^2 exponentials per head, against
// only 4*N*D*2 bytes of Q/K/V/O traffic, so it is compute-bound: on the tensor
// cores at D >= 64 and on the exp/clamp/convert instructions at D = 16/32.
// What the design does about it:
//   * The TPU kernel kept a whole K/V head resident (512 KiB at N=4096, D=64);
//     an SM has 227 KB, so here keys stream through shared memory in tiles
//     of 64 and nothing of size N^2 ever leaves registers.
//   * The clamp replaces the running row max, so partial sums need no
//     rescaling: O and l accumulate in f32 directly across key tiles.
//   * p goes from the QK^T accumulators into the PV product in registers.
// Left for later: wgmma, TMA and a cp.async pipeline (loads and MMAs do not
// overlap yet), and strided inputs (the wrapper makes them contiguous).
#include "flash_common.cuh"

namespace wcflash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, float* __restrict__ l_out, int n, float scale) {
  constexpr int kKStride = D + kPad;
  __shared__ __align__(16) T ks[kBlockK * kKStride];
  __shared__ __align__(16) T vt[D * kVtStride];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row0 = blockIdx.x * kBlockQ + warp * 16;

  // This warp's Q rows as A fragments, read once from global memory.
  uint32_t qa[D / 16][4];
  const T* qw = q + head + (size_t)row0 * D;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qa[kc][0] = ld32(qw + g * D + kc * 16 + 2 * t);
    qa[kc][1] = ld32(qw + (g + 8) * D + kc * 16 + 2 * t);
    qa[kc][2] = ld32(qw + g * D + kc * 16 + 8 + 2 * t);
    qa[kc][3] = ld32(qw + (g + 8) * D + kc * 16 + 8 + 2 * t);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kVecPerRow = D / 8;
    for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
      const int row = i / kVecPerRow;
      const int col = (i % kVecPerRow) * 8;
      *reinterpret_cast<uint4*>(ks + row * kKStride + col) =
          *reinterpret_cast<const uint4*>(k + head + (size_t)(k0 + row) * D + col);
    }
    stage_v_transposed<T, D>(vt, v + head, k0);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* krow = ks + (nt * 8 + g) * kKStride + 2 * t;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t b[2] = {ld32(krow + kc * 16), ld32(krow + kc * 16 + 8)};
        Mma<T>::run(s[nt], qa[kc], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
    }
    clamp_exp(s, l);
    accumulate_pv<T, D>(acc, s, vt, lane);
  }

  write_output<T, D>(acc, l, o + head + (size_t)row0 * D,
                     l_out == nullptr ? nullptr : l_out + (size_t)blockIdx.y * n + row0, lane);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* l, int bh, int n,
                   float scale, cudaStream_t stream) {
  const dim3 grid(n / kBlockQ, bh);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
      l, n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* l, int bh, int n,
                       int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, l, bh, n, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, l, bh, n, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, l, bh, n, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, l, bh, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wcflash

// q, k, v, o: contiguous (bh, n, d) in bf16 (is_f16 = 0) or f16 (is_f16 = 1).
// l: f32 (bh, n) or null. Returns the cudaError_t of the launch.
extern "C" int wc_flash_fwd(const void* q, const void* k, const void* v, void* o, float* l, int bh,
                            int n, int d, int is_f16, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kBlockQ != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcflash::dispatch_d<__half>(q, k, v, o, l, bh, n, d, scale, s)
                : wcflash::dispatch_d<__nv_bfloat16>(q, k, v, o, l, bh, n, d, scale, s);
}

extern "C" const char* wc_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }
