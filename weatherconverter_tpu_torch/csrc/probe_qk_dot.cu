// K7: the raw QK^T product in int8 and in bf16, a micro-probe, for sm_90a.
//
// Replaces scripts/probe_int8_dot.py `k_int8` (:24) and `k_bf16` (:34), via
// `build(...).run` (:47):
//   S = Q K^T, (B, N, D) x (B, N, D) -> (B, N, N), int8 -> int32 and bf16 -> f32,
// the whole N x N written out.
//
// The probe's question: what is the int8 rate against the bf16 rate of this
// product on this card? What bounds it: each call writes 4*B*N^2 bytes (64
// MiB at B=1, N=4096) for 2*B*N^2*D operations (2.1 G at D=64): 32 operations
// per byte written, far below the tensor cores' ~295 (bf16) or ~590 (int8)
// per byte of device memory. So both forms are bound by the writes, and this
// shape cannot show int8's twice-the-bf16 tensor rate.
// What the design does about it: one block per 64 x 64 output tile, Q read
// into A fragments from global memory, the tile's 64 K rows staged once in
// shared memory; mma.sync (m16n8k32 s8 and m16n8k16 bf16, as laid out in
// flash_common.cuh) and the accumulators stored straight to global memory,
// each quad of lanes writing 32 contiguous bytes of one row.
#include "flash_common.cuh"

namespace wcprobe {
namespace {

using namespace wcflash;

template <int D>
__global__ void __launch_bounds__(kThreads)
    probe_qk_i8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k, int32_t* __restrict__ s,
                       int n) {
  constexpr int kChunks = D / 32;   // 32-deep int8 k-chunks
  constexpr int kKStride = D + 16;  // bytes; conflict-free b loads
  __shared__ __align__(16) int8_t ks[kBlockK * kKStride];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.z * n * D;
  const int row0 = blockIdx.y * kBlockQ + warp * 16;
  const int col0 = blockIdx.x * kBlockK;

  constexpr int kVecPerRow = D / 16;  // 16-byte vectors of int8
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int row = i / kVecPerRow;
    const int col = (i % kVecPerRow) * 16;
    *reinterpret_cast<uint4*>(ks + row * kKStride + col) =
        *reinterpret_cast<const uint4*>(k + head + (size_t)(col0 + row) * D + col);
  }

  uint32_t qa[kChunks][4];
  const int8_t* qw = q + head + (size_t)row0 * D;
#pragma unroll
  for (int kc = 0; kc < kChunks; ++kc) {
    qa[kc][0] = ld32(qw + g * D + kc * 32 + 4 * t);
    qa[kc][1] = ld32(qw + (g + 8) * D + kc * 32 + 4 * t);
    qa[kc][2] = ld32(qw + g * D + kc * 32 + 16 + 4 * t);
    qa[kc][3] = ld32(qw + (g + 8) * D + kc * 32 + 16 + 4 * t);
  }
  __syncthreads();

  int32_t* out = s + (size_t)blockIdx.z * n * n + (size_t)row0 * n + col0;
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
    int c[4] = {0, 0, 0, 0};
    const int8_t* krow = ks + (nt * 8 + g) * kKStride + 4 * t;
#pragma unroll
    for (int kc = 0; kc < kChunks; ++kc) {
      const uint32_t b[2] = {ld32(krow + kc * 32), ld32(krow + kc * 32 + 16)};
      mma_s8(c, qa[kc], b);
    }
    *reinterpret_cast<int2*>(out + (size_t)g * n + nt * 8 + 2 * t) = make_int2(c[0], c[1]);
    *reinterpret_cast<int2*>(out + (size_t)(g + 8) * n + nt * 8 + 2 * t) = make_int2(c[2], c[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    probe_qk_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         float* __restrict__ s, int n) {
  using T = __nv_bfloat16;
  constexpr int kKStride = D + kPad;
  __shared__ __align__(16) T ks[kBlockK * kKStride];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.z * n * D;
  const int row0 = blockIdx.y * kBlockQ + warp * 16;
  const int col0 = blockIdx.x * kBlockK;

  constexpr int kVecPerRow = D / 8;  // 16-byte vectors of bf16
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int row = i / kVecPerRow;
    const int col = (i % kVecPerRow) * 8;
    *reinterpret_cast<uint4*>(ks + row * kKStride + col) =
        *reinterpret_cast<const uint4*>(k + head + (size_t)(col0 + row) * D + col);
  }

  uint32_t qa[D / 16][4];
  const T* qw = q + head + (size_t)row0 * D;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qa[kc][0] = ld32(qw + g * D + kc * 16 + 2 * t);
    qa[kc][1] = ld32(qw + (g + 8) * D + kc * 16 + 2 * t);
    qa[kc][2] = ld32(qw + g * D + kc * 16 + 8 + 2 * t);
    qa[kc][3] = ld32(qw + (g + 8) * D + kc * 16 + 8 + 2 * t);
  }
  __syncthreads();

  float* out = s + (size_t)blockIdx.z * n * n + (size_t)row0 * n + col0;
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const T* krow = ks + (nt * 8 + g) * kKStride + 2 * t;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t b[2] = {ld32(krow + kc * 16), ld32(krow + kc * 16 + 8)};
      Mma<T>::run(c, qa[kc], b);
    }
    *reinterpret_cast<float2*>(out + (size_t)g * n + nt * 8 + 2 * t) = make_float2(c[0], c[1]);
    *reinterpret_cast<float2*>(out + (size_t)(g + 8) * n + nt * 8 + 2 * t) = make_float2(c[2], c[3]);
  }
}

template <typename In, typename Out>
cudaError_t launch(void (*kernel)(const In*, const In*, Out*, int), const void* q, const void* k, void* s,
                   int b, int n, cudaStream_t stream) {
  const dim3 grid(n / kBlockK, n / kBlockQ, b);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const In*>(q), static_cast<const In*>(k),
                                        static_cast<Out*>(s), n);
  return cudaGetLastError();
}

bool valid(int b, int n) { return b > 0 && b <= 65535 && n > 0 && n % kBlockQ == 0 && n / kBlockQ <= 65535; }

}  // namespace
}  // namespace wcprobe

// q, k: contiguous int8 (b, n, d), d in {32, 64, 128}; s: contiguous int32
// (b, n, n). Returns the cudaError_t of the launch.
extern "C" int wc_probe_qk_i8(const void* q, const void* k, void* s, int b, int n, int d, void* stream) {
  using namespace wcprobe;
  if (!valid(b, n)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch(probe_qk_i8_kernel<32>, q, k, s, b, n, st);
    case 64: return launch(probe_qk_i8_kernel<64>, q, k, s, b, n, st);
    case 128: return launch(probe_qk_i8_kernel<128>, q, k, s, b, n, st);
    default: return cudaErrorInvalidValue;
  }
}

// q, k: contiguous bf16 (b, n, d), d in {32, 64, 128}; s: contiguous f32
// (b, n, n). Returns the cudaError_t of the launch.
extern "C" int wc_probe_qk_bf16(const void* q, const void* k, void* s, int b, int n, int d, void* stream) {
  using namespace wcprobe;
  if (!valid(b, n)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch(probe_qk_bf16_kernel<32>, q, k, s, b, n, st);
    case 64: return launch(probe_qk_bf16_kernel<64>, q, k, s, b, n, st);
    case 128: return launch(probe_qk_bf16_kernel<128>, q, k, s, b, n, st);
    default: return cudaErrorInvalidValue;
  }
}
