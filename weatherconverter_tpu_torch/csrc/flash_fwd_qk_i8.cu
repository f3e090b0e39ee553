// K2: clamped-softmax flash-attention forward with the QK^T product in int8,
// for sm_90a.
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel_qk_i8` (:125,
// via `_flash_attention_fwd_i8_impl`), its pv_int8=False branch:
//   s = int32(Q8 K8^T) * (qs * ks * D^-1/2);  O = (exp(clip(s, -60, 60)) V) / l,
// Q and K quantized per tensor outside the kernel (plain PyTorch in
// ops/attention.quantize_per_tensor, as XLA did it for the TPU), V and the
// PV product in bf16/f16, l and O accumulated in f32.
//
// What bounds it on the H100: the same as K1 (compute: tensor cores at
// D >= 64, the exp/convert instructions at D = 16/32), with the QK^T half
// on the int8 tensor-core path, which has twice the bf16 rate, and half the
// Q/K bytes. What the design does about it: the tiling, the streamed K/V
// tiles and the in-register p of K1 (flash_common.cuh); the int8 product is
// mma.sync m16n8k32 with s32 accumulation, exact, rescaled once per score.
// At D = 16 the 32-deep int8 contraction is zero-padded: half of that
// product is wasted, the price of one code path for every head size.
#include "flash_common.cuh"

namespace wcflash {

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int8 fragments (m16n8k32): a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..),
// a3 (g+8, 16+4t..); b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_qk_i8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                           const T* __restrict__ v, const float* __restrict__ qk_scale,
                           T* __restrict__ o, int n) {
  constexpr int kChunks = (D + 31) / 32;     // 32-deep int8 k-chunks
  constexpr int kKStride = kChunks * 32 + 16;  // bytes; conflict-free b loads
  __shared__ __align__(16) int8_t ks[kBlockK * kKStride];
  __shared__ __align__(16) T vt[D * kVtStride];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row0 = blockIdx.x * kBlockQ + warp * 16;
  const float scale = *qk_scale;

  uint32_t qa[kChunks][4];
  const int8_t* qw = q8 + head + (size_t)row0 * D;
#pragma unroll
  for (int kc = 0; kc < kChunks; ++kc) {
    qa[kc][0] = ld32(qw + g * D + kc * 32 + 4 * t);
    qa[kc][1] = ld32(qw + (g + 8) * D + kc * 32 + 4 * t);
    // upper half of the chunk exists only when D reaches it (D = 16 pads with 0)
    const bool upper = kc * 32 + 16 < D;
    qa[kc][2] = upper ? ld32(qw + g * D + kc * 32 + 16 + 4 * t) : 0u;
    qa[kc][3] = upper ? ld32(qw + (g + 8) * D + kc * 32 + 16 + 4 * t) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();
    constexpr int kVecPerRow = D / 16;  // 16-byte vectors of int8
    for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
      const int row = i / kVecPerRow;
      const int col = (i % kVecPerRow) * 16;
      *reinterpret_cast<uint4*>(ks + row * kKStride + col) =
          *reinterpret_cast<const uint4*>(k8 + head + (size_t)(k0 + row) * D + col);
    }
    stage_v_transposed<T, D>(vt, v + head, k0);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      int si[4] = {0, 0, 0, 0};
      const int8_t* krow = ks + (nt * 8 + g) * kKStride + 4 * t;
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) {
        const bool upper = kc * 32 + 16 < D;
        const uint32_t b[2] = {ld32(krow + kc * 32), upper ? ld32(krow + kc * 32 + 16) : 0u};
        mma_s8(si, qa[kc], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = __int2float_rn(si[e]) * scale;
    }
    clamp_exp(s, l);
    accumulate_pv<T, D>(acc, s, vt, lane);
  }

  write_output<T, D>(acc, l, o + head + (size_t)row0 * D, nullptr, lane);
}

template <typename T, int D>
cudaError_t launch_i8(const int8_t* q8, const int8_t* k8, const void* v, const float* qk_scale, void* o,
                      int bh, int n, cudaStream_t stream) {
  const dim3 grid(n / kBlockQ, bh);
  flash_fwd_qk_i8_kernel<T, D><<<grid, kThreads, 0, stream>>>(q8, k8, static_cast<const T*>(v), qk_scale,
                                                             static_cast<T*>(o), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_i8(const int8_t* q8, const int8_t* k8, const void* v, const float* qk_scale, void* o,
                        int bh, int n, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_i8<T, 16>(q8, k8, v, qk_scale, o, bh, n, stream);
    case 32: return launch_i8<T, 32>(q8, k8, v, qk_scale, o, bh, n, stream);
    case 64: return launch_i8<T, 64>(q8, k8, v, qk_scale, o, bh, n, stream);
    case 128: return launch_i8<T, 128>(q8, k8, v, qk_scale, o, bh, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wcflash

// q8, k8: contiguous int8 (bh, n, d); v, o: contiguous (bh, n, d) in bf16
// (is_f16 = 0) or f16 (is_f16 = 1); qk_scale: one f32 on the device,
// qs * ks * d^-1/2. Returns the cudaError_t of the launch.
extern "C" int wc_flash_fwd_qk_i8(const void* q8, const void* k8, const void* v, const float* qk_scale,
                                  void* o, int bh, int n, int d, int is_f16, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kBlockQ != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(q8);
  const int8_t* k = static_cast<const int8_t*>(k8);
  return is_f16 ? wcflash::dispatch_i8<__half>(q, k, v, qk_scale, o, bh, n, d, s)
                : wcflash::dispatch_i8<__nv_bfloat16>(q, k, v, qk_scale, o, bh, n, d, s);
}
