// The int8 quantizer of Q and K in front of K2 (flash_fwd_qk_i8.cu), with one
// scale per tensor or one per batch row, for sm_90a.
//
// Replaces the quantization in weatherconverter_tpu/ops/attention.py
// `_flash_attention_fwd_i8_impl` (:173-189), which is plain jnp there: XLA, not
// a Pallas kernel, fused it into the projection's epilogue on the TPU. Eager
// PyTorch fuses nothing: the same lines cost some nine launches and 330 MB of
// traffic a tensor at (32, 4096, 64). For x in {q, k}, 16-bit (B, H, N, D):
//   scale_x = max(max|x|, 1e-6) / 127;   x8 = int8(round_half_even(x / scale_x));
//   qk_scale = scale_q * scale_k / sqrt(D)                            (all f32)
// over the whole tensor (one scale, as the JAX function computes it called
// once on the batch), or over each batch row's (H, N, D) (B scales, as it
// computes it under jax.vmap over requests, which the JAX server does).
//
// What bounds it: bytes. Each tensor is read twice (once for the maximum,
// once to quantize) and written once in int8: 5 bytes an element where the
// least is 3 (the maximum must be known before the first byte is written, so
// only a cache can save the second read; both tensors of a UNet layer, 34 MB,
// fit the 50 MB L2). What the design does about it: two launches for both
// tensors together (blockIdx.y picks q or k, blockIdx.z the scale's segment:
// the tensor, or one batch row), 16 elements a thread at a time (two 16-byte
// loads, one 16-byte store), grid-stride within the segment.
//   * Pass 1: |x| is the 16-bit pattern without its sign, and for finite
//     values patterns order like the numbers, so the maximum is taken on packed
//     pairs of patterns (__vmaxu2) with no conversion; a warp reduction, a
//     block reduction through shared memory, then one atomicMax a block on the
//     bits of the non-negative f32, which again order like the floats, into
//     the slot of its segment (and of q or k): a block never reads a group of
//     another segment, since groups are numbered in (b, h, n, d) order and a
//     row's are consecutive, whatever the strides of the view. A
//     maximum is the same in any order, so two calls give the same bits.
//     An infinity's pattern lies above every finite one and a NaN's above
//     that, so a non-finite element becomes the maximum and reaches qk_scale
//     (inf or NaN) as it does in the plain version, instead of being
//     quantized silently.
//   * Pass 2: every thread rebuilds its segment's scale from the maximum and
//     divides.
// It equals the plain PyTorch version bit for bit: correctly rounded division
// (__fdiv_rn, never a multiply by the reciprocal), __float2int_rn (half to
// even), the scale arithmetic in the plain version's order; the build has no
// -use_fast_math.
// The inputs may be strided views (the UNet hands head-split slices of one
// projection): any (B, H, N) strides that keep rows of D contiguous and
// 16-byte aligned; the outputs are contiguous.
// Not folded into K2: each block quantizing the K tiles it walks would redo
// every K tile N/64 times, and the maximum has to be known first anyway.
// Measured on an H100 (700 W, bf16, q and k of (32, N, D), chip_smoke.py
// phase 2, the two launches and the zero fill together): 0.0427 ms at
// (4096, 64) against 0.3268 ms for the eager lines and a bound of 0.0150 ms;
// 0.0160 at (4096, 16); 0.0230 and 0.0133 at (1024, 128) and (1024, 32),
// where the chain of three small launches is most of the time.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wcquant {

constexpr int kThreads = 256;
constexpr int kGroup = 16;       // elements a thread takes at a time
constexpr int kMaxBlocks = 1056;  // a tensor: 8 blocks an SM on 132 SMs, then grid-stride (half as many measured no faster)

// Element strides of the batch, head and row dimensions; d is contiguous.
struct Strides {
  long long b, h, n;
};

struct Shape {
  int h, n, d;
  long long groups;  // groups a segment: B * H * N * D / kGroup over the segments
};

// Group i of 16 consecutive elements of one row, in (b, h, n, d) order.
template <typename T>
__device__ __forceinline__ const T* group_ptr(const T* x, const Strides& st, const Shape& sh, long long i) {
  const int per_row = sh.d / kGroup;
  const long long row = i / per_row;
  const int c = (int)(i % per_row);
  const long long bh = row / sh.n;
  return x + (bh / sh.h) * st.b + (bh % sh.h) * st.h + (row % sh.n) * st.n + c * kGroup;
}

__device__ __forceinline__ float pattern_to_float(uint32_t bits16, __nv_bfloat16) {
  return __uint_as_float(bits16 << 16);
}
__device__ __forceinline__ float pattern_to_float(uint32_t bits16, __half) {
  return __half2float(__ushort_as_half((unsigned short)bits16));
}

// amax_bits[z], amax_bits[S + z] (zero before the launch; S = gridDim.z segments) = the bits of segment z's
// max|q|, max|k| as f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    absmax_qk_kernel(const T* __restrict__ q, const T* __restrict__ k, Strides q_st, Strides k_st, Shape sh,
                     unsigned int* __restrict__ amax_bits) {
  __shared__ uint32_t warp_max[kThreads / 32];
  const T* x = blockIdx.y ? k : q;
  const Strides st = blockIdx.y ? k_st : q_st;
  const long long first = (long long)blockIdx.z * sh.groups, end = first + sh.groups;
  uint32_t m = 0;  // two running maxima of 15-bit magnitudes, packed
  for (long long i = first + (long long)blockIdx.x * kThreads + threadIdx.x; i < end;
       i += (long long)gridDim.x * kThreads) {
    const uint4* p = reinterpret_cast<const uint4*>(group_ptr(x, st, sh, i));
    const uint4 a = p[0], b = p[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) m = __vmaxu2(m, w[j] & 0x7fff7fffu);
  }
  uint32_t best = __reduce_max_sync(0xffffffffu, max(m & 0xffffu, m >> 16));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) best = max(best, warp_max[w]);
    atomicMax(amax_bits + blockIdx.y * gridDim.z + blockIdx.z, __float_as_uint(pattern_to_float(best, T())));
  }
}

__device__ __forceinline__ float2 to_float2(uint32_t pair, __nv_bfloat16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
}
__device__ __forceinline__ float2 to_float2(uint32_t pair, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&pair));
}

// max(amax, 1e-6) / 127. A NaN maximum stays NaN, as the plain version's clamp_min keeps it (fmaxf would drop it).
__device__ __forceinline__ float tensor_scale(float amax) {
  return __fdiv_rn(amax != amax ? amax : fmaxf(amax, 1e-6f), 127.f);
}

// Four 16-bit pairs -> eight int8 values in two words, x / scale rounded half to even.
template <typename T>
__device__ __forceinline__ uint2 quantize8(const uint4& v, float scale) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = to_float2(w[j], T());
    const uint32_t lo = (uint32_t)__float2int_rn(__fdiv_rn(f.x, scale)) & 0xffu;
    const uint32_t hi = (uint32_t)__float2int_rn(__fdiv_rn(f.y, scale)) & 0xffu;
    out[j / 2] |= (lo | (hi << 8)) << (16 * (j % 2));
  }
  return make_uint2(out[0], out[1]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_qk_kernel(const T* __restrict__ q, const T* __restrict__ k, Strides q_st, Strides k_st, Shape sh,
                       const float* __restrict__ amax, int8_t* __restrict__ q8, int8_t* __restrict__ k8,
                       float* __restrict__ qk_scale, float sqrt_d) {
  const T* x = blockIdx.y ? k : q;
  const Strides st = blockIdx.y ? k_st : q_st;
  int8_t* out = blockIdx.y ? k8 : q8;
  const float scale = tensor_scale(amax[blockIdx.y * gridDim.z + blockIdx.z]);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    qk_scale[blockIdx.z] = __fdiv_rn(__fmul_rn(scale, tensor_scale(amax[gridDim.z + blockIdx.z])), sqrt_d);
  const long long first = (long long)blockIdx.z * sh.groups, end = first + sh.groups;
  for (long long i = first + (long long)blockIdx.x * kThreads + threadIdx.x; i < end;
       i += (long long)gridDim.x * kThreads) {
    const uint4* p = reinterpret_cast<const uint4*>(group_ptr(x, st, sh, i));
    const uint2 lo = quantize8<T>(p[0], scale), hi = quantize8<T>(p[1], scale);
    *reinterpret_cast<uint4*>(out + i * kGroup) = make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, Strides q_st, Strides k_st, int b, int scales, Shape sh,
                   float* amax, int8_t* q8, int8_t* k8, float* qk_scale, float sqrt_d, cudaStream_t stream) {
  sh.groups = (long long)b * sh.h * sh.n * sh.d / kGroup / scales;
  const long long want = (sh.groups + kThreads - 1) / kThreads, most = (kMaxBlocks + scales - 1) / scales;
  const dim3 grid((unsigned)(want < most ? want : most), 2, scales);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  absmax_qk_kernel<T><<<grid, kThreads, 0, stream>>>(qt, kt, q_st, k_st, sh, reinterpret_cast<unsigned int*>(amax));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_qk_kernel<T><<<grid, kThreads, 0, stream>>>(qt, kt, q_st, k_st, sh, amax, q8, k8, qk_scale,
                                                       sqrt_d);
  return cudaGetLastError();
}

}  // namespace wcquant

// q, k: (b, h, n, d) in bf16 (is_f16 = 0) or f16 (is_f16 = 1), d a multiple of
// 16 and contiguous, rows 16-byte aligned; q_strides, k_strides: the element
// strides of their b, h and n dimensions. scales: 1 (one scale per tensor) or
// b (one per batch row). amax: 2 * scales f32 on the device, zero (the maxima
// of q's segments, then k's, are left there); q8, k8: contiguous int8 (b, h,
// n, d); qk_scale: `scales` f32 on the device; sqrt_d: d^1/2 rounded to f32.
// Two launches. Returns the cudaError_t of the last.
extern "C" int wc_quantize_qk_i8(const void* q, const void* k, const long long* q_strides,
                                 const long long* k_strides, int b, int h, int n, int d, int is_f16, int scales,
                                 float* amax, void* q8, void* k8, float* qk_scale, float sqrt_d, void* stream) {
  using namespace wcquant;
  if (b <= 0 || h <= 0 || n <= 0 || d <= 0 || d % kGroup != 0 || (scales != 1 && scales != b) || b > 65535)
    return cudaErrorInvalidValue;
  const Strides q_st{q_strides[0], q_strides[1], q_strides[2]}, k_st{k_strides[0], k_strides[1], k_strides[2]};
  const Shape sh{h, n, d, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q8p = static_cast<int8_t*>(q8);
  int8_t* k8p = static_cast<int8_t*>(k8);
  return is_f16 ? launch<__half>(q, k, q_st, k_st, b, scales, sh, amax, q8p, k8p, qk_scale, sqrt_d, s)
                : launch<__nv_bfloat16>(q, k, q_st, k_st, b, scales, sh, amax, q8p, k8p, qk_scale, sqrt_d, s);
}
