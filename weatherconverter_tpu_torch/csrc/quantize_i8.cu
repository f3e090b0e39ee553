// The int8 quantizer of Q and K in front of K2 (flash_fwd_qk_i8.cu), with one
// scale per tensor or one per batch row, for sm_90a.
//
// Replaces the quantization in weatherconverter_tpu/ops/attention.py
// `_flash_attention_fwd_i8_impl` (:173-189), which is plain jnp there: XLA, not
// a Pallas kernel, fused it into the projection's epilogue on the TPU. Eager
// PyTorch fuses nothing: the same lines cost some nine launches and 330 MB of
// traffic a tensor at (32, 4096, 64). For x in {q, k}, bf16, f16 or f32
// (B, H, N, D) (f32 in front of K2-f32, JAX's f32 inference):
//   scale_x = max(max|x|, 1e-6) / 127;   x8 = int8(round_half_even(x / scale_x));
//   qk_scale = scale_q * scale_k / sqrt(D)                            (all f32)
// over the whole tensor (one scale, as the JAX function computes it called
// once on the batch), or over each batch row's (H, N, D) (B scales, as it
// computes it under jax.vmap over requests, which the JAX server does).
//
// What bounds it: bytes. Each tensor is read twice (once for the maximum,
// once to quantize) and written once in int8: 5 bytes an element where the
// least is 3 (9 where the least is 5 for f32; the maximum must be known
// before the first byte is written, so only a cache can save the second read;
// both 16-bit tensors of a UNet layer, 34 MB, fit the 50 MB L2, the f32 ones,
// 67 MB, do not). What the design does about it: two launches for both
// tensors together (blockIdx.y picks q or k, blockIdx.z the scale's segment:
// the tensor, or one batch row), 16 elements a thread at a time (two 16-byte
// loads, one 16-byte store; 8 at D = 24, the legacy UNet's attn_up2, whose
// rows are 48 bytes), grid-stride within the segment.
//   * Pass 1: |x| is the 16-bit pattern without its sign, and for finite
//     values patterns order like the numbers, so the maximum is taken on packed
//     pairs of patterns (__vmaxu2) with no conversion; a warp reduction, a
//     block reduction through shared memory, then one atomicMax a block on the
//     bits of the non-negative f32, which again order like the floats, into
//     the slot of its segment (and of q or k) (f32: the same on the 31-bit
//     magnitudes, one a word): a block never reads a group of
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
// where the chain of three small launches is most of the time. On f32 q and
// k (the same phase): 0.0643 ms at (4096, 64) against 0.2632
// ms eager and a bound of 0.0250 ms; 0.0304, 0.0148 and 0.0181 at (1024,
// 128), (1024, 32) and (4096, 16).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wcquant {

constexpr int kThreads = 256;
// G, the elements a thread takes at a time: 16 (two 16-byte loads of a 16-bit type, four of f32; one 16-byte
// store), or 8 where D is not a multiple of 16 (D = 24: half as many loads, one 8-byte store)
constexpr int kMaxBlocks = 1056;  // a tensor: 8 blocks an SM on 132 SMs, then grid-stride (half as many measured no faster)

// Element strides of the batch, head and row dimensions; d is contiguous.
struct Strides {
  long long b, h, n;
};

struct Shape {
  int h, n, d;
  long long groups;  // groups a segment: B * H * N * D / G over the segments
};

// Group i of G consecutive elements of one row, in (b, h, n, d) order.
template <int G, typename T>
__device__ __forceinline__ const T* group_ptr(const T* x, const Strides& st, const Shape& sh, long long i) {
  const int per_row = sh.d / G;
  const long long row = i / per_row;
  const int c = (int)(i % per_row);
  const long long bh = row / sh.n;
  return x + (bh / sh.h) * st.b + (bh % sh.h) * st.h + (row % sh.n) * st.n + c * G;
}

__device__ __forceinline__ float pattern_to_float(uint32_t bits16, __nv_bfloat16) {
  return __uint_as_float(bits16 << 16);
}
__device__ __forceinline__ float pattern_to_float(uint32_t bits16, __half) {
  return __half2float(__ushort_as_half((unsigned short)bits16));
}
__device__ __forceinline__ float pattern_to_float(uint32_t bits, float) { return __uint_as_float(bits); }

// amax_bits[z], amax_bits[S + z] (zero before the launch; S = gridDim.z segments) = the bits of segment z's
// max|q|, max|k| as f32.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    absmax_qk_kernel(const T* __restrict__ q, const T* __restrict__ k, Strides q_st, Strides k_st, Shape sh,
                     unsigned int* __restrict__ amax_bits) {
  __shared__ uint32_t warp_max[kThreads / 32];
  const T* x = blockIdx.y ? k : q;
  const Strides st = blockIdx.y ? k_st : q_st;
  const long long first = (long long)blockIdx.z * sh.groups, end = first + sh.groups;
  constexpr bool kF32 = sizeof(T) == 4;
  uint32_t m = 0;  // two running maxima of 15-bit magnitudes, packed (f32: one of the 31-bit magnitudes)
  for (long long i = first + (long long)blockIdx.x * kThreads + threadIdx.x; i < end;
       i += (long long)gridDim.x * kThreads) {
    const uint4* p = reinterpret_cast<const uint4*>(group_ptr<G>(x, st, sh, i));
#pragma unroll
    for (int c = 0; c < G * (int)sizeof(T) / 16; ++c) {
      const uint4 a = p[c];
      const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) m = kF32 ? max(m, w[j] & 0x7fffffffu) : __vmaxu2(m, w[j] & 0x7fff7fffu);
    }
  }
  uint32_t best = __reduce_max_sync(0xffffffffu, kF32 ? m : max(m & 0xffffu, m >> 16));
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

// Eight consecutive elements at p (one 16-byte load of a 16-bit type, two of f32) -> eight int8 values in two
// words, x / scale rounded half to even.
template <typename T>
__device__ __forceinline__ uint2 quantize8(const uint4* p, float scale) {
  float f[8];
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = x[i];
  } else {
    const uint4 v = p[0];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 pair = to_float2(w[j], T());
      f[2 * j] = pair.x;
      f[2 * j + 1] = pair.y;
    }
  }
  uint32_t out[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i / 4] |= ((uint32_t)__float2int_rn(__fdiv_rn(f[i], scale)) & 0xffu) << (8 * (i % 4));
  return make_uint2(out[0], out[1]);
}

template <typename T, int G>
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
    const uint4* p = reinterpret_cast<const uint4*>(group_ptr<G>(x, st, sh, i));
    const uint2 lo = quantize8<T>(p, scale);
    if constexpr (G == 16) {
      const uint2 hi = quantize8<T>(p + 8 * sizeof(T) / 16, scale);
      *reinterpret_cast<uint4*>(out + i * G) = make_uint4(lo.x, lo.y, hi.x, hi.y);
    } else {
      *reinterpret_cast<uint2*>(out + i * G) = lo;
    }
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* k, Strides q_st, Strides k_st, int b, int scales, Shape sh,
                   float* amax, int8_t* q8, int8_t* k8, float* qk_scale, float sqrt_d, cudaStream_t stream) {
  sh.groups = (long long)b * sh.h * sh.n * sh.d / G / scales;
  const long long want = (sh.groups + kThreads - 1) / kThreads, most = (kMaxBlocks + scales - 1) / scales;
  const dim3 grid((unsigned)(want < most ? want : most), 2, scales);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  absmax_qk_kernel<T, G><<<grid, kThreads, 0, stream>>>(qt, kt, q_st, k_st, sh, reinterpret_cast<unsigned int*>(amax));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_qk_kernel<T, G><<<grid, kThreads, 0, stream>>>(qt, kt, q_st, k_st, sh, amax, q8, k8, qk_scale,
                                                       sqrt_d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, Strides q_st, Strides k_st, int b, int scales, Shape sh,
                     float* amax, int8_t* q8, int8_t* k8, float* qk_scale, float sqrt_d, cudaStream_t stream) {
  return sh.d % 16 == 0 ? launch<T, 16>(q, k, q_st, k_st, b, scales, sh, amax, q8, k8, qk_scale, sqrt_d, stream)
                        : launch<T, 8>(q, k, q_st, k_st, b, scales, sh, amax, q8, k8, qk_scale, sqrt_d, stream);
}

}  // namespace wcquant

// q, k: (b, h, n, d) in bf16 (dtype 0), f16 (1) or f32 (2), d a multiple of
// 8 and contiguous, rows 16-byte aligned; q_strides, k_strides: the element
// strides of their b, h and n dimensions. scales: 1 (one scale per tensor) or
// b (one per batch row). amax: 2 * scales f32 on the device, zero (the maxima
// of q's segments, then k's, are left there); q8, k8: contiguous int8 (b, h,
// n, d); qk_scale: `scales` f32 on the device; sqrt_d: d^1/2 rounded to f32.
// Two launches. Returns the cudaError_t of the last.
extern "C" int wc_quantize_qk_i8(const void* q, const void* k, const long long* q_strides,
                                 const long long* k_strides, int b, int h, int n, int d, int dtype, int scales,
                                 float* amax, void* q8, void* k8, float* qk_scale, float sqrt_d, void* stream) {
  using namespace wcquant;
  if (b <= 0 || h <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || (scales != 1 && scales != b) || b > 65535 ||
      dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const Strides q_st{q_strides[0], q_strides[1], q_strides[2]}, k_st{k_strides[0], k_strides[1], k_strides[2]};
  const Shape sh{h, n, d, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* q8p = static_cast<int8_t*>(q8);
  int8_t* k8p = static_cast<int8_t*>(k8);
  if (dtype == 2) return launch_d<float>(q, k, q_st, k_st, b, scales, sh, amax, q8p, k8p, qk_scale, sqrt_d, s);
  return dtype == 1 ? launch_d<__half>(q, k, q_st, k_st, b, scales, sh, amax, q8p, k8p, qk_scale, sqrt_d, s)
                    : launch_d<__nv_bfloat16>(q, k, q_st, k_st, b, scales, sh, amax, q8p, k8p, qk_scale, sqrt_d, s);
}
