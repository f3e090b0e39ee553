// The int8 quantizer of Q and K in front of K2 (flash_fwd_qk_i8.cu) and
// K2-f32 (flash_fwd_f32.cu), with one scale per tensor or one per batch row,
// for sm_90a.
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
// What bounds it: bytes, each input read once and each int8 output written
// once, 3 bytes an element in 16 bits and 5 in f32. But the maximum must be
// known before the first int8 byte is written, so a plain two-pass form
// reads every input twice (5 and 9 bytes an element), and at the UNet's
// shapes (4-34 MB of q and k in 16 bits) a chain of launches (a fill of the
// maxima and two kernels: the design this one replaced) costs as much as the
// bytes. What the design does about it:
//   * One cooperative launch (cudaLaunchCooperativeKernel) for q and k
//     together, its grid the blocks that are resident at once (the occupancy
//     API's blocks an SM times the SMs, two blocks of 384 threads an SM).
//     The work is cut into segments, one a scale (q's and k's whole tensor,
//     or each of their batch rows), each segment into `bps` equal ranges of
//     16-byte chunks (8 elements of a 16-bit type, 4 of f32; chunks in
//     (b, h, n, d) order), a range a block.
//   * Pass 1: a block reads its range once and keeps what it read on chip:
//     each thread's first kKeepRegs chunks in registers, its next ones in
//     kKeepSmemBytes of shared memory, copied there by 16-byte cp.async, all
//     in flight at once (35 MB over the card's 264 blocks: q and k at
//     (8, 4, 4096, 64) in bf16, 33.5 MB, fit); what does not fit is read
//     kBatch loads at a time, and again in pass 2 (from L2 where the tensors
//     fit its 50 MB). |x| is the 16-bit pattern without its sign, and for
//     non-negative values patterns order like the numbers, so the maximum is
//     taken on packed pairs of patterns (__vmaxu2) with no conversion (f32:
//     on the 31-bit magnitudes, one a word); a warp reduction, a block
//     reduction through shared memory, and the block writes the f32 bits of
//     its range's maximum into its own slot of a scratch array. Every slot
//     is written on every call, so nothing is zero-filled first, and no
//     atomics are used.
//   * A grid-wide barrier (cooperative groups' grid sync).
//   * Pass 2: one warp of each block reduces the slots of its segment (and
//     another, in the first block of each of q's segments, those of k's, for
//     qk_scale), the block builds the scale and quantizes its range from
//     what it kept, re-reading only what did not fit. A maximum is the same
//     in any order, so two calls give the same bits. An infinity's pattern
//     lies above every finite one and a NaN's above that, so a non-finite
//     element becomes the maximum and reaches qk_scale (inf or NaN) as it
//     does in the plain version, instead of being quantized silently.
//   * The division by the scale is a multiply by its rounded reciprocal,
//     rounded to an integer by adding 1.5 * 2^23 (the int8 value is then
//     the sum's low byte), taken where every product of a chunk lies
//     farther than 2^-13 from a half-integer (each is within 1.25 * 2^-16 of
//     the correctly rounded quotient, so both round to the same integer);
//     elsewhere, and where one is not finite, __fdiv_rn and __float2int_rn
//     decide for the chunk, as the plain version's division would. The
//     correctly rounded division is ~15 instructions, the conversions run
//     at a quarter of the rate, and a branch an element costs as much
//     again: pass 2 took 4x its bytes' time with a branch an element
//     (probes/bwd_wide_ablations.py, PERF.md section 6).
// It equals the plain PyTorch version bit for bit: the integer of the
// correctly rounded quotient, __float2int_rn (half to even), the scale
// arithmetic in the plain version's order (__fdiv_rn); the build has no
// -use_fast_math.
// The inputs may be strided views (the UNet hands head-split slices of one
// projection): any (B, H, N) strides that keep rows of D contiguous and
// 16-byte aligned; the outputs are contiguous.
// Not folded into K2 or into the projection's epilogue: each K2 block
// quantizing the K tiles it walks would redo every K tile N/64 times, and
// either way the maximum has to be known before the first byte is written,
// which takes a pass over the whole tensor first.
// Times (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6 has them beside the
// two-launch design's, probes/time_flash.py): see PERF.md.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace wcquant {

constexpr int kThreads = 384;  // two blocks an SM: 85 registers a thread (64 at 512 spilled in bf16)
constexpr int kBlocksPerSm = 2;
constexpr int kKeepRegs = 4;                 // chunks a thread keeps in registers between the passes
constexpr int kKeepSmemBytes = 110 * 1024;   // and those a block keeps in shared memory after them
constexpr int kBatch = 4;                    // loads a thread issues at once where nothing is kept
constexpr int kMaxDevices = 64;

// Element strides of the batch, head and row dimensions; d is contiguous.
struct Strides {
  long long b, h, n;
};

// x / d for x < 2^31 by a multiply and a shift (the divisor's magic number, found on the host): three of them
// a chunk turn its index into an address, where 64-bit divisions would cost more than the chunk's bytes.
struct FastDiv {
  uint32_t d, mul, shr;
  __device__ __forceinline__ uint32_t operator()(uint32_t x) const { return d == 1 ? x : __umulhi(x, mul) >> shr; }
};

inline FastDiv fast_div(uint32_t d) {
  if (d == 1) return FastDiv{1u, 0u, 0u};
  int p = 31;
  while ((1u << (p - 31)) < d) ++p;  // 31 + ceil(log2 d)
  return FastDiv{d, (uint32_t)(((1ull << p) + d - 1) / d), (uint32_t)(p - 32)};
}

// How the chunks are cut: a tensor is `scales` segments of `cps` chunks, each segment `bps` ranges; the virtual
// blocks (q's segments' ranges, then k's) number 2 * scales * bps. A tensor's chunks are fewer than 2^31.
struct Work {
  FastDiv cpr, n, h;  // chunks a row, rows a head, heads
  uint32_t cps;
  int scales, bps;
};

template <typename T>
__device__ __forceinline__ const uint4* chunk_ptr(const T* x, const Strides& st, const Work& w, uint32_t i) {
  const uint32_t row = w.cpr(i), bh = w.n(row), b = w.h(bh);
  return reinterpret_cast<const uint4*>(x + b * st.b + (bh - b * w.h.d) * st.h + (row - bh * w.n.d) * st.n +
                                        (i - row * w.cpr.d) * (16 / sizeof(T)));
}

// The running maximum of |x| as patterns: two 15-bit magnitudes packed in a word, or one 31-bit one for f32.
template <typename T>
__device__ __forceinline__ uint32_t absmax_chunk(uint32_t m, uint4 a) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) m = sizeof(T) == 4 ? max(m, w[j] & 0x7fffffffu) : __vmaxu2(m, w[j] & 0x7fff7fffu);
  return m;
}

__device__ __forceinline__ float pattern_to_float(uint32_t bits16, __nv_bfloat16) {
  return __uint_as_float(bits16 << 16);
}
__device__ __forceinline__ float pattern_to_float(uint32_t bits16, __half) {
  return __half2float(__ushort_as_half((unsigned short)bits16));
}
__device__ __forceinline__ float pattern_to_float(uint32_t bits, float) { return __uint_as_float(bits); }

// The maximum of `m` over the block, as every thread's return value. `scratch`: kThreads / 32 words.
__device__ __forceinline__ uint32_t block_max(uint32_t m, uint32_t* scratch) {
  m = __reduce_max_sync(0xffffffffu, m);
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = m;
  __syncthreads();
  uint32_t best = scratch[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) best = max(best, scratch[w]);
  __syncthreads();  // scratch is free again
  return best;
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

// x / scale rounded half to even for a chunk's kN elements, as words whose low bytes are the int8 values, from
// rcp = 1 / scale rounded. q = x rcp lies within 1.25 * 2^-16 of the correctly rounded quotient (|x / scale| <=
// 127 (1 + 2^-24) here), so where every q of the chunk lies farther than 2^-13 from a half-integer each rounds
// to the quotient's integer, which q + 1.5 * 2^23 holds in its low bits (rounded half to even by the add). Else
// (one chunk in ~250 on N(0, 1) data), or where a q is not finite, the correctly rounded quotients decide
// (__fdiv_rn, the plain version's division). The same bits as __fdiv_rn alone; one branch a chunk.
template <int kN>
__device__ __forceinline__ void round_i8(const float (&x)[kN], float scale, float rcp, uint32_t (&r)[kN]) {
  constexpr float kMagic = 0x1.8p23f;
  bool near = false;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float q = __fmul_rn(x[i], rcp);
    const float t = __fadd_rn(q, kMagic);
    near |= !(fabsf(__fsub_rn(q, __fsub_rn(t, kMagic))) < 0.5f - 0x1p-13f);
    r[i] = __float_as_uint(t);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < kN; ++i) r[i] = (uint32_t)__float2int_rn(__fdiv_rn(x[i], scale));
  }
}

// The low bytes of four words, packed.
__device__ __forceinline__ uint32_t pack_i8(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// One chunk to `out`: eight int8 values (two words) of a 16-bit type, four (one word) of f32.
template <typename T>
__device__ __forceinline__ void quantize_chunk(uint4 a, float scale, float rcp, int8_t* out) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  if constexpr (sizeof(T) == 4) {
    const float x[4] = {__uint_as_float(w[0]), __uint_as_float(w[1]), __uint_as_float(w[2]), __uint_as_float(w[3])};
    uint32_t r[4];
    round_i8(x, scale, rcp, r);
    *reinterpret_cast<uint32_t*>(out) = pack_i8(r[0], r[1], r[2], r[3]);
  } else {
    float x[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 pair = to_float2(w[j], T());
      x[2 * j] = pair.x;
      x[2 * j + 1] = pair.y;
    }
    uint32_t r[8];
    round_i8(x, scale, rcp, r);
    *reinterpret_cast<uint2*>(out) = make_uint2(pack_i8(r[0], r[1], r[2], r[3]), pack_i8(r[4], r[5], r[6], r[7]));
  }
}

__device__ __forceinline__ void cp_async16(uint4* dst, const uint4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The first chunk of range j of row z's segment (j = bps: the segment's end).
__device__ __forceinline__ uint32_t range_start(const Work& w, int z, int j) {
  return (uint32_t)((unsigned long long)w.cps * z + (unsigned long long)w.cps * j / w.bps);
}

// m and the maximum |x| of this thread's chunks i, i + kThreads, ... below hi, read kBatch at a time.
template <typename T>
__device__ __forceinline__ uint32_t stream_max(const T* x, const Strides& st, const Work& w, uint32_t i, uint32_t hi,
                                               uint32_t m) {
  for (; i < hi; i += kBatch * kThreads) {
    uint4 a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i + u * kThreads < hi) a[u] = *chunk_ptr(x, st, w, i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i + u * kThreads < hi) m = absmax_chunk<T>(m, a[u]);
  }
  return m;
}

// The same chunks quantized to `out` (the tensor's contiguous int8 copy).
template <typename T>
__device__ __forceinline__ void stream_quantize(const T* x, const Strides& st, const Work& w, uint32_t i,
                                                uint32_t hi, float scale, float rcp, int8_t* out) {
  constexpr int kEpc = 16 / sizeof(T);
  for (; i < hi; i += kBatch * kThreads) {
    uint4 a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i + u * kThreads < hi) a[u] = *chunk_ptr(x, st, w, i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i + u * kThreads < hi) quantize_chunk<T>(a[u], scale, rcp, out + (size_t)(i + u * kThreads) * kEpc);
  }
}

// The maxima (f32 bits) of segments `seg` and `other` (-1: none) from their bps slots, warp 0 and warp 1 each
// reducing one; every thread of the block returns them.
__device__ __forceinline__ float2 segment_maxima(const uint32_t* slots, int bps, int seg, int other,
                                                 uint32_t* shared2) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < 2) {
    const int which = warp == 0 ? seg : other;
    uint32_t m = 0u;
    if (which >= 0) {
#pragma unroll 4
      for (int i = lane; i < bps; i += 32) m = max(m, __ldcg(slots + (size_t)which * bps + i));
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) shared2[warp] = m;
  }
  __syncthreads();
  const float2 got = make_float2(__uint_as_float(shared2[0]), __uint_as_float(shared2[1]));
  __syncthreads();  // shared2 is free again
  return got;
}

// q8, k8 (contiguous int8) and qk_scale[scales] from q and k; slots: 2 * scales * bps words of scratch, each
// written in pass 1. One block a virtual block while there are no more of them than blocks (only the first
// virtual block of a block is kept on chip: a thread's first kKeepRegs chunks in registers, its next
// keep_chunks / kThreads in shared memory, copied there by cp.async, every copy in flight at once).
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    quantize_qk_kernel(const T* __restrict__ q, const T* __restrict__ k, Strides q_st, Strides k_st, Work w,
                       uint32_t* slots, int8_t* __restrict__ q8, int8_t* __restrict__ k8,
                       float* __restrict__ qk_scale, float sqrt_d, int keep_chunks) {
  extern __shared__ uint4 kept[];  // chunk c of a thread's kept ones at kept[c * kThreads + tid]
  __shared__ uint32_t scratch[kThreads / 32];
  constexpr int kEpc = 16 / sizeof(T);  // elements a chunk
  const int virt = 2 * w.scales * w.bps;
  const int tid = threadIdx.x;
  const uint32_t kept_a_thread = keep_chunks / kThreads;
  uint4 reg[kKeepRegs > 0 ? kKeepRegs : 1];

  for (int vb = blockIdx.x; vb < virt; vb += gridDim.x) {
    const int seg = vb / w.bps, tensor = seg / w.scales;
    const uint32_t lo = range_start(w, seg % w.scales, vb % w.bps), hi = range_start(w, seg % w.scales, vb % w.bps + 1);
    const T* x = tensor ? k : q;
    const Strides st = tensor ? k_st : q_st;
    uint32_t m = 0u, i = lo + tid;
    if (vb == (int)blockIdx.x) {  // kept on chip
#pragma unroll
      for (int r = 0; r < kKeepRegs; ++r)
        if (i + r * kThreads < hi) reg[r] = *chunk_ptr(x, st, w, i + r * kThreads);
      i += kKeepRegs * kThreads;
      for (uint32_t c = 0; c < kept_a_thread && i < hi; ++c, i += kThreads)
        cp_async16(kept + c * kThreads + tid, chunk_ptr(x, st, w, i));
      asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll
      for (int r = 0; r < kKeepRegs; ++r)
        if (lo + tid + r * kThreads < hi) m = absmax_chunk<T>(m, reg[r]);
      m = stream_max(x, st, w, i, hi, m);  // what does not fit
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      for (uint32_t c = 0, j = lo + tid + kKeepRegs * kThreads; c < kept_a_thread && j < hi; ++c, j += kThreads)
        m = absmax_chunk<T>(m, kept[c * kThreads + tid]);
    } else {
      m = stream_max(x, st, w, i, hi, m);
    }
    if constexpr (sizeof(T) == 2) m = max(m & 0xffffu, m >> 16);
    m = block_max(m, scratch);
    if (tid == 0) slots[vb] = __float_as_uint(pattern_to_float(m, T()));
  }

  cooperative_groups::this_grid().sync();

  for (int vb = blockIdx.x; vb < virt; vb += gridDim.x) {
    const int seg = vb / w.bps, tensor = seg / w.scales, z = seg % w.scales, j = vb % w.bps;
    const uint32_t lo = range_start(w, z, j), hi = range_start(w, z, j + 1);
    const T* x = tensor ? k : q;
    const Strides st = tensor ? k_st : q_st;
    int8_t* out = tensor ? k8 : q8;
    const bool scores = tensor == 0 && j == 0;  // q's first range of row z: the score scale of row z
    const float2 amax = segment_maxima(slots, w.bps, seg, scores ? w.scales + z : -1, scratch);
    const float scale = tensor_scale(amax.x), rcp = __frcp_rn(scale);
    if (scores && tid == 0) qk_scale[z] = __fdiv_rn(__fmul_rn(scale, tensor_scale(amax.y)), sqrt_d);
    uint32_t i = lo + tid;
    if (vb == (int)blockIdx.x) {
#pragma unroll
      for (int r = 0; r < kKeepRegs; ++r)
        if (i + r * kThreads < hi) quantize_chunk<T>(reg[r], scale, rcp, out + (size_t)(i + r * kThreads) * kEpc);
      i += kKeepRegs * kThreads;
      for (uint32_t c = 0; c < kept_a_thread && i < hi; ++c, i += kThreads)
        quantize_chunk<T>(kept[c * kThreads + tid], scale, rcp, out + (size_t)i * kEpc);
    }
    stream_quantize(x, st, w, i, hi, scale, rcp, out);
  }
}

// The kernel's resident blocks on each device, found at its first call there (0: not yet), one row a dtype
// (bf16, f16, f32). A namespace-scope static: a function-local static of a template would be one object for
// every copy of this library in a process (a unique global symbol), and a second copy, as the probes load,
// would skip its own cudaFuncSetAttribute.
static std::atomic<int> resident_cache[3][kMaxDevices];

template <typename T>
constexpr int dtype_row() {
  return sizeof(T) == 4 ? 2 : std::is_same<T, __half>::value ? 1 : 0;
}

template <typename T>
cudaError_t resident_blocks(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::atomic<int>& known = resident_cache[dtype_row<T>()][dev];
  *blocks = known.load();
  if (*blocks > 0) return cudaSuccess;
  err = cudaFuncSetAttribute(quantize_qk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kKeepSmemBytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_qk_kernel<T>, kThreads, kKeepSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  known.store(*blocks);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, Strides q_st, Strides k_st, int b, int h, int n, int d, int scales,
                   uint32_t* slots, int nslots, int8_t* q8, int8_t* k8, float* qk_scale, float sqrt_d,
                   cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = resident_blocks<T>(&resident);
  if (err != cudaSuccess) return err;
  const int cpr = d * (int)sizeof(T) / 16;
  const long long chunks = (long long)b * h * n * cpr;  // a tensor's
  if (chunks >= (1ll << 31)) return cudaErrorInvalidValue;
  const int segments = 2 * scales;
  const long long cps = chunks / scales, useful = (cps + kThreads - 1) / kThreads;  // ranges of a chunk a thread
  long long bps = resident / segments;
  bps = bps < 1 ? 1 : bps > useful ? useful : bps;
  Work w{fast_div(cpr), fast_div(n), fast_div(h), (uint32_t)cps, scales, (int)bps};
  const long long virt = (long long)segments * bps;
  if (virt > nslots) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(virt < resident ? virt : resident);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  int keep = kKeepSmemBytes / 16;
  void* args[] = {&qt, &kt, &q_st, &k_st, &w, &slots, &q8, &k8, &qk_scale, &sqrt_d, &keep};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(quantize_qk_kernel<T>), dim3(grid), dim3(kThreads),
                                    args, kKeepSmemBytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wcquant

// q, k: (b, h, n, d) in bf16 (dtype 0), f16 (1) or f32 (2), d a multiple of
// 8 and contiguous, rows 16-byte aligned; q_strides, k_strides: the element
// strides of their b, h and n dimensions. scales: 1 (one scale per tensor) or
// b (one per batch row). slots: `nslots` words of scratch on the device
// (uninitialised; at least 2 * scales and the kernel's resident blocks);
// q8, k8: contiguous int8 (b, h, n, d); qk_scale: `scales` f32 on the device;
// sqrt_d: d^1/2 rounded to f32. One cooperative launch. Returns its
// cudaError_t.
extern "C" int wc_quantize_qk_i8(const void* q, const void* k, const long long* q_strides,
                                 const long long* k_strides, int b, int h, int n, int d, int dtype, int scales,
                                 void* slots, int nslots, void* q8, void* k8, float* qk_scale, float sqrt_d,
                                 void* stream) {
  using namespace wcquant;
  if (b <= 0 || h <= 0 || n <= 0 || d <= 0 || d % 8 != 0 || (scales != 1 && scales != b) || dtype < 0 || dtype > 2)
    return cudaErrorInvalidValue;
  const Strides q_st{q_strides[0], q_strides[1], q_strides[2]}, k_st{k_strides[0], k_strides[1], k_strides[2]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* sl = static_cast<uint32_t*>(slots);
  int8_t* q8p = static_cast<int8_t*>(q8);
  int8_t* k8p = static_cast<int8_t*>(k8);
  if (dtype == 2) return launch<float>(q, k, q_st, k_st, b, h, n, d, scales, sl, nslots, q8p, k8p, qk_scale, sqrt_d, s);
  return dtype == 1
             ? launch<__half>(q, k, q_st, k_st, b, h, n, d, scales, sl, nslots, q8p, k8p, qk_scale, sqrt_d, s)
             : launch<__nv_bfloat16>(q, k, q_st, k_st, b, h, n, d, scales, sl, nslots, q8p, k8p, qk_scale, sqrt_d, s);
}
