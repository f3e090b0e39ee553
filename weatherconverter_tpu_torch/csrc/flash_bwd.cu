// K3: clamped-softmax flash-attention backward, bf16/f16, for sm_90a.
//
// Replaces, in weatherconverter_tpu/ops/attention.py, the resident backward
// `_flash_attention_bwd_impl` (:645; kernels `_flash_bwd_kernel` :244 and
// `_flash_bwd_kernel_v2` :305) and the streaming backward
// `_flash_stream_bwd_impl` (:585; kernels `_flash_bwd_dq_kernel_stream` :533
// and `_flash_bwd_dkv_kernel_stream` :555). With s = Q K^T * scale,
// p = exp(clip(s, -60, 60)), l = row sum of p (from K1), Dv = rowsum(dO o O)
// and m = p o (dO V^T - Dv), zeroed where |s| > 60:
//   dQ = (m K) * scale / l,   dK = m^T (Q * scale / l),   dV = p^T (dO / l).
// The clamped softmax has no running max, so the resident and the streaming
// TPU forms are the same sum; one design serves both.
//
// What bounds it on the H100: per head it does five N x N x D tensor-core
// products (S and dO V^T twice, dQ, dK, dV: 10*N^2*D FLOPs) and 2*N^2
// exponentials, against about 9*N*D*2 bytes of Q/K/V/O/dO/dQ/dK/dV traffic.
// At N = 1024/4096 that is compute-bound: on the tensor cores at D >= 64,
// on the exp/mask/convert instructions at D = 16/32.
// What the design does about it:
//   * Two passes, each owning its outputs, so there are no atomics and the
//     gradients are deterministic. Pass 1 (grid N/64 x B*H) gives each warp
//     16 query rows, holds their Q and dO as A fragments, writes
//     Dv = rowsum(dO o O) to an f32 scratch, walks 64-key tiles and
//     accumulates m K in f32. Pass 2 (same grid) gives each warp 16 keys and
//     walks 64-query tiles; it computes the products transposed,
//     S^T = K Q^T and dpn^T = V dO^T, so p^T and m^T sit in the C layout
//     with keys as rows and pack straight into the A fragments of
//     dV += (p^T / l) dO and dK += (m^T / l) Q: nothing of size N^2 leaves
//     registers.
//   * 1/l is folded into p and m before they are cast to bf16/f16 (the TPU
//     kernels fold it into the D-wide operands instead): p / l <= 1, so f16
//     cannot overflow where the clamp lets p reach e^60.
//   * Scores are formed 16 keys (pass 1) or 16 queries (pass 2) at a time,
//     and in pass 2 the warp's K and V operands are read from shared memory
//     rather than held in registers, so at D = 128 the f32 dK and dV
//     accumulators (128 registers a thread) fit without spilling.
//   * B operands that run along the key (pass 1) or query (pass 2) axis are
//     staged transposed (stage_v_transposed), so each fragment is one
//     conflict-free 32-bit shared load, as in K1.
// Left for later: wgmma, TMA, cp.async pipelining, ldmatrix.trans instead of
// the transposed copies, and strided inputs (the wrapper makes them
// contiguous).
#include "flash_common.cuh"

namespace wcflash {

// Rows [r0, r0 + kBlockK) of one head into dst[kBlockK][D + kPad].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ head, int r0) {
  constexpr int kStride = D + kPad;
  constexpr int kVecPerRow = D / 8;
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int row = i / kVecPerRow;
    const int col = (i % kVecPerRow) * 8;
    *reinterpret_cast<uint4*>(dst + row * kStride + col) =
        *reinterpret_cast<const uint4*>(head + (size_t)r0 * D + (size_t)row * D + col);
  }
}

// A fragment (16 rows x 16-deep chunk kc) of a row-major array with `stride`.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* rows, int stride, int kc, int g, int t) {
  a[0] = ld32(rows + g * stride + kc * 16 + 2 * t);
  a[1] = ld32(rows + (g + 8) * stride + kc * 16 + 2 * t);
  a[2] = ld32(rows + g * stride + kc * 16 + 8 + 2 * t);
  a[3] = ld32(rows + (g + 8) * stride + kc * 16 + 8 + 2 * t);
}

// c[j] (16 x 8, C layout) += rows (A, 16 x D) . b_rows[j*8 .. j*8+8)^T for
// j = 0, 1, where b_rows is row-major [.][D + kPad] in shared memory.
template <typename T, int D, bool kAInRegs>
__device__ __forceinline__ void mma_rows_t(float c[2][4], const uint32_t a_regs[][4], const T* a_rows,
                                           const T* b_rows, int g, int t) {
  constexpr int kStride = D + kPad;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const T* brow = b_rows + (j * 8 + g) * kStride + 2 * t;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint32_t b[2] = {ld32(brow + kc * 16), ld32(brow + kc * 16 + 8)};
      if constexpr (kAInRegs) {
        Mma<T>::run(c[j], a_regs[kc], b);
      } else {
        uint32_t a[4];
        load_a(a, a_rows, kStride, kc, g, t);
        Mma<T>::run(c[j], a, b);
      }
    }
  }
}

// Pack two C-layout 16 x 8 tiles into one A fragment (16 x 16-deep chunk).
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t a[4], const float x[2][4]) {
  a[0] = Mma<T>::pack(x[0][0], x[0][1]);
  a[1] = Mma<T>::pack(x[0][2], x[0][3]);
  a[2] = Mma<T>::pack(x[1][0], x[1][1]);
  a[3] = Mma<T>::pack(x[1][2], x[1][3]);
}

// acc[nt] (16 x D, C layout) += a (16 x 16-deep chunk kc) . bt^T chunk, where
// bt is [D][kVtStride]: the 16-deep operand staged transposed.
template <typename T, int D>
__device__ __forceinline__ void mma_chunk(float acc[D / 8][4], const uint32_t a[4], const T* bt, int kc, int g,
                                          int t) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const T* col = bt + (nt * 8 + g) * kVtStride + kc * 16 + 2 * t;
    const uint32_t b[2] = {ld32(col), ld32(col + 8)};
    Mma<T>::run(acc[nt], a, b);
  }
}

// Write acc * mul (16 x D, C layout) as T rows of `rows` (row stride D).
template <typename T, int D>
__device__ __forceinline__ void write_rows(T* __restrict__ rows, const float acc[D / 8][4], float mul, int g,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(rows + g * D + col) = Mma<T>::pack(acc[nt][0] * mul, acc[nt][1] * mul);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * D + col) = Mma<T>::pack(acc[nt][2] * mul, acc[nt][3] * mul);
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(uint16_t) * (2 * kBlockK * (D + kPad) + D * kVtStride);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(uint16_t) * (4 * kBlockK * (D + kPad) + 2 * D * kVtStride) + sizeof(float) * 2 * kBlockQ;
}

// Pass 1: dQ, and Dv = rowsum(dO o O) into dvec (bh, n) f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ o, const T* __restrict__ d_o, const float* __restrict__ l,
                        T* __restrict__ dq, float* __restrict__ dvec, int n, float scale) {
  constexpr int kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [kBlockK][kStride]
  T* vs = ks + kBlockK * kStride;           // [kBlockK][kStride]
  T* kt = vs + kBlockK * kStride;           // [D][kVtStride]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row0 = blockIdx.x * kBlockQ + warp * 16;
  const size_t rows = (size_t)blockIdx.y * n + row0;  // index into l and dvec

  // This warp's Q and dO rows as A fragments, and Dv of its rows g and g+8.
  uint32_t qa[D / 16][4], da[D / 16][4];
  float dv[2] = {0.f, 0.f};
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    load_a(qa[kc], q + head + (size_t)row0 * D, D, kc, g, t);
    load_a(da[kc], d_o + head + (size_t)row0 * D, D, kc, g, t);
    uint32_t oa[4];
    load_a(oa, o + head + (size_t)row0 * D, D, kc, g, t);
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // r = 0, 2: row g; r = 1, 3: row g + 8
      const float2 x = Mma<T>::unpack(da[kc][r]), y = Mma<T>::unpack(oa[r]);
      dv[r & 1] += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dv[r] += __shfl_xor_sync(0xffffffffu, dv[r], 1);
    dv[r] += __shfl_xor_sync(0xffffffffu, dv[r], 2);
  }
  if (t == 0) {
    dvec[rows + g] = dv[0];
    dvec[rows + g + 8] = dv[1];
  }
  const float linv[2] = {1.f / l[rows + g], 1.f / l[rows + g + 8]};

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<T, D>(ks, k + head, k0);
    stage_rows<T, D>(vs, v + head, k0);
    stage_v_transposed<T, D>(kt, k + head, k0);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kBlockK / 16; ++kc) {  // 16 keys at a time
      float s[2][4], dp[2][4];
      mma_rows_t<T, D, true>(s, qa, nullptr, ks + kc * 16 * kStride, g, t);
      mma_rows_t<T, D, true>(dp, da, nullptr, vs + kc * 16 * kStride, g, t);
      float m[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e] * scale;
          const float p = __expf(fminf(fmaxf(x, -kClamp), kClamp));
          m[j][e] = fabsf(x) <= kClamp ? p * (dp[j][e] - dv[e >> 1]) * linv[e >> 1] : 0.f;
        }
      }
      uint32_t a[4];
      pack_a<T>(a, m);
      mma_chunk<T, D>(acc, a, kt, kc, g, t);
    }
  }
  write_rows<T, D>(dq + head + (size_t)row0 * D, acc, scale, g, t);
}

// Pass 2: dK and dV. Reads l from K1 and Dv from pass 1.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const T* __restrict__ d_o, const float* __restrict__ l, const float* __restrict__ dvec,
                         T* __restrict__ dk, T* __restrict__ dv, int n, float scale) {
  constexpr int kStride = D + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kBlockQ][kStride] query tile
  T* dos = qs + kBlockQ * kStride;          // [kBlockQ][kStride] dO tile
  T* kown = dos + kBlockQ * kStride;        // [kBlockK][kStride] this block's keys
  T* vown = kown + kBlockK * kStride;       // [kBlockK][kStride]
  T* qt = vown + kBlockK * kStride;         // [D][kVtStride] query tile, transposed
  T* dot = qt + D * kVtStride;              // [D][kVtStride] dO tile, transposed
  float* lis = reinterpret_cast<float*>(dot + D * kVtStride);  // [kBlockQ] 1/l
  float* dvs = lis + kBlockQ;                                   // [kBlockQ] Dv

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const size_t head_rows = (size_t)blockIdx.y * n;
  const int key0 = blockIdx.x * kBlockK;

  stage_rows<T, D>(kown, k + head, key0);
  stage_rows<T, D>(vown, v + head, key0);
  const T* kw = kown + warp * 16 * kStride;
  const T* vw = vown + warp * 16 * kStride;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += kBlockQ) {
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<T, D>(qs, q + head, q0);
    stage_rows<T, D>(dos, d_o + head, q0);
    stage_v_transposed<T, D>(qt, q + head, q0);
    stage_v_transposed<T, D>(dot, d_o + head, q0);
    if (threadIdx.x < kBlockQ) {
      lis[threadIdx.x] = 1.f / l[head_rows + q0 + threadIdx.x];
      dvs[threadIdx.x] = dvec[head_rows + q0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll
    for (int qc = 0; qc < kBlockQ / 16; ++qc) {  // 16 queries at a time
      float s[2][4], dp[2][4];
      mma_rows_t<T, D, false>(s, nullptr, kw, qs + qc * 16 * kStride, g, t);
      mma_rows_t<T, D, false>(dp, nullptr, vw, dos + qc * 16 * kStride, g, t);
      float pl[2][4], ml[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = qc * 16 + j * 8 + 2 * t + (e & 1);  // C column = query
          const float x = s[j][e] * scale;
          const float p = __expf(fminf(fmaxf(x, -kClamp), kClamp)) * lis[qi];
          pl[j][e] = p;
          ml[j][e] = fabsf(x) <= kClamp ? p * (dp[j][e] - dvs[qi]) : 0.f;
        }
      }
      uint32_t a[4];
      pack_a<T>(a, pl);
      mma_chunk<T, D>(dv_acc, a, dot, qc, g, t);
      pack_a<T>(a, ml);
      mma_chunk<T, D>(dk_acc, a, qt, qc, g, t);
    }
  }
  const size_t out = head + (size_t)(key0 + warp * 16) * D;
  write_rows<T, D>(dk + out, dk_acc, scale, g, t);
  write_rows<T, D>(dv + out, dv_acc, 1.f, g, t);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                       const float* l, void* dq, void* dk, void* dv, float* dvec, int bh, int n, float scale,
                       cudaStream_t stream) {
  const dim3 grid(n / kBlockQ, bh);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(d_o);
  constexpr size_t smem1 = dq_smem_bytes<D>(), smem2 = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem1, stream>>>(q_, k_, v_, static_cast<const T*>(o), do_, l,
                                                               static_cast<T*>(dq), dvec, n, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem2, stream>>>(q_, k_, v_, do_, l, dvec, static_cast<T*>(dk),
                                                                static_cast<T*>(dv), n, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                         const float* l, void* dq, void* dk, void* dv, float* dvec, int bh, int n, int d,
                         float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, stream);
    case 32: return launch_bwd<T, 32>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, stream);
    case 64: return launch_bwd<T, 64>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, stream);
    case 128: return launch_bwd<T, 128>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wcflash

// q, k, v, o, d_o, dq, dk, dv: contiguous (bh, n, d) in bf16 (is_f16 = 0) or
// f16 (is_f16 = 1). l: f32 (bh, n), the forward's row sums. dvec: f32 (bh, n)
// scratch for Dv, written by pass 1 and read by pass 2. Returns the
// cudaError_t of the launches.
extern "C" int wc_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                            const float* l, void* dq, void* dk, void* dv, float* dvec, int bh, int n, int d,
                            int is_f16, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kBlockQ != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcflash::dispatch_bwd<__half>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, d, scale, s)
                : wcflash::dispatch_bwd<__nv_bfloat16>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, d, scale, s);
}
