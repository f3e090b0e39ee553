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
// What bounds it on the H100: a backward needs five N x N x D tensor-core
// products a head (10*N^2*D FLOPs) and p once a score (N^2 exponentials),
// against about 8*N*D*2 bytes of traffic; this two-pass form spends seven
// products (S and dO V^T twice) and 2*N^2 exponentials against that bound
// of five and N^2. At N = 1024/4096 that is compute-bound: on the tensor cores at
// D >= 64, on the exp/mask/convert instructions at D = 16/32.
// What the design does about it (flash_wgmma.cuh has the building blocks):
//   * Two passes, each owning its outputs, so there are no atomics and the
//     gradients repeat bit for bit. Pass 1 (one warpgroup a block, 64 query
//     rows) keeps its Q and dO tiles in shared memory, writes Dv and 1/l to
//     an f32 scratch, walks 64-key K/V tiles and accumulates m K in f32.
//     Pass 2 (64 keys a block) walks 64-query tiles of Q, dO, 1/l and Dv
//     and takes the products transposed, S^T = K Q^T and dP^T = V dO^T, so
//     p^T and m^T come out with keys as rows.
//   * All seven products run on wgmma. S, dO V^T and their transposes take
//     both operands from shared memory (K-major). m K, p^T dO and m^T Q take
//     m, p^T and m^T from the registers the first products left them in and
//     the K, dO and Q tiles as loaded (MN-major descriptors): no operand is
//     staged transposed, nothing of size N^2 leaves registers.
//   * The streamed tiles come through a ring (three deep; two at D >= 128)
//     filled by 16-byte cp.async into the tensor cores' swizzled layout.
//   * The recomputed p uses K1's exp2 form; the mask is taken on the score
//     before the clamp. 1/l is folded into p and m before they are cast to
//     bf16/f16 (the TPU kernels fold it into the D-wide operands instead):
//     p / l <= 1, so f16 cannot overflow where the clamp lets p reach e^60.
//   * At D = 128 pass 2 forms its scores 32 queries at a time, so the f32 dK
//     and dV (128 registers a thread) fit without spilling.
//   * At D = 192 (three 64-column panels a tile) dK and dV together would be
//     192 accumulator registers a thread, before S and dP: they cannot share
//     a thread's 255. Pass 2 is launched twice there, once for dV (S^T and
//     p^T dO: three products' worth of work) and once for dK (S^T, dP^T and
//     m^T Q), each with 96 accumulators; S^T is formed twice, so the backward
//     spends eight products where the other head dims spend seven. Pass 1
//     forms its scores 32 keys at a time there (96 + 16 + 16 registers of
//     accumulators). A simple design that is right; two warpgroups sharing
//     one block's tiles, one for dK and one for dV, would save the second
//     S^T and half the tile traffic.
//   * One warpgroup a block: two sharing a ring measured 7 % slower at
//     D = 64 and no faster elsewhere.
// Left for later: overlapping the exp/mask work with the MMAs inside a
// warpgroup (splitting S and dO V^T into two MMA groups measured no gain and
// cost registers), TMA, and strided inputs (the wrapper makes them
// contiguous).
#include "flash_wgmma.cuh"

namespace wcflash {

// A fragment (16 rows x 16-deep chunk kc) of a row-major array with `stride`.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* rows, int stride, int kc, int g, int t) {
  a[0] = ld32(rows + g * stride + kc * 16 + 2 * t);
  a[1] = ld32(rows + (g + 8) * stride + kc * 16 + 2 * t);
  a[2] = ld32(rows + g * stride + kc * 16 + 8 + 2 * t);
  a[3] = ld32(rows + (g + 8) * stride + kc * 16 + 8 + 2 * t);
}

template <int D>
struct BwdConfig {
  // D = 128: two stages, so two blocks fit an SM, and 32-query sub-tiles in
  // pass 2, so the f32 dK and dV (128 registers a thread) do not spill.
  // D = 192: the same, 32-key sub-tiles in pass 1 as well, and pass 2 split
  // into a dV launch and a dK launch (96 accumulator registers each).
  static constexpr int kStages = D >= 128 ? 2 : 3;
  static constexpr int kSub = D >= 128 ? 32 : 64;
  static constexpr int kSubDq = D > 128 ? 32 : 64;
  static constexpr bool kSplitDkv = D > 128;
  static constexpr int kDqSmemBytes = 1024 + (2 + kStages * 2) * Tile<D>::kBytes;
  static constexpr int kDkvSmemBytes = kDqSmemBytes + kStages * 2 * kTileRows * 4;
};

// exp2-domain score y -> p = exp2(clip(y)), and whether the clamp left it alone
__device__ __forceinline__ float clamped_exp2(float y, bool& inside) {
  inside = fabsf(y) <= kClampLog2;
  return ex2_ftz(fminf(fmaxf(y, -kClampLog2), kClampLog2));
}

// Pass 1: dQ for 64 query rows a block (one warpgroup), walking 64-key K/V tiles; also
// writes Dv = rowsum(dO o O) and 1/l of its rows to the f32 scratch.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dq_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const T* __restrict__ o, const T* __restrict__ d_o, const float* __restrict__ l,
                              T* __restrict__ dq, float* __restrict__ dvec, float* __restrict__ linv_out, int n,
                              float scale, float scale_log2) {
  using L = Tile<D>;
  constexpr int kStages = BwdConfig<D>::kStages;
  constexpr int kSub = BwdConfig<D>::kSubDq;
  constexpr int kTileBytes = L::kBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [64][D]
  const uint32_t do_s = q_s + kTileBytes;                       // [64][D]
  const uint32_t kv_s = do_s + kTileBytes;                      // kStages x (K tile, V tile)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row0 = blockIdx.x * kTileRows;
  const T* k_head = k + head;
  const T* v_head = v + head;
  const int tiles = n / kTileRows;

  load_tile_async<T, D>(q_s, q + head + (size_t)row0 * D, tid);
  load_tile_async<T, D>(do_s, d_o + head + (size_t)row0 * D, tid);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) {
      load_tile_async<T, D>(kv_s + j * 2 * kTileBytes, k_head + (size_t)j * kTileRows * D, tid);
      load_tile_async<T, D>(kv_s + j * 2 * kTileBytes + kTileBytes, v_head + (size_t)j * kTileRows * D, tid);
    }
    cp_async_commit();
  }

  // Dv and 1/l of this thread's rows g and g + 8 of its warp's 16
  const int warp_row0 = row0 + warp * 16;
  const size_t rows = (size_t)blockIdx.y * n + warp_row0;
  float dvr[2] = {0.f, 0.f};
  {
    const T* do_rows = d_o + head + (size_t)warp_row0 * D;
    const T* o_rows = o + head + (size_t)warp_row0 * D;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t da[4], oa[4];
      load_a(da, do_rows, D, kc, g, t);
      load_a(oa, o_rows, D, kc, g, t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // r = 0, 2: row g; r = 1, 3: row g + 8
        const float2 x = Mma<T>::unpack(da[r]), y = Mma<T>::unpack(oa[r]);
        dvr[r & 1] += x.x * y.x + x.y * y.y;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dvr[r] += __shfl_xor_sync(0xffffffffu, dvr[r], 1);
    dvr[r] += __shfl_xor_sync(0xffffffffu, dvr[r], 2);
  }
  const float linv[2] = {1.f / l[rows + g], 1.f / l[rows + g + 8]};
  if (t == 0) {
    dvec[rows + g] = dvr[0];
    dvec[rows + g + 8] = dvr[1];
    linv_out[rows + g] = linv[0];
    linv_out[rows + g + 8] = linv[1];
  }

  float acc[L::kPanels][L::kAccRegs];
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn) {
#pragma unroll
    for (int i = 0; i < L::kAccRegs; ++i) acc[pn][i] = 0.f;
  }

  int stage = 0, fill = kStages - 1;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kStages - 2>();
    fence_async_proxy();
    __syncthreads();
    if (j + kStages - 1 < tiles) {
      const size_t at = (size_t)(j + kStages - 1) * kTileRows * D;
      load_tile_async<T, D>(kv_s + fill * 2 * kTileBytes, k_head + at, tid);
      load_tile_async<T, D>(kv_s + fill * 2 * kTileBytes + kTileBytes, v_head + at, tid);
    }
    cp_async_commit();
    const uint32_t k_s = kv_s + stage * 2 * kTileBytes, v_s = k_s + kTileBytes;

#pragma unroll
    for (int h = 0; h < kTileRows / kSub; ++h) {  // kSub keys at a time
      float s[kSub / 2], dp[kSub / 2];
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      mma_rows_rows_t<T, D>(s, q_s, k_s, h * kSub);
      mma_rows_rows_t<T, D>(dp, do_s, v_s, h * kSub);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      uint32_t ma[kSub / 4];
#pragma unroll
      for (int i = 0; i < kSub / 4; ++i) {  // pair i: row g + 8 * (i & 1)
        bool in0, in1;
        const float p0 = clamped_exp2(s[2 * i] * scale_log2, in0);
        const float p1 = clamped_exp2(s[2 * i + 1] * scale_log2, in1);
        const float m0 = in0 ? p0 * (dp[2 * i] - dvr[i & 1]) * linv[i & 1] : 0.f;
        const float m1 = in1 ? p1 * (dp[2 * i + 1] - dvr[i & 1]) * linv[i & 1] : 0.f;
        ma[i] = Mma<T>::pack(m0, m1);
      }

      fence_regs(acc);
      wgmma_fence();
      mma_regs_tile<T, D, kSub / 16>(acc, ma, k_s, h * kSub);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

    stage = stage + 1 == kStages ? 0 : stage + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
  cp_async_wait<0>();

  const float mul[2] = {scale, scale};
  __syncthreads();  // every warp's MMAs have read the Q tile: reuse it as the dQ stage
  store_rows<T, D>(acc, mul, q_s, dq + head + (size_t)row0 * D, warp, lane);
}

// Pass 2: dK and dV for 64 keys a block (one warpgroup), walking 64-query tiles of Q,
// dO, 1/l and Dv. The products are taken transposed (S^T = K Q^T,
// dP^T = V dO^T), so p^T and m^T come out with keys as rows and feed
// dV += p^T dO and dK += m^T Q from registers, with the dO and Q tiles as loaded.
// kOut says which gradients this launch owns: 3 both, 1 dV alone, 2 dK alone
// (the two launches of D = 192; the dV one needs neither dP^T nor Dv).
template <typename T, int D, int kOut>
__global__ void __launch_bounds__(kWgThreads)
    flash_bwd_dkv_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                               const T* __restrict__ d_o, const float* __restrict__ linv,
                               const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, int n,
                               float scale, float scale_log2) {
  using L = Tile<D>;
  constexpr int kStages = BwdConfig<D>::kStages;
  constexpr int kSub = BwdConfig<D>::kSub;
  constexpr bool kDoDv = (kOut & 1) != 0, kDoDk = (kOut & 2) != 0;
  constexpr int kTileBytes = L::kBytes;
  constexpr int kVecBytes = kTileRows * 4;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_own = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [64][D]
  const uint32_t v_own = k_own + kTileBytes;                      // [64][D]
  const uint32_t qd_s = v_own + kTileBytes;                       // kStages x (Q tile, dO tile)
  const uint32_t vec_s = qd_s + kStages * 2 * kTileBytes;         // kStages x (1/l[64], Dv[64])

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const size_t head_rows = (size_t)blockIdx.y * n;
  const int key0 = blockIdx.x * kTileRows;
  const T* q_head = q + head;
  const T* do_head = d_o + head;
  const int tiles = n / kTileRows;

  auto load_stage = [&](int st, int tile) {
    const size_t at = (size_t)tile * kTileRows;
    load_tile_async<T, D>(qd_s + st * 2 * kTileBytes, q_head + at * D, tid);
    load_tile_async<T, D>(qd_s + st * 2 * kTileBytes + kTileBytes, do_head + at * D, tid);
    load_f32_async(vec_s + st * 2 * kVecBytes, linv + head_rows + at, tid);
    load_f32_async(vec_s + st * 2 * kVecBytes + kVecBytes, dvec + head_rows + at, tid);
  };

  load_tile_async<T, D>(k_own, k + head + (size_t)key0 * D, tid);
  load_tile_async<T, D>(v_own, v + head + (size_t)key0 * D, tid);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < tiles) load_stage(j, j);
    cp_async_commit();
  }

  float dk_acc[L::kPanels][L::kAccRegs], dv_acc[L::kPanels][L::kAccRegs];  // the one not owned is never touched
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn) {
#pragma unroll
    for (int i = 0; i < L::kAccRegs; ++i) {
      if constexpr (kDoDk) dk_acc[pn][i] = 0.f;
      if constexpr (kDoDv) dv_acc[pn][i] = 0.f;
    }
  }

  int stage = 0, fill = kStages - 1;
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kStages - 2>();
    fence_async_proxy();
    __syncthreads();
    if (j + kStages - 1 < tiles) load_stage(fill, j + kStages - 1);
    cp_async_commit();
    const uint32_t q_s = qd_s + stage * 2 * kTileBytes, do_s = q_s + kTileBytes;
    const uint32_t li_s = vec_s + stage * 2 * kVecBytes, dvs_s = li_s + kVecBytes;

#pragma unroll
    for (int h = 0; h < kTileRows / kSub; ++h) {  // kSub queries at a time
      float s[kSub / 2], dp[kSub / 2];
      fence_regs(s);
      if constexpr (kDoDk) fence_regs(dp);
      wgmma_fence();
      mma_rows_rows_t<T, D>(s, k_own, q_s, h * kSub);
      if constexpr (kDoDk) mma_rows_rows_t<T, D>(dp, v_own, do_s, h * kSub);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if constexpr (kDoDk) fence_regs(dp);

      uint32_t pl[kSub / 4], ml[kSub / 4];
#pragma unroll
      for (int jj = 0; jj < kSub / 8; ++jj) {  // 8 queries: this thread's columns 8*jj + 2t, +1
        float li0, li1, dv0 = 0.f, dv1 = 0.f;
        const uint32_t col = (h * kSub + jj * 8 + 2 * t) * 4;
        asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n" : "=f"(li0), "=f"(li1) : "r"(li_s + col));
        if constexpr (kDoDk)
          asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n" : "=f"(dv0), "=f"(dv1) : "r"(dvs_s + col));
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // key rows g and g + 8
          const int i = 2 * jj + r;
          bool in0, in1;
          const float p0 = clamped_exp2(s[2 * i] * scale_log2, in0) * li0;
          const float p1 = clamped_exp2(s[2 * i + 1] * scale_log2, in1) * li1;
          if constexpr (kDoDv) pl[i] = Mma<T>::pack(p0, p1);
          if constexpr (kDoDk)
            ml[i] = Mma<T>::pack(in0 ? p0 * (dp[2 * i] - dv0) : 0.f, in1 ? p1 * (dp[2 * i + 1] - dv1) : 0.f);
        }
      }

      if constexpr (kDoDv) fence_regs(dv_acc);
      if constexpr (kDoDk) fence_regs(dk_acc);
      wgmma_fence();
      if constexpr (kDoDv) mma_regs_tile<T, D, kSub / 16>(dv_acc, pl, do_s, h * kSub);
      if constexpr (kDoDk) mma_regs_tile<T, D, kSub / 16>(dk_acc, ml, q_s, h * kSub);
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kDoDv) fence_regs(dv_acc);
      if constexpr (kDoDk) fence_regs(dk_acc);
    }

    stage = stage + 1 == kStages ? 0 : stage + 1;
    fill = fill + 1 == kStages ? 0 : fill + 1;
  }
  cp_async_wait<0>();

  const float by_scale[2] = {scale, scale}, by_one[2] = {1.f, 1.f};
  const size_t out = head + (size_t)key0 * D;
  __syncthreads();  // every warp's MMAs have read the block's K and V tiles: reuse them as stages
  if constexpr (kDoDk) store_rows<T, D>(dk_acc, by_scale, k_own, dk + out, warp, lane);
  if constexpr (kDoDv) store_rows<T, D>(dv_acc, by_one, v_own, dv + out, warp, lane);
}

template <typename T, int D, int kOut>
cudaError_t launch_dkv(const T* q, const T* k, const T* v, const T* d_o, const float* linv, const float* dvec, T* dk,
                       T* dv, dim3 grid, int n, float scale, float scale_log2, cudaStream_t stream) {
  constexpr int smem = BwdConfig<D>::kDkvSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<T, D, kOut>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<T, D, kOut>
      <<<grid, kWgThreads, smem, stream>>>(q, k, v, d_o, linv, dvec, dk, dv, n, scale, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                       const float* l, void* dq, void* dk, void* dv, float* scratch, int bh, int n, float scale,
                       cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(d_o);
  constexpr int smem1 = BwdConfig<D>::kDqSmemBytes;
  float* dvec = scratch;                   // Dv, pass 1 -> pass 2
  float* linv = scratch + (size_t)bh * n;  // 1 / l, pass 1 -> pass 2
  const dim3 grid(n / kTileRows, bh);
  const float scale_log2 = scale * kLog2e;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<T, D><<<grid, kWgThreads, smem1, stream>>>(
      q_, k_, v_, static_cast<const T*>(o), do_, l, static_cast<T*>(dq), dvec, linv, n, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
  if constexpr (BwdConfig<D>::kSplitDkv) {
    err = launch_dkv<T, D, 1>(q_, k_, v_, do_, linv, dvec, dk_, dv_, grid, n, scale, scale_log2, stream);
    if (err != cudaSuccess) return err;
    return launch_dkv<T, D, 2>(q_, k_, v_, do_, linv, dvec, dk_, dv_, grid, n, scale, scale_log2, stream);
  } else {
    return launch_dkv<T, D, 3>(q_, k_, v_, do_, linv, dvec, dk_, dv_, grid, n, scale, scale_log2, stream);
  }
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
    case 192: return launch_bwd<T, 192>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wcflash

// q, k, v, o, d_o, dq, dk, dv: contiguous (bh, n, d) in bf16 (is_f16 = 0) or
// f16 (is_f16 = 1). l: f32 (bh, n), the forward's row sums. dvec: f32 (2, bh, n)
// scratch for Dv and 1/l, written by pass 1 and read by pass 2. Returns the
// cudaError_t of the launches.
extern "C" int wc_flash_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                            const float* l, void* dq, void* dk, void* dv, float* dvec, int bh, int n, int d,
                            int is_f16, float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kBlockQ != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcflash::dispatch_bwd<__half>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, d, scale, s)
                : wcflash::dispatch_bwd<__nv_bfloat16>(q, k, v, o, d_o, l, dq, dk, dv, dvec, bh, n, d, scale, s);
}
