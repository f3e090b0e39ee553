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
//   * One warpgroup a block up to D = 128: two sharing a ring measured 7 %
//     slower at D = 64 and no faster elsewhere.
// At D = 192 (three 64-column panels a tile) one warpgroup cannot hold the
// pass-2 sums: dK and dV together are 192 accumulator registers a thread
// before S^T and dP^T. Its tiles are 24 KB, so one block fills an SM, nothing
// hides a warpgroup's waits, exponentials and copies, and each walked tile it
// reads from L2 serves 64 rows. Both passes run on flash_fwd_wide.cuh's
// block there instead: a producer warpgroup and two consumer warpgroups
// (384 threads; setmaxnreg 24 / 240 / 240, the block's own 3 x 168).
//   * Pass 2, one launch (flash_bwd_dkv_wide_kernel): a block owns 64 keys,
//     its K and V tiles in shared memory. The producer walks the 64-query
//     tiles of Q and dO, with their 1/l and Dv, into a two-deep mbarrier ring
//     (16-byte cp.async, cp.async.mbarrier.arrive.noinc: it never waits for
//     a copy; a slot is refilled once both consumers have released it).
//     Consumer 0 forms S^T = K Q^T and p^T / l and sums dV += (p^T / l) dO;
//     consumer 1 forms dP^T = V dO^T, takes p^T / l from consumer 0 through
//     shared memory (a 64 x 64 f32 tile, two buffers behind FULL / EMPTY
//     mbarriers; the two threads of one tid hold the same elements, and the
//     sign bit of each value says where the clamp fired), forms
//     m^T scale / l and sums dK += m^T Q. Seven products in all, not eight,
//     96 accumulators a consumer, every walked tile read once for both
//     gradients (178 KB of shared memory).
//   * Pass 1, one launch (flash_bwd_dq_wide_kernel): a block owns 128 query
//     rows, two consumers of 64, each with its own Q and dO tiles; the
//     producer walks one two-deep ring of K and V tiles for both, so each
//     tile read from L2 serves 128 rows (193 KB). With 240 registers a
//     consumer takes 64-key score tiles (S and dP: 64 accumulators) beside
//     its 96 of dQ. A block past the last 64 rows of a head (N an odd
//     multiple of 64) has one consumer's worth of rows: its second consumer
//     computes the first one's rows again and stores nothing.
//   * Each consumer's MMAs are drained at the end of every step, which keeps
//     ptxas from serializing the wgmma; the two consumers are not held in
//     step, so one's exponentials and waits run under the other's products.
//   * The sums keep the one-warpgroup kernels' order: the same key or query
//     order, the same 16-deep k-steps, the same arithmetic on p and m, so
//     dQ, dK and dV equal theirs bit for bit.
// What the design bought, beside pass 1 left on one warpgroup
// (probes/bwd_wide_ablations.py): PERF.md section 6.
// Left for later: overlapping the exp/mask work with the MMAs inside a
// warpgroup (splitting S and dO V^T into two MMA groups measured no gain and
// cost registers), TMA, and strided inputs (the wrapper makes them
// contiguous).
#include "flash_fwd_wide.cuh"

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
  // kSubDq: keys a score tile of pass 1 (32 at D = 192, where the one-warpgroup pass 1 runs only as an ablation:
  // 96 + 16 + 16 accumulators).
  static constexpr int kStages = D >= 128 ? 2 : 3;
  static constexpr int kSub = D >= 128 ? 32 : 64;
  static constexpr int kSubDq = D > 128 ? 32 : 64;
  static constexpr int kDqSmemBytes = 1024 + (2 + kStages * 2) * Tile<D>::kBytes;
  static constexpr int kDkvSmemBytes = kDqSmemBytes + kStages * 2 * kTileRows * 4;
};

// D = 192's block (flash_fwd_wide.cuh's producer and two consumers): the depth of the walked-tile rings (pass 1 has
// no room for a third stage) and the p^T / l exchange buffers of pass 2.
constexpr int kWideDqStages = 2;
constexpr int kWideDkvStages = 2;
constexpr int kWideExchange = 2;
constexpr int kVecBytes = kTileRows * 4;                  // 64 f32 values: 1/l or Dv of a tile
constexpr int kExchangeBytes = kTileRows * kTileRows * 4;  // p^T / l of a 64 x 64 tile, f32
constexpr int kWideDqSmemBytes =
    1024 + (2 * kWideConsumers + 2 * kWideDqStages) * Tile<192>::kBytes + 16 * kWideDqStages;
constexpr int kWideDkvSmemBytes = 1024 + (2 + 2 * kWideDkvStages) * Tile<192>::kBytes +
                                  2 * kWideDkvStages * kVecBytes + kWideExchange * kExchangeBytes +
                                  16 * (kWideDkvStages + kWideExchange);
static_assert(kWideDqSmemBytes <= 232448 && kWideDkvSmemBytes <= 232448, "a block's shared memory");

// exp2-domain score y -> p = exp2(clip(y)), and whether the clamp left it alone
__device__ __forceinline__ float clamped_exp2(float y, bool& inside) {
  inside = fabsf(y) <= kClampLog2;
  return ex2_ftz(fminf(fmaxf(y, -kClampLog2), kClampLog2));
}

// Dv = rowsum(dO o O) and 1/l of this thread's rows g and g + 8 of its warp's 16 (from `warp_row0` on in the
// head at `head`, whose rows start at `head_rows` in l), read from global memory; written to the f32 scratch
// when `store`.
template <typename T, int D>
__device__ __forceinline__ void row_terms(const T* __restrict__ o, const T* __restrict__ d_o,
                                          const float* __restrict__ l, float* __restrict__ dvec,
                                          float* __restrict__ linv_out, size_t head, size_t head_rows, int warp_row0,
                                          int g, int t, bool store, float dvr[2], float linv[2]) {
  const size_t rows = head_rows + warp_row0;
  dvr[0] = dvr[1] = 0.f;
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
  linv[0] = 1.f / l[rows + g];
  linv[1] = 1.f / l[rows + g + 8];
  if (store && t == 0) {
    dvec[rows + g] = dvr[0];
    dvec[rows + g + 8] = dvr[1];
    linv_out[rows + g] = linv[0];
    linv_out[rows + g + 8] = linv[1];
  }
}

// m = p o (dP - Dv) / l for this thread's 64-key strip of scores s and dP (pairs i: row g + 8 (i & 1)), packed as
// the A fragments of m K; zero where the clamp fired.
template <typename T, int kRegs>
__device__ __forceinline__ void dq_m(const float (&s)[kRegs], const float (&dp)[kRegs], const float dvr[2],
                                     const float linv[2], float scale_log2, uint32_t (&ma)[kRegs / 2]) {
#pragma unroll
  for (int i = 0; i < kRegs / 2; ++i) {
    bool in0, in1;
    const float p0 = clamped_exp2(s[2 * i] * scale_log2, in0);
    const float p1 = clamped_exp2(s[2 * i + 1] * scale_log2, in1);
    const float m0 = in0 ? p0 * (dp[2 * i] - dvr[i & 1]) * linv[i & 1] : 0.f;
    const float m1 = in1 ? p1 * (dp[2 * i + 1] - dvr[i & 1]) * linv[i & 1] : 0.f;
    ma[i] = Mma<T>::pack(m0, m1);
  }
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

  float dvr[2], linv[2];
  row_terms<T, D>(o, d_o, l, dvec, linv_out, head, (size_t)blockIdx.y * n, row0 + warp * 16, g, t, true, dvr, linv);

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
      dq_m<T>(s, dp, dvr, linv, scale_log2, ma);

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
// (1 and 2: D = 192's two launches on one warpgroup, which only the ablations
// and the one-warpgroup reference of probes/bwd_wide_ablations.py build).
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

// Pass 1 at D = 192 (see the note at the top): dQ for 128 query rows a block, two consumer warpgroups of 64 and a
// producer that walks the K/V tiles for both; Dv and 1/l of the rows to the f32 scratch, as the one-warpgroup pass.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ o, const T* __restrict__ d_o, const float* __restrict__ l,
                             T* __restrict__ dq, float* __restrict__ dvec, float* __restrict__ linv_out, int n,
                             float scale, float scale_log2) {
  constexpr int D = 192;
  using L = Tile<D>;
  constexpr int kS = kWideDqStages;
  constexpr int kTB = L::kBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t own0 = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [consumer]: its Q tile, then its dO tile
  const uint32_t ring = own0 + kWideConsumers * 2 * kTB;          // kS x (K tile, V tile)
  const uint32_t full = ring + kS * 2 * kTB, empty = full + 8 * kS;

  const int tid = threadIdx.x;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row0 = blockIdx.x * kWideRows;
  const int rows = min(kWideRows, n - row0);
  const int tiles = n / kTileRows;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, kWgThreads);
      mbar_init(empty + 8 * s, kWideConsumers * kWgThreads);
    }
  }
  __syncthreads();

  if (tid >= kWideConsumers * kWgThreads) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProducerRegs));
    const int ptid = tid - kWideConsumers * kWgThreads;
#pragma unroll 1
    for (int c = 0; c < kWideConsumers; ++c) {  // a half block's second consumer takes the first one's rows
      const size_t at = head + (size_t)(row0 + (c * kTileRows < rows ? c * kTileRows : 0)) * D;
      copy_tile<T, D>(own0 + c * 2 * kTB, q + at, ptid);
      copy_tile<T, D>(own0 + c * 2 * kTB + kTB, d_o + at, ptid);
    }
#pragma unroll 1
    for (int j = 0; j < tiles; ++j) {  // the own tiles land before the first tile's arrival
      const int s = j % kS;
      if (j >= kS) mbar_wait(empty + 8 * s, (j / kS + 1) & 1);
      const size_t at = head + (size_t)j * kTileRows * D;
      copy_tile<T, D>(ring + s * 2 * kTB, k + at, ptid);
      copy_tile<T, D>(ring + s * 2 * kTB + kTB, v + at, ptid);
      mbar_arrive_copies(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsumerRegs));
  const int c = tid / kWgThreads, warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const bool owns = c * kTileRows < rows;  // else a half block's second consumer: stores nothing
  const int my_row0 = row0 + (owns ? c * kTileRows : 0);
  const uint32_t q_s = own0 + c * 2 * kTB, do_s = q_s + kTB;
  float dvr[2], linv[2];
  row_terms<T, D>(o, d_o, l, dvec, linv_out, head, (size_t)blockIdx.y * n, my_row0 + warp * 16, lane >> 2, lane & 3,
                  owns, dvr, linv);

  float acc[L::kPanels][L::kAccRegs];
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn) {
#pragma unroll
    for (int i = 0; i < L::kAccRegs; ++i) acc[pn][i] = 0.f;
  }
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kS;
    mbar_wait(full + 8 * s, (j / kS) & 1);
    fence_async_proxy();  // the copies landed through the generic proxy; wgmma reads through the async one
    const uint32_t k_s = ring + s * 2 * kTB, v_s = k_s + kTB;
    float sc[kTileRows / 2], dp[kTileRows / 2];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    mma_rows_rows_t<T, D>(sc, q_s, k_s, 0);
    mma_rows_rows_t<T, D>(dp, do_s, v_s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    uint32_t ma[kTileRows / 4];
    dq_m<T>(sc, dp, dvr, linv, scale_log2, ma);
    fence_regs(acc);
    wgmma_fence();
    mma_regs_tile<T, D, kTileRows / 16>(acc, ma, k_s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }
  if (!owns) return;
  const float mul[2] = {scale, scale};
  store_rows<T, D>(acc, mul, q_s, dq + head + (size_t)my_row0 * D, warp, lane);  // the own Q tile as the stage
}

// Pass 2 at D = 192 (see the note at the top): dK and dV for 64 keys a block in one launch. Consumer 0 forms S^T
// and p^T / l and sums dV; consumer 1 forms dP^T, takes p^T / l from consumer 0 and sums dK.
template <typename T>
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                              const T* __restrict__ d_o, const float* __restrict__ linv,
                              const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, int n,
                              float scale, float scale_log2) {
  constexpr int D = 192;
  using L = Tile<D>;
  constexpr int kS = kWideDkvStages, kX = kWideExchange;
  constexpr int kTB = L::kBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t k_own = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [64][D]: consumer 0's, then its dV stage
  const uint32_t v_own = k_own + kTB;                              // [64][D]: consumer 1's, then its dK stage
  const uint32_t ring = v_own + kTB;                               // kS x (Q tile, dO tile)
  const uint32_t vecs = ring + kS * 2 * kTB;                       // kS x (1/l[64], Dv[64])
  const uint32_t xch = vecs + kS * 2 * kVecBytes;                  // kX x p^T / l
  const uint32_t full = xch + kX * kExchangeBytes, empty = full + 8 * kS;
  const uint32_t p_full = empty + 8 * kS, p_empty = p_full + 8 * kX;

  const int tid = threadIdx.x;
  const size_t head = (size_t)blockIdx.y * n * D, head_rows = (size_t)blockIdx.y * n;
  const int key0 = blockIdx.x * kTileRows;
  const int tiles = n / kTileRows;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, kWgThreads);
      mbar_init(empty + 8 * s, kWideConsumers * kWgThreads);
    }
#pragma unroll
    for (int x = 0; x < kX; ++x) {
      mbar_init(p_full + 8 * x, kWgThreads);
      mbar_init(p_empty + 8 * x, kWgThreads);
    }
  }
  __syncthreads();

  if (tid >= kWideConsumers * kWgThreads) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProducerRegs));
    const int ptid = tid - kWideConsumers * kWgThreads;
    copy_tile<T, D>(k_own, k + head + (size_t)key0 * D, ptid);
    copy_tile<T, D>(v_own, v + head + (size_t)key0 * D, ptid);
#pragma unroll 1
    for (int j = 0; j < tiles; ++j) {  // the own tiles land before the first tile's arrival
      const int s = j % kS;
      if (j >= kS) mbar_wait(empty + 8 * s, (j / kS + 1) & 1);
      const size_t at = (size_t)j * kTileRows;
      copy_tile<T, D>(ring + s * 2 * kTB, q + head + at * D, ptid);
      copy_tile<T, D>(ring + s * 2 * kTB + kTB, d_o + head + at * D, ptid);
      if (ptid < 2 * kTileRows / 4) {  // 16 threads copy 1/l, 16 Dv
        const float* src = (ptid < kTileRows / 4 ? linv : dvec) + head_rows + at + (ptid % (kTileRows / 4)) * 4;
        cp_async16(vecs + s * 2 * kVecBytes + ptid * 16, src);
      }
      mbar_arrive_copies(full + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsumerRegs));
  const int c = tid / kWgThreads, u = tid % kWgThreads, warp = u / 32, lane = tid % 32;
  const int t = lane & 3;
  float acc[L::kPanels][L::kAccRegs];  // dV for consumer 0, dK for consumer 1
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn) {
#pragma unroll
    for (int i = 0; i < L::kAccRegs; ++i) acc[pn][i] = 0.f;
  }
  for (int j = 0; j < tiles; ++j) {
    const int s = j % kS, x = j % kX;
    mbar_wait(full + 8 * s, (j / kS) & 1);
    fence_async_proxy();
    const uint32_t q_s = ring + s * 2 * kTB, do_s = q_s + kTB;
    const uint32_t vec_s = vecs + s * 2 * kVecBytes + c * kVecBytes;  // 1/l for consumer 0, Dv for consumer 1
    const uint32_t xs = xch + x * kExchangeBytes + u * 8;             // this thread's pairs, 1 KB apart
    float sc[kTileRows / 2];  // S^T (consumer 0) or dP^T (consumer 1): keys as rows
    fence_regs(sc);
    wgmma_fence();
    mma_rows_rows_t<T, D>(sc, c == 0 ? k_own : v_own, c == 0 ? q_s : do_s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    uint32_t a[kTileRows / 4];  // p^T / l or m^T, the A fragments of the dV or dK product
    if (c == 0) {
      if (j >= kX) mbar_wait(p_empty + 8 * x, (j / kX + 1) & 1);
#pragma unroll
      for (int jj = 0; jj < kTileRows / 8; ++jj) {  // 8 queries: this thread's columns 8 jj + 2t, +1
        float li0, li1;
        asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n" : "=f"(li0), "=f"(li1) : "r"(vec_s + (jj * 8 + 2 * t) * 4));
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // key rows g and g + 8
          const int i = 2 * jj + r;
          bool in0, in1;
          const float p0 = clamped_exp2(sc[2 * i] * scale_log2, in0) * li0;
          const float p1 = clamped_exp2(sc[2 * i + 1] * scale_log2, in1) * li1;
          a[i] = Mma<T>::pack(p0, p1);
          // p >= +0: its sign bit tells consumer 1 that the clamp fired
          asm volatile("st.shared.v2.f32 [%0], {%1,%2};\n" ::"r"(xs + i * kWgThreads * 8), "f"(in0 ? p0 : -p0),
                       "f"(in1 ? p1 : -p1)
                       : "memory");
        }
      }
      mbar_arrive(p_full + 8 * x);
    } else {
      mbar_wait(p_full + 8 * x, (j / kX) & 1);
#pragma unroll
      for (int jj = 0; jj < kTileRows / 8; ++jj) {
        float dv0, dv1;
        asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n" : "=f"(dv0), "=f"(dv1) : "r"(vec_s + (jj * 8 + 2 * t) * 4));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 2 * jj + r;
          float p0, p1;
          asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n" : "=f"(p0), "=f"(p1) : "r"(xs + i * kWgThreads * 8));
          a[i] = Mma<T>::pack(__float_as_uint(p0) >> 31 ? 0.f : p0 * (sc[2 * i] - dv0),
                              __float_as_uint(p1) >> 31 ? 0.f : p1 * (sc[2 * i + 1] - dv1));
        }
      }
      mbar_arrive(p_empty + 8 * x);
    }
    fence_regs(acc);
    wgmma_fence();
    mma_regs_tile<T, D, kTileRows / 16>(acc, a, c == 0 ? do_s : q_s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty + 8 * s);
  }
  // each consumer's own tile is read by its own MMAs alone, all retired: its stage
  const float by_scale[2] = {scale, scale}, by_one[2] = {1.f, 1.f};
  const size_t out = head + (size_t)key0 * D;
  if (c == 0)
    store_rows<T, D>(acc, by_one, k_own, dv + out, warp, lane);
  else
    store_rows<T, D>(acc, by_scale, v_own, dk + out, warp, lane);
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
cudaError_t launch_dq(const T* q, const T* k, const T* v, const T* o, const T* d_o, const float* l, T* dq, float* dvec,
                      float* linv, int bh, int n, float scale, float scale_log2, cudaStream_t stream) {
  constexpr int smem = BwdConfig<D>::kDqSmemBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<T, D>
      <<<dim3(n / kTileRows, bh), kWgThreads, smem, stream>>>(q, k, v, o, d_o, l, dq, dvec, linv, n, scale, scale_log2);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq_wide(const T* q, const T* k, const T* v, const T* o, const T* d_o, const float* l, T* dq,
                           float* dvec, float* linv, int bh, int n, float scale, float scale_log2,
                           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wide_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kWideDqSmemBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<T><<<dim3((n + kWideRows - 1) / kWideRows, bh), kWideThreads, kWideDqSmemBytes, stream>>>(
      q, k, v, o, d_o, l, dq, dvec, linv, n, scale, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
                       const float* l, void* dq, void* dk, void* dv, float* scratch, int bh, int n, float scale,
                       cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(d_o);
  T* dq_ = static_cast<T*>(dq);
  T* dk_ = static_cast<T*>(dk);
  T* dv_ = static_cast<T*>(dv);
  float* dvec = scratch;                   // Dv, pass 1 -> pass 2
  float* linv = scratch + (size_t)bh * n;  // 1 / l, pass 1 -> pass 2
  const dim3 grid(n / kTileRows, bh);
  const float scale_log2 = scale * kLog2e;
  if constexpr (D == 192) {
    cudaError_t err = launch_dq_wide<T>(q_, k_, v_, o_, do_, l, dq_, dvec, linv, bh, n, scale, scale_log2, stream);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kWideDkvSmemBytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_wide_kernel<T><<<grid, kWideThreads, kWideDkvSmemBytes, stream>>>(
        q_, k_, v_, do_, linv, dvec, dk_, dv_, n, scale, scale_log2);
    return cudaGetLastError();
  } else {
    cudaError_t err = launch_dq<T, D>(q_, k_, v_, o_, do_, l, dq_, dvec, linv, bh, n, scale, scale_log2, stream);
    if (err != cudaSuccess) return err;
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
