// K1: clamped-softmax flash-attention forward, bf16/f16, for sm_90a.
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel` (:78, via
// `_flash_attention_fwd_impl`) and `_flash_kernel_stream_fwd` (:456, via
// `_flash_stream_fwd_impl`):
//   O = (exp(clip(Q K^T * D^-1/2, -60, 60)) V) / l,   l = row sum of the f32 exponentials,
// with p cast to the input type before the PV product and O normalised after it.
//
// What bounds it on the H100: per head 4*N^2*D tensor-core FLOPs (989 TFLOP/s)
// and N^2 exponentials (16 a clock an SM), against only 4*N*D*2 bytes of
// Q/K/V/O traffic: compute-bound at every shape of the UNet (N = 1024/4096),
// on the tensor cores at D >= 64 (at D = 64 the exponentials cost as much)
// and on the exponentials and the clamp/convert instructions around them at
// D = 16/32.
// What the design does about it (flash_wgmma.cuh has the building blocks):
//   * Both products run on wgmma. S = Q K^T takes Q and the K tile from
//     shared memory (K-major); O += P V takes P from the registers S left it
//     in and the V tile as loaded (MN-major descriptor): nothing is staged
//     transposed and nothing of size N^2 leaves registers.
//   * K and V tiles of 64 keys come through a three-deep ring filled by
//     16-byte cp.async into the tensor cores' swizzled layout, two tiles
//     ahead of the MMAs; one __syncthreads a tile hands a slot back.
//   * Per score: one f32 multiply by scale * log2 e, the clamp at
//     +-60 * log2 e, ex2.approx. No running max, so O and l add up unscaled
//     across tiles; the 4-lane shuffle for l happens once, at the end.
//   * The exponentials of tile j+1 overlap the P V product of tile j (see
//     the schedule in the kernel); O leaves through shared memory with
//     16-byte stores.
//   * One warpgroup (64 query rows) a block: two warpgroups sharing a ring
//     measured no faster at any head dim and slower at D = 128 and in K3,
//     and three or four independent blocks an SM hide each other's waits.
// Departures from a textbook Hopper kernel, and why: the loads are cp.async
// by the MMA warps, not TMA by a producer warp (a tensor map holds the
// tensor's address, so it would be encoded on the host at every call of an
// already host-bound path); and S_{j+1} is not kept in flight across
// iterations (ptxas then serializes every wgmma, see the kernel).
// Left for later: 128-key tiles at D = 16/32 (half the per-tile overhead),
// Q as a register operand, and strided inputs (the wrapper makes them
// contiguous).
#include "flash_wgmma.cuh"

namespace wcflash {

// One warpgroup a block owns 64 query rows and walks a ring of 64-key K
// tiles and one of V tiles.
template <int D>
struct FwdConfig {
  static constexpr int kStages = 3;  // depth of each ring: one tile in use, two on their way
  static constexpr int kSmemBytes = 1024 + (1 + kStages * 2) * Tile<D>::kBytes;
};

// One score tile (this warp's 16 rows x 64 keys, 32 accumulators a thread):
// p = exp2(clip(s * scale * log2 e)), its f32 row sums into l, and p packed
// in pairs as the A fragments of the P V product.
template <typename T>
__device__ __forceinline__ void exp_pack(const float (&s)[kTileRows / 2], float scale_log2, float l[2],
                                         uint32_t (&p)[kTileRows / 4]) {
#pragma unroll
  for (int i = 0; i < kTileRows / 4; ++i) {  // pair i: row g + 8 * (i & 1)
    const float x0 = ex2_ftz(fminf(fmaxf(s[2 * i] * scale_log2, -kClampLog2), kClampLog2));
    const float x1 = ex2_ftz(fminf(fmaxf(s[2 * i + 1] * scale_log2, -kClampLog2), kClampLog2));
    l[i & 1] += x0 + x1;
    p[i] = Mma<T>::pack(x0, x1);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads)
    flash_fwd_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           T* __restrict__ o, float* __restrict__ l_out, int n, float scale_log2) {
  using L = Tile<D>;
  constexpr int kStages = FwdConfig<D>::kStages;
  constexpr int kTileBytes = L::kBytes;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [64][D]
  const uint32_t k_ring = q_s + kTileBytes;                     // kStages K tiles
  const uint32_t v_ring = k_ring + kStages * kTileBytes;        // kStages V tiles

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row0 = blockIdx.x * kTileRows;
  const T* k_head = k + head;
  const T* v_head = v + head;
  const int tiles = n / kTileRows;

  auto load_k = [&](int tile) {
    if (tile < tiles)
      load_tile_async<T, D>(k_ring + (tile % kStages) * kTileBytes, k_head + (size_t)tile * kTileRows * D, tid);
  };
  auto load_v = [&](int tile) {
    if (tile >= 0 && tile < tiles)
      load_tile_async<T, D>(v_ring + (tile % kStages) * kTileBytes, v_head + (size_t)tile * kTileRows * D, tid);
  };
  auto start_scores = [&](float(&s)[kTileRows / 2], int tile) {  // S_tile = Q K_tile^T, asynchronous
    fence_regs(s);
    wgmma_fence();
    mma_rows_rows_t<T, D>(s, q_s, k_ring + (tile % kStages) * kTileBytes, 0);
    wgmma_commit();
  };

  // The schedule. Iteration j copies K_{j+3} and V_{j+2} (one cp.async
  // group), starts S_{j+1} = Q K_{j+1}^T and then O += p_j V_j, waits for
  // S_{j+1} alone and turns it into p_{j+1} while the tensor cores are still
  // on p_j V_j. So the clamp/exp2/convert work of a warpgroup overlaps its own
  // P V product, and its Q K^T product the other warpgroups' exponentials.
  // Every wait takes a constant and every iteration drains the MMAs at its
  // end: ptxas follows the MMA groups statically and serializes every wgmma
  // of a kernel in which it cannot prove that an accumulator is read only
  // after its group retired (a deeper pipeline, with S_{j+1} in flight across
  // iterations, measured slower for that reason).
  load_tile_async<T, D>(q_s, q + head + (size_t)row0 * D, tid);
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    load_k(i);
    load_v(i - 1);
    cp_async_commit();
  }

  float acc[L::kPanels][L::kAccRegs];  // never zeroed: the first P V overwrites it
  float l[2] = {0.f, 0.f};
  uint32_t p[kTileRows / 4];

  cp_async_wait<kStages - 1>();  // Q and K_0
  fence_async_proxy();
  __syncthreads();
  {
    float s[kTileRows / 2];
    start_scores(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    exp_pack<T>(s, scale_log2, l, p);
  }
  for (int j = 0; j + 1 < tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of K_{j+1} and V_j have landed
    fence_async_proxy();
    __syncthreads();  // everyone's have, and everyone is done with K_j and V_{j-1}
    load_k(j + kStages);
    load_v(j + kStages - 1);
    cp_async_commit();
    float s[kTileRows / 2];
    uint32_t p_next[kTileRows / 4];
    start_scores(s, j + 1);
    wgmma_fence();
    mma_regs_tile<T, D, kTileRows / 16>(acc, p, v_ring + (j % kStages) * kTileBytes, 0, j > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S_{j+1} is done; p_j V_j may still run
    fence_regs(s);
    exp_pack<T>(s, scale_log2, l, p_next);
    wgmma_wait<0>();  // p_j V_j is done: p is free
    // p_j V_j read p until that wait: keep p alive up to here, or the compiler,
    // which sees p's last use where the MMA starts, computes p_next into p's registers
    fence_regs(p);
    fence_regs(p_next);
#pragma unroll
    for (int i = 0; i < kTileRows / 4; ++i) p[i] = p_next[i];
  }
  cp_async_wait<0>();  // V of the last tile
  fence_async_proxy();
  __syncthreads();
  wgmma_fence();
  mma_regs_tile<T, D, kTileRows / 16>(acc, p, v_ring + ((tiles - 1) % kStages) * kTileBytes, 0, tiles > 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int g = lane >> 2, t = lane & 3;
  if (l_out != nullptr && t == 0) {
    float* l_rows = l_out + (size_t)blockIdx.y * n + row0 + warp * 16;
    l_rows[g] = l[0];
    l_rows[g + 8] = l[1];
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  __syncthreads();  // every warp's last Q K^T has read the Q tile: reuse it as the O stage
  store_rows<T, D>(acc, inv, q_s, o + head + (size_t)row0 * D, warp, lane);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* l, int bh, int n,
                   float scale, cudaStream_t stream) {
  constexpr int smem = FwdConfig<D>::kSmemBytes;
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_wgmma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / kTileRows, bh);
  flash_fwd_wgmma_kernel<T, D><<<grid, kWgThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), l, n,
      scale * kLog2e);
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
