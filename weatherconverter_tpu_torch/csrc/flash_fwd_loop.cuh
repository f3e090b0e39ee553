// The schedule of the flash forwards K1 (flash_fwd.cu), K2 (flash_fwd_qk_i8.cu)
// and K4 (probe_exp2_attn.cu), as a function of how a score tile is made and
// how it becomes p, which is all the three differ in: K1 takes Q K^T in
// bf16/f16 from shared memory and scales every score; K2 takes it in int8 and
// scales by a factor read from the device; K4 holds a pre-scaled Q in
// registers and clamps from above only.
//
// (At D = 192 K1 and K2 run flash_fwd_wide.cuh's block of two warpgroups
// and a producer instead, on the same policies.)
//
// One warpgroup a block owns 64 query rows and walks a three-deep ring of
// 64-key K tiles and one of V tiles, filled by cp.async two tiles ahead.
// Iteration j copies K_{j+3} and V_{j+2} (one cp.async group), starts
// S_{j+1} = Q K_{j+1}^T and then O += p_j V_j, waits for S_{j+1} alone and
// turns it into p_{j+1} while the tensor cores are still on p_j V_j. So the
// clamp/exp2/convert work of a warpgroup overlaps its own P V product, and
// its Q K^T product the other warpgroups' exponentials. Every wait takes a
// constant and every iteration drains the MMAs at its end: ptxas follows the
// MMA groups statically and serializes every wgmma of a kernel in which it
// cannot prove that an accumulator is read only after its group retired (a
// deeper pipeline, with S_{j+1} in flight across iterations, measured slower
// in K1 for that reason). No running max, so O and l add up unscaled across
// tiles; the 4-lane shuffle for l happens once, at the end.
//
// A policy provides:
//   using Score                      float or int: the score accumulators
//   static constexpr int kQBytes     shared bytes of the block's own Q tile (0: Q lives in registers)
//   static constexpr int kKTileBytes shared bytes of one K tile of the ring
//   void prologue(q_s, k_ring, tid)  copies of Q (they join the first cp.async group) and any zero padding
//   void load_k(dst, tile, tid)      cp.async copies of K tile `tile` into the slot at `dst`
//   void start(s, q_s, k_tile)       queues the MMAs of s = Q K_tile^T
//   void exp_pack(s, l, p)           p = exp of the scores, f32 row sums into l, p packed as A fragments
#pragma once

#include "flash_wgmma.cuh"

namespace wcflash {

constexpr int kFwdStages = 3;  // depth of each ring: one tile in use, two on their way

template <typename T, int D, typename Policy>
constexpr int fwd_loop_smem_bytes() {
  return 1024 + Policy::kQBytes + kFwdStages * (Policy::kKTileBytes + Tile<D>::kBytes);
}

// O (64 rows at `o_rows`, row stride G) = (sum over the n / 64 key tiles of
// p_j V_j) / l, with v_head the head's V rows; the 64 row sums l go to
// `l_rows` unless it is null. Called by all 128 threads. D is the tile's
// width, G the tensors' head dim: G < D (K1 at 24 on D = 32 tiles) stages V
// with its columns from G on zero-filled and stores only the first G columns
// of O.
template <typename T, int D, typename Policy, int G = D>
__device__ __forceinline__ void flash_forward_loop(const Policy& policy, const T* __restrict__ v_head,
                                                   T* __restrict__ o_rows, float* __restrict__ l_rows, int n) {
  using L = Tile<D>;
  using Score = typename Policy::Score;
  constexpr int kStages = kFwdStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_ring = q_s + Policy::kQBytes;
  const uint32_t v_ring = k_ring + kStages * Policy::kKTileBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = n / kTileRows;

  auto load_k = [&](int tile) {
    if (tile < tiles) policy.load_k(k_ring + (tile % kStages) * Policy::kKTileBytes, tile, tid);
  };
  auto load_v = [&](int tile) {
    if (tile >= 0 && tile < tiles)
      load_tile_async<T, D, G>(v_ring + (tile % kStages) * L::kBytes, v_head + (size_t)tile * kTileRows * G, tid);
  };
  auto start_scores = [&](Score(&s)[kTileRows / 2], int tile) {  // asynchronous
    fence_regs(s);
    wgmma_fence();
    policy.start(s, q_s, k_ring + (tile % kStages) * Policy::kKTileBytes);
    wgmma_commit();
  };

  policy.prologue(q_s, k_ring, tid);
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
    Score s[kTileRows / 2];
    start_scores(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    policy.exp_pack(s, l, p);
  }
  for (int j = 0; j + 1 < tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of K_{j+1} and V_j have landed
    fence_async_proxy();
    __syncthreads();  // everyone's have, and everyone is done with K_j and V_{j-1}
    load_k(j + kStages);
    load_v(j + kStages - 1);
    cp_async_commit();
    Score s[kTileRows / 2];
    uint32_t p_next[kTileRows / 4];
    start_scores(s, j + 1);
    wgmma_fence();
    mma_regs_tile<T, D, kTileRows / 16>(acc, p, v_ring + (j % kStages) * L::kBytes, 0, j > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S_{j+1} is done; p_j V_j may still run
    fence_regs(s);
    policy.exp_pack(s, l, p_next);
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
  mma_regs_tile<T, D, kTileRows / 16>(acc, p, v_ring + ((tiles - 1) % kStages) * L::kBytes, 0, tiles > 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (l_rows != nullptr && lane % 4 == 0) {
    l_rows[warp * 16 + lane / 4] = l[0];
    l_rows[warp * 16 + lane / 4 + 8] = l[1];
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  __syncthreads();  // every warp's last P V has read its V tile: the ring's first slot is the O stage
  store_rows<T, D, G>(acc, inv, v_ring, o_rows, warp, lane);
}

}  // namespace wcflash
