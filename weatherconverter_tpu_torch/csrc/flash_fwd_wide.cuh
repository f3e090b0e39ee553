// The schedule of the flash forwards K1 (flash_fwd.cu) and K2
// (flash_fwd_qk_i8.cu) at D = 192, the 256 px UNet's 768-channel layers, on
// the same score policies (FwdPolicy, QkI8Policy) that flash_fwd_loop.cuh
// runs at D <= 128.
//
// Why another schedule: at D = 192 a 64-row warpgroup holds 96 O
// accumulators a thread and its tiles are 24 KB, so flash_fwd_loop.cuh's
// block (one warpgroup, three-deep rings, 169 KB) fills an SM alone: nothing
// hides its waits for S, its exponentials, its own copies and the drain at
// the end of each iteration, and every K/V tile it reads from L2 serves 64
// rows (~402 MB of L2 reads for K1 at (8, 4, 1024, 192)).
//
// Here a block owns 128 query rows: two consumer warpgroups of 64 rows each
// and one producer warpgroup (384 threads; 193 KB of shared memory for K1,
// 157 KB for K2: one block an SM).
//   * The producer copies both consumers' Q tiles, then walks the key tiles,
//     K_{t+1} before V_t, into three-deep rings of K and V slots with 16-byte
//     cp.async (copy_tile). Each slot has a FULL mbarrier, at which the
//     producer's 128 threads arrive as their copies land
//     (cp.async.mbarrier.arrive.noinc: the producer never waits for a copy),
//     and an EMPTY one, at which both consumers' 256 threads arrive once
//     their MMAs have read the slot and on which the producer waits before
//     it refills it. Loads stay cp.async, not TMA: a tensor map holds the
//     tensor's address, so it would be encoded on the host at every call of
//     an already host-bound path.
//   * Each consumer runs flash_fwd_loop.cuh's iteration on its own rows:
//     S_{j+1} = Q K_{j+1}^T started, then P_j V_j; S_{j+1} waited for alone
//     and turned into p_{j+1} while P_j V_j runs; the MMAs drained at the end
//     of every iteration (what keeps ptxas from serializing the wgmma). P V
//     is one m64n192k16 MMA a 16-key chunk over V's three panels (the
//     descriptor's leading offset steps from panel to panel), where the
//     narrow loop issues one m64n64k16 a panel.
//   * The consumers are not held in step: one's exponentials and waits run
//     under the other's products, and each K/V tile read from L2 serves 128
//     rows (~201 MB for K1 at (8, 4, 1024, 192)).
//   * setmaxnreg gives the producer 24 registers (copy_tile holds two
//     addresses) and each consumer 240 of the 384-thread block's 168 a
//     thread: 24 + 2 x 240 = 3 x 168, the block's own registers (a budget
//     past them makes setmaxnreg.inc wait forever).
// Each consumer leaves O through its own Q slot (sized for an O tile), which
// only its own score products read. A block past the last 64 rows of a head
// (N an odd multiple of 64) has one consumer's worth of rows: its second
// consumer computes the first one's rows again and stores nothing, so the
// barrier counts never change.
//
// What the design choices bought, each against this kernel with that one
// choice undone (probes/fwd_wide_ablations.py on the card; PERF.md section
// 6 has the times): the n192 P V product, the producer's register budget,
// the ring depth, and the loads themselves (the kernel with its loads past
// the rings taken out, its floor); and K2 on the old one-warpgroup block
// with two-deep rings (85 KB, two blocks an SM), the design tried beside it.
//
// A policy provides, beside what flash_fwd_loop.cuh asks of it:
//   using Elem                       the element of Q and K in global memory (T, or int8_t for K2)
//   const Elem* q_rows, k_head       the block's first Q row and the head's K rows, row stride D
#pragma once

#include "flash_wgmma.cuh"

namespace wcflash {

constexpr int kWideStages = 3;                          // depth of the K ring and of the V ring
constexpr int kWideConsumers = 2;                       // consumer warpgroups, 64 query rows each
constexpr int kWideRows = kWideConsumers * kTileRows;  // query rows of a block
constexpr int kWideThreads = (kWideConsumers + 1) * kWgThreads;
constexpr int kWideLaunchRegs = 65536 / kWideThreads / 8 * 8;  // what ptxas gives each thread: 168
constexpr int kWideProducerRegs = 24;
constexpr int kWideConsumerRegs = 240;
static_assert(kWideProducerRegs + kWideConsumers * kWideConsumerRegs == (kWideConsumers + 1) * kWideLaunchRegs,
              "setmaxnreg trades the block's own registers");

// A consumer's own slot: its Q tile, then its O tile on the way out.
template <int D, typename Policy>
__host__ __device__ constexpr int wide_own_bytes() {
  return Policy::kQBytes > Tile<D>::kBytes ? Policy::kQBytes : Tile<D>::kBytes;
}

template <int D, typename Policy>
constexpr int wide_smem_bytes() {
  return 1024 + kWideConsumers * wide_own_bytes<D, Policy>() +
         kWideStages * (Policy::kKTileBytes + Tile<D>::kBytes) + 4 * kWideStages * 8;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar) : "memory");
}
// An arrival at `bar` once every cp.async this thread has issued so far has landed, counted in the barrier's
// expected count (noinc).
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The 64 rows at `src` (row stride D) into the tile at `dst` by the producer's 128 threads, 16 bytes a cp.async.
// Thread ptid copies chunk ptid % kPerRow of a panel row in rows ptid / kPerRow + kRowStep * g of every panel:
// kRowStep rows are 2 KB of a panel, which leaves the swizzle's bits alone, so every copy of a thread lands at its
// first one's swizzled offset plus a constant and the producer holds two addresses a tile. (load_tile_async's
// order, unrolled, kept every copy's offsets in registers for the whole walk and spilled; a rolled loop that
// computed each address from its index was latency-bound and slowed the kernel down.)
template <typename E, int D>
__device__ __forceinline__ void copy_tile(uint32_t dst, const E* __restrict__ src, int ptid) {
  using L = Tile<D, sizeof(E)>;
  constexpr int kPerRow = L::kChunksPerPanelRow;
  constexpr int kRowStep = kWgThreads / kPerRow;
  static_assert(L::kRowBytes == L::kDataRowBytes && (kRowStep * L::kRowBytes) % 1024 == 0 &&
                    kTileRows % kRowStep == 0,
                "whole swizzle periods, no padded rows");
  const int r0 = ptid / kPerRow, pc = ptid % kPerRow;
  const uint32_t at = dst + L::swizzled(r0, pc);
  const E* from = src + (size_t)r0 * D + pc * L::kElemsPerChunk;
#pragma unroll
  for (int g = 0; g < kTileRows / kRowStep; ++g)
#pragma unroll
    for (int panel = 0; panel < L::kPanels; ++panel)
      cp_async16(at + panel * L::kPanelBytes + g * kRowStep * L::kRowBytes,
                 from + (size_t)g * kRowStep * D + panel * L::kPanelCols);
}

// acc (64 x 192) += P (this warp's A fragments, p[4 c ..] those of the 16-key chunk c) . V (the tile at `v_tile`),
// one m64n192k16 MMA a chunk. With `accumulate` = 0 the first chunk overwrites acc (see mma_regs_tile).
template <typename T>
__device__ __forceinline__ void mma_regs_tile192(float (&acc)[3][32], const uint32_t* p, uint32_t v_tile,
                                                 int accumulate) {
#pragma unroll
  for (int c = 0; c < kTileRows / 16; ++c)
    Wgmma<T>::rs192(acc, p + 4 * c, desc_mnmajor<192>(v_tile, 0, c), c == 0 ? accumulate : 1);
}

// O (the block's rows from `o_block` on, row stride D) = (sum over the n / 64 key tiles of p_j V_j) / l, with
// v_head the head's V rows; `rows` (64 or 128) of them are the block's; the row sums l go to `l_block` unless it
// is null. Called by all kWideThreads threads.
template <typename T, int D, typename Policy>
__device__ __forceinline__ void flash_forward_wide(const Policy& policy, const T* __restrict__ v_head,
                                                   T* __restrict__ o_block, float* __restrict__ l_block, int n,
                                                   int rows) {
  static_assert(D == 192, "the n192 P V product");
  using L = Tile<D>;
  using E = typename Policy::Elem;
  using Score = typename Policy::Score;
  constexpr int kS = kWideStages;
  constexpr int kOwn = wide_own_bytes<D, Policy>();
  constexpr int kKBytes = Policy::kKTileBytes;
  static_assert(kOwn % 1024 == 0 && kKBytes % 1024 == 0, "tiles on 1024-byte boundaries");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t own0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_ring = own0 + kWideConsumers * kOwn;
  const uint32_t v_ring = k_ring + kS * kKBytes;
  const uint32_t bars = v_ring + kS * L::kBytes;  // FULL K, EMPTY K, FULL V, EMPTY V: kS each
  const uint32_t full_k = bars, empty_k = bars + 8 * kS, full_v = bars + 16 * kS, empty_v = bars + 24 * kS;

  const int tid = threadIdx.x;
  const int tiles = n / kTileRows;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(full_k + 8 * s, kWgThreads);
      mbar_init(full_v + 8 * s, kWgThreads);
      mbar_init(empty_k + 8 * s, kWideConsumers * kWgThreads);
      mbar_init(empty_v + 8 * s, kWideConsumers * kWgThreads);
    }
  }
  __syncthreads();

  if (tid >= kWideConsumers * kWgThreads) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWideProducerRegs));
    const int ptid = tid - kWideConsumers * kWgThreads;
#pragma unroll 1
    for (int c = 0; c < kWideConsumers; ++c) {  // a half block's second consumer takes the first one's rows
      const int row = c * kTileRows < rows ? c * kTileRows : 0;
      copy_tile<E, D>(own0 + c * kOwn, policy.q_rows + (size_t)row * D, ptid);
    }
#pragma unroll 1
    for (int t = 0; t <= tiles; ++t) {  // K_t (t < tiles), then V_{t-1} (t > 0); tile t waits for t - kS's release
      if (t < tiles) {
        const int s = t % kS;
        if (t >= kS) mbar_wait(empty_k + 8 * s, (t / kS + 1) & 1);
        copy_tile<E, D>(k_ring + s * kKBytes, policy.k_head + (size_t)t * kTileRows * D, ptid);
        mbar_arrive_copies(full_k + 8 * s);
      }
      if (t > 0) {
        const int u = t - 1, s = u % kS;
        if (u >= kS) mbar_wait(empty_v + 8 * s, (u / kS + 1) & 1);
        copy_tile<T, D>(v_ring + s * L::kBytes, v_head + (size_t)u * kTileRows * D, ptid);
        mbar_arrive_copies(full_v + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives its thread
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideConsumerRegs));
  const int c = tid / kWgThreads, warp = (tid % kWgThreads) / 32, lane = tid % 32;
  const uint32_t q_s = own0 + c * kOwn;
  auto take_k = [&](int t) { mbar_wait(full_k + 8 * (t % kS), (t / kS) & 1); };
  auto take_v = [&](int t) { mbar_wait(full_v + 8 * (t % kS), (t / kS) & 1); };
  auto start_scores = [&](Score(&s)[kTileRows / 2], int tile) {  // asynchronous
    fence_regs(s);
    wgmma_fence();
    policy.start(s, q_s, k_ring + (tile % kS) * kKBytes);
    wgmma_commit();
  };

  float acc[L::kPanels][L::kAccRegs];  // never zeroed: the first P V overwrites it
  float l[2] = {0.f, 0.f};
  uint32_t p[kTileRows / 4];

  take_k(0);
  fence_async_proxy();  // the copies landed through the generic proxy; wgmma reads through the async one
  {
    Score s[kTileRows / 2];
    start_scores(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty_k);
    policy.exp_pack(s, l, p);
  }
  for (int j = 0; j + 1 < tiles; ++j) {
    take_k(j + 1);
    take_v(j);
    fence_async_proxy();
    Score s[kTileRows / 2];
    uint32_t p_next[kTileRows / 4];
    start_scores(s, j + 1);
    wgmma_fence();
    mma_regs_tile192<T>(acc, p, v_ring + (j % kS) * L::kBytes, j > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S_{j+1} is done; p_j V_j may still run
    fence_regs(s);
    mbar_arrive(empty_k + 8 * ((j + 1) % kS));
    policy.exp_pack(s, l, p_next);
    wgmma_wait<0>();  // p_j V_j is done: p and V_j are free
    fence_regs(p);    // as in flash_fwd_loop.cuh: p stays alive up to the wait
    fence_regs(p_next);
    mbar_arrive(empty_v + 8 * (j % kS));
#pragma unroll
    for (int i = 0; i < kTileRows / 4; ++i) p[i] = p_next[i];
  }
  take_v(tiles - 1);
  fence_async_proxy();
  wgmma_fence();
  mma_regs_tile192<T>(acc, p, v_ring + ((tiles - 1) % kS) * L::kBytes, tiles > 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (c * kTileRows >= rows) return;  // a half block's second consumer: the first one's rows again
  if (l_block != nullptr && lane % 4 == 0) {
    l_block[c * kTileRows + warp * 16 + lane / 4] = l[0];
    l_block[c * kTileRows + warp * 16 + lane / 4 + 8] = l[1];
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows<T, D>(acc, inv, q_s, o_block + (size_t)c * kTileRows * D, warp, lane);
}

}  // namespace wcflash
