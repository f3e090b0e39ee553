// K7: the raw QK^T product in int8 and in bf16, a micro-probe, for sm_90a.
//
// Replaces scripts/probe_int8_dot.py `k_int8` (:24) and `k_bf16` (:34), via
// `build(...).run` (:47):
//   S = Q K^T, (B, N, D) x (B, N, D) -> (B, N, N), int8 -> int32 and bf16 -> f32,
// the whole N x N written out.
//
// The probe's question: what is the int8 rate against the bf16 rate of this
// product on this card? What bounds it: each call writes 4*B*N^2 bytes (64
// MiB at B=1, N=4096) for 2*B*N^2*D operations (2.1 G at D=64): 32 operations
// per byte written, far below the tensor cores' ~295 (bf16) or ~590 (int8)
// per byte of device memory. So both forms are bound by the writes, and this
// shape cannot show int8's twice-the-bf16 tensor rate.
//
// What the design does about it: the kernel is built around the store path.
//   * A persistent grid: as many blocks as fit on the SMs, each walking a
//     contiguous run of 64 x 128 output tiles, so consecutive tiles share the
//     Q row panel, which stays in registers (mma.sync A fragments) until the
//     row changes. K tiles (128 rows) come through a two-stage cp.async ring:
//     tile i+1's K lands while tile i is multiplied.
//   * Each finished tile goes to shared memory (rows padded by 32 bytes, so
//     the accumulators' 8-byte stores are conflict-free) and leaves by the
//     TMA engine: one bulk copy a row (cp.async.bulk.global.shared::cta, 512
//     bytes, whole 128-byte lines), with an evict_first L2 policy, so the
//     64 MiB output streams through the 50 MB L2 without displacing the Q and
//     K lines the next tiles read.
//   * The staging is double-buffered: a tile's bulk copies run while the
//     block multiplies the next tile; a buffer is written again only after
//     its copies have read it (cp.async.bulk.wait_group.read).
//   * The product stays on mma.sync (m16n8k32 s8, m16n8k16 bf16; fragment
//     layouts in flash_common.cuh): 2.1 G operations are ~1 us at the int8
//     peak, so wgmma would buy nothing here. int8 and bf16 share the schedule
//     and the epilogue; a policy (I8, Bf16) holds what differs, the MMA and
//     its operand widths.
//   * N = 64 * odd ends each row of tiles with one 64 columns wide: its K
//     tile has 64 rows loaded, the product runs over all 128 (the unused
//     columns' values are never copied out), and its bulk copies are 256 bytes.
//
// What this design took out (the kernel's first version): one 128-thread
// block per 64 x 64 tile (4,096 blocks at N = 4096), Q read into fragments
// from global memory by every block, and each 8-column group's accumulators
// stored straight from registers as 8-byte stores strided over 8 rows.
// NVIDIA H100 80GB HBM3, 700 W, (1, 4096, 64), both versions timed in one
// process (probes/probe_int8_dot.py OTHER_ROOT): the first version int8
// 0.0318 ms and bf16 0.0390 ms, this design 0.0288 and 0.0341 (70 % and 59 %
// of the bytes bound); torch._int_mm 0.0277 ms and torch.mm(out_dtype=
// torch.float32) 0.0290 ms in the same run (PERF.md section 6).
#include "flash_wgmma.cuh"

namespace wcprobe {
namespace {

using namespace wcflash;

constexpr int kTileM = 64;    // output rows a tile: 4 warps x 16, the Q row panel
constexpr int kTileN = 128;   // output columns a tile (64 in the last of a row at N = 64 * odd)
constexpr int kThreadsK7 = 128;
constexpr int kOutStride = kTileN + 8;              // 32-bit words a staged output row
constexpr int kOutWords = kTileM * kOutStride;      // one staged output tile
constexpr int kOutBytes = kOutWords * 4;

// The MMA policies, all that differs between the two forms.
struct I8 {
  using In = int8_t;
  using Acc = int32_t;
  static constexpr int kDepth = 32;  // k of one m16n8k32
  static constexpr int kPad = 16;    // elements of K-row padding: conflict-free b loads
  static __device__ __forceinline__ void mma(Acc c[4], const uint32_t a[4], const uint32_t b[2]) { mma_s8(c, a, b); }
  static __device__ __forceinline__ void store2(Acc* p, const Acc c0, const Acc c1) {
    *reinterpret_cast<int2*>(p) = make_int2(c0, c1);
  }
};

struct Bf16 {
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr int kDepth = 16;  // k of one m16n8k16
  static constexpr int kPad = 8;
  static __device__ __forceinline__ void mma(Acc c[4], const uint32_t a[4], const uint32_t b[2]) {
    Mma<__nv_bfloat16>::run(c, a, b);
  }
  static __device__ __forceinline__ void store2(Acc* p, const Acc c0, const Acc c1) {
    *reinterpret_cast<float2*>(p) = make_float2(c0, c1);
  }
};

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
// `bytes` (a multiple of 16) from shared address `src` to global `dst`, both
// 16-byte aligned, by the TMA engine, in this thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes, uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
               ::"l"(dst), "r"(src), "r"(bytes), "l"(policy)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// All but this thread's newest kPending bulk groups have read their shared memory.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}
// All of this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

template <typename P, int D>
__host__ __device__ constexpr int stage_bytes() {
  return kTileN * (D + P::kPad) * static_cast<int>(sizeof(typename P::In));
}

template <typename P, int D>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * kOutBytes + 2 * stage_bytes<P, D>();
}

struct TileCoords {
  int b, row0, col0;
};

__device__ __forceinline__ TileCoords tile_coords(long long tile, int n) {
  const int col_tiles = (n + kTileN - 1) / kTileN;
  const long long per_head = static_cast<long long>(n / kTileM) * col_tiles;
  const int b = static_cast<int>(tile / per_head);
  const int rem = static_cast<int>(tile - b * per_head);
  return {b, (rem / col_tiles) * kTileM, (rem % col_tiles) * kTileN};
}

// The (up to) 128 K rows of `tile` into stage `stage`, 16 bytes a cp.async; one commit group.
template <typename P, int D>
__device__ __forceinline__ void load_k(const typename P::In* __restrict__ k, uint32_t k_s, long long tile, int stage,
                                       int n, int tid) {
  using In = typename P::In;
  constexpr int kVecPerRow = D * static_cast<int>(sizeof(In)) / 16;
  constexpr int kRowBytes = (D + P::kPad) * static_cast<int>(sizeof(In));
  const TileCoords c = tile_coords(tile, n);
  const int rows = min(kTileN, n - c.col0);
  const In* src = k + (static_cast<size_t>(c.b) * n + c.col0) * D;
  const uint32_t dst = k_s + stage * stage_bytes<P, D>();
  for (int i = tid; i < rows * kVecPerRow; i += kThreadsK7) {
    const int r = i / kVecPerRow, v = i % kVecPerRow;
    cp_async16(dst + r * kRowBytes + v * 16, src + static_cast<size_t>(r) * D + v * (16 / sizeof(In)));
  }
  cp_async_commit();
}

template <typename P, int D>
__global__ void __launch_bounds__(kThreadsK7)
    probe_qk_kernel(const typename P::In* __restrict__ q, const typename P::In* __restrict__ k,
                    typename P::Acc* __restrict__ s, int n, long long tiles) {
  using In = typename P::In;
  using Acc = typename P::Acc;
  constexpr int kChunks = D / P::kDepth;
  constexpr int kKStride = D + P::kPad;                     // elements a staged K row
  constexpr int kPer = 4 / static_cast<int>(sizeof(In));    // elements in one 32-bit fragment register
  extern __shared__ __align__(128) unsigned char smem[];
  Acc* out_s = reinterpret_cast<Acc*>(smem);                // two staged output tiles
  const In* k_s = reinterpret_cast<const In*>(smem + 2 * kOutBytes);  // two staged K tiles

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this block's contiguous run of tiles
  const long long first = tiles * blockIdx.x / gridDim.x, last = tiles * (blockIdx.x + 1) / gridDim.x;
  if (first >= last) return;
  const uint32_t k_s_addr = smem_u32(k_s);
  const uint64_t policy = evict_first_policy();

  load_k<P, D>(k, k_s_addr, first, 0, n, tid);
  uint32_t qa[kChunks][4];
  long long q_panel = -1;
  for (long long tile = first; tile < last; ++tile) {
    const int buf = static_cast<int>(tile - first) & 1;
    const TileCoords c = tile_coords(tile, n);
    // output buffer `buf` was sent two tiles ago: its bulk copies must have read it
    if (tid < kTileM) bulk_wait_read<1>();
    cp_async_wait<0>();
    // K stage `buf` has landed, output buffer `buf` is free, every warp is done with K stage buf ^ 1
    __syncthreads();
    if (tile + 1 < last) load_k<P, D>(k, k_s_addr, tile + 1, buf ^ 1, n, tid);

    const long long panel = static_cast<long long>(c.b) * n + c.row0;
    if (panel != q_panel) {
      q_panel = panel;
      const In* qw = q + (static_cast<size_t>(panel) + warp * 16) * D;
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) {
        const int col = kc * P::kDepth + kPer * t;
        qa[kc][0] = ld32(qw + g * D + col);
        qa[kc][1] = ld32(qw + (g + 8) * D + col);
        qa[kc][2] = ld32(qw + g * D + col + P::kDepth / 2);
        qa[kc][3] = ld32(qw + (g + 8) * D + col + P::kDepth / 2);
      }
    }

    Acc* orow = out_s + buf * kOutWords + (warp * 16 + g) * kOutStride + 2 * t;
    const In* kb = k_s + buf * (stage_bytes<P, D>() / static_cast<int>(sizeof(In))) + g * kKStride + kPer * t;
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt) {
      Acc acc[4] = {0, 0, 0, 0};
      const In* krow = kb + nt * 8 * kKStride;
#pragma unroll
      for (int kc = 0; kc < kChunks; ++kc) {
        const uint32_t b[2] = {ld32(krow + kc * P::kDepth), ld32(krow + kc * P::kDepth + P::kDepth / 2)};
        P::mma(acc, qa[kc], b);
      }
      P::store2(orow + nt * 8, acc[0], acc[1]);
      P::store2(orow + 8 * kOutStride + nt * 8, acc[2], acc[3]);
    }
    // the staged tile goes to the TMA engine, which reads shared memory through the async proxy
    fence_async_proxy();
    __syncthreads();
    if (tid < kTileM) {
      const int cols = min(kTileN, n - c.col0);
      bulk_store(s + (static_cast<size_t>(c.b) * n + c.row0 + tid) * n + c.col0,
                 smem_u32(out_s + buf * kOutWords + tid * kOutStride), cols * 4, policy);
      bulk_commit();
    }
  }
  // shared memory must outlive the copies that read it
  if (tid < kTileM) bulk_wait_all();
}

template <typename P, int D>
cudaError_t launch(const void* q, const void* k, void* s, int b, int n, cudaStream_t stream) {
  using In = typename P::In;
  constexpr int kSmem = smem_bytes<P, D>();
  // the grid fills the card once; queried on the first launch of each instantiation
  static int grid_cap = 0;
  if (grid_cap == 0) {
    cudaError_t err = cudaFuncSetAttribute(probe_qk_kernel<P, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_qk_kernel<P, D>, kThreadsK7, kSmem);
    if (err != cudaSuccess) return err;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles = static_cast<long long>(b) * (n / kTileM) * ((n + kTileN - 1) / kTileN);
  const int grid = static_cast<int>(tiles < grid_cap ? tiles : grid_cap);
  probe_qk_kernel<P, D><<<grid, kThreadsK7, kSmem, stream>>>(static_cast<const In*>(q), static_cast<const In*>(k),
                                                              static_cast<typename P::Acc*>(s), n, tiles);
  return cudaGetLastError();
}

bool valid(int b, int n) { return b > 0 && b <= 65535 && n > 0 && n % kTileM == 0 && n / kTileM <= 65535; }

}  // namespace
}  // namespace wcprobe

// q, k: contiguous int8 (b, n, d), d in {32, 64, 128}; s: contiguous int32
// (b, n, n). Returns the cudaError_t of the launch.
extern "C" int wc_probe_qk_i8(const void* q, const void* k, void* s, int b, int n, int d, void* stream) {
  using namespace wcprobe;
  if (!valid(b, n)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<I8, 32>(q, k, s, b, n, st);
    case 64: return launch<I8, 64>(q, k, s, b, n, st);
    case 128: return launch<I8, 128>(q, k, s, b, n, st);
    default: return cudaErrorInvalidValue;
  }
}

// q, k: contiguous bf16 (b, n, d), d in {32, 64, 128}; s: contiguous f32
// (b, n, n). Returns the cudaError_t of the launch.
extern "C" int wc_probe_qk_bf16(const void* q, const void* k, void* s, int b, int n, int d, void* stream) {
  using namespace wcprobe;
  if (!valid(b, n)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<Bf16, 32>(q, k, s, b, n, st);
    case 64: return launch<Bf16, 64>(q, k, s, b, n, st);
    case 128: return launch<Bf16, 128>(q, k, s, b, n, st);
    default: return cudaErrorInvalidValue;
  }
}
