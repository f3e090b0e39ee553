// Hopper building blocks of the flash kernels K1 (flash_fwd.cu), K2
// (flash_fwd_qk_i8.cu), K3 (flash_bwd.cu) and K4 (probe_exp2_attn.cu):
// swizzled shared-memory tiles filled by 16-byte cp.async, wgmma descriptors
// over them, and the warpgroup MMA itself.
//
// A tile is 64 rows of one head, D wide, 16-bit elements (or int8, below),
// kept the way it lies in global memory (row-major, d contiguous) but cut into panels of
// at most 64 columns (128 bytes a row) and swizzled, so that one copy of it
// serves both operand forms of wgmma:
//   * K-major (the reduction runs along d): A of Q K^T, B of Q K^T and dO V^T;
//   * MN-major (the reduction runs along the rows, descriptor transpose
//     bit set): B of P V, m K, p^T dO and m^T Q, taken as loaded.
// No operand is ever staged transposed.
//   D = 16: one panel, 32-byte rows, 32-byte swizzle
//   D = 32: one panel, 64-byte rows, 64-byte swizzle
//   D = 64: one panel, 128-byte rows, 128-byte swizzle
//   D = 128: two panels of 64 columns, 128-byte swizzle each
//   D = 24 (K1 only): a D = 32 tile whose rows get three 16-byte chunks
//     of data and a fourth of zeros, in the same copies
//     (`load_tile_async<T, 32, 24>`: cp.async with src-size 0), so the extra
//     Q K^T terms are exactly 0 and P V's columns 24-31 are 0 and never stored
// An int8 tile (Tile<D, 1>: Q8 and K8 of K2, K-major operands only, which is
// all integer wgmma takes) has rows of D bytes and is one panel at every D:
//   D = 128/64/32: 128/64/32-byte rows and swizzle, D/32 k-steps of 32 bytes
//   D = 16: 32-byte rows whose data is one 16-byte chunk; the other chunk
//     must be zero (a k32 step reads 32 bytes a row) and no copy writes it
//   D = 24 (K2 at the legacy UNet's attn_up2): a D = 32 tile whose 24-byte
//     rows come in three 8-byte copies and a fourth that zero-fills, as K1's
//     D = 24 rows do, so the one k32 step adds exactly 0 past d = 24
//   D = 192 (the 256 px UNet): three panels of 64 columns (64-byte rows and
//     swizzle, six k-steps), as K1's D = 192 tile is three panels
// The swizzle is the tensor cores' own (Swizzle<B,4,3>): bits [7, 7+B) of
// the byte address are XORed into bits [4, 4+B). Tiles start on 1024-byte
// boundaries, so offsets within a tile swizzle like addresses.
//
// Accumulator layout of wgmma m64nNk16 (f32) and m64nNk32 (s32), per warp w of the warpgroup and
// lane = 4*g + t: register 4*j + e of the N/2 holds row 16*w + g + 8*(e >> 1),
// column 8*j + 2*t + (e & 1). Registers 8*c .. 8*c+7, packed in pairs, are the
// A fragment of the 16-deep chunk c, so p and m go from one product's
// accumulators into the next product's A operand without leaving registers.
#pragma once

#include "flash_common.cuh"

namespace wcflash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClampLog2 = kClamp * kLog2e;  // the clamp in the exp2 domain
constexpr int kWgThreads = 128;                // one warpgroup
constexpr int kTileRows = 64;                  // rows of a streamed tile, and of a warpgroup's own tile

template <int D, int kElemBytes = 2>
struct Tile {
  static constexpr int kElemsPerChunk = 16 / kElemBytes;  // a chunk is 16 bytes
  // panels of 128 bytes a row; int8 at D = 192 (192-byte rows) takes three of 64 bytes instead
  static constexpr int kPanelCols = D * kElemBytes < 128         ? D
                                    : (D * kElemBytes) % 128 == 0 ? 128 / kElemBytes
                                                                  : 64 / kElemBytes;
  static constexpr int kPanels = D / kPanelCols;
  static constexpr int kDataRowBytes = kPanelCols * kElemBytes;
  static constexpr int kRowBytes = kDataRowBytes < 32 ? 32 : kDataRowBytes;  // padded at int8, D = 16
  static constexpr int kSwizzleMask = kRowBytes / 16 - 1;  // 1, 3, 7: B bits of Swizzle<B,4,3>
  static constexpr uint64_t kLayoutType = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kSbo = 8 * kRowBytes;  // bytes from one 8-row group to the next
  static constexpr int kChunksPerPanelRow = kDataRowBytes / 16;
  static constexpr int kChunksPerRow = D / kElemsPerChunk;
  static constexpr int kKSteps = kPanels * kRowBytes / 32;  // 32-byte reduction steps over all of d
  static constexpr int kAccRegs = kPanelCols / 2;  // f32 accumulators a thread per panel (m64, N = kPanelCols)

  static constexpr int kPanelBytes = kTileRows * kRowBytes;
  static constexpr int kBytes = kPanels * kPanelBytes;  // a whole tile: every panel

  // Byte offset inside a panel of 16-byte chunk `chunk` of row `row`.
  static __device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
    const uint32_t off = row * kRowBytes + chunk * 16;
    return off ^ (((off >> 7) & kSwizzleMask) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
// The same, or 16 zero bytes when !`data` (src-size 0: nothing is read, but
// `src` must still be a valid address). One instruction either way, the
// choice a select. (K1 at D = 24 with an if/else between a copy and a
// zero-filling copy, and again with the tails zeroed once in the prologue
// and three copies a row, which needs a guard, had every wgmma serialized by
// ptxas, C7513; this form has not.)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool data) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(data ? 16 : 0)
               : "memory");
}
// 8 bytes, or 8 zero bytes when !`data` (cp.async.cg copies 16 bytes only, so
// this is the .ca form). One instruction either way, the choice a select.
__device__ __forceinline__ void cp_async8_zfill(uint32_t dst, const void* src, bool data) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(data ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// Makes shared-memory writes of this thread (cp.async, st.shared) visible to
// the asynchronous proxy through which wgmma reads its operands.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The 64 rows at `src` (row stride G, the tensor's head dim) into the tile at
// shared address `dst`, by the block's 128 threads, 16 bytes a copy,
// coalesced. T is a 16-bit type or int8_t; only the data chunks of a padded
// int8 row are written. G < D (D = 32, G = 24) fills each row's chunks past
// G with zeros in the same copies, by select, never a branch. A row that is
// not whole 16-byte chunks (int8 at G = 24: 24 bytes) is copied in 8-byte
// pieces instead (load_tile_async8).
template <typename T, int D, int G>
__device__ __forceinline__ void load_tile_async8(uint32_t dst, const T* __restrict__ src, int tid) {
  using L = Tile<D, sizeof(T)>;
  static_assert(L::kPanels == 1 && G < D && (G * sizeof(T)) % 8 == 0, "one panel of whole 8-byte pieces");
  constexpr int kPieceElems = 8 / sizeof(T);
  constexpr int kPiecesPerRow = L::kDataRowBytes / 8;
  constexpr int kDataPieces = G / kPieceElems;  // pieces a row holds in global memory
  constexpr int kPieces = kTileRows * kPiecesPerRow;
#pragma unroll
  for (int i0 = 0; i0 < kPieces; i0 += kWgThreads) {
    const int i = i0 + tid;
    if (kPieces % kWgThreads != 0 && i >= kPieces) break;
    const int row = i / kPiecesPerRow, piece = i % kPiecesPerRow;
    const bool data = piece < kDataPieces;
    cp_async8_zfill(dst + L::swizzled(row, piece / 2) + (piece % 2) * 8,
                    src + (size_t)row * G + (data ? piece : 0) * kPieceElems, data);
  }
}

template <typename T, int D, int G = D>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const T* __restrict__ src, int tid) {
  using L = Tile<D, sizeof(T)>;
  if constexpr ((G * sizeof(T)) % 16 != 0) {
    load_tile_async8<T, D, G>(dst, src, tid);
  } else {
    static_assert(G <= D, "a row fits its tile");
    constexpr int kChunks = kTileRows * L::kChunksPerRow;  // 64 at int8, D = 16, else a multiple of 128
    constexpr int kDataChunks = G / L::kElemsPerChunk;     // chunks a row holds in global memory
#pragma unroll
    for (int i0 = 0; i0 < kChunks; i0 += kWgThreads) {
      const int i = i0 + tid;
      if (kChunks % kWgThreads != 0 && i >= kChunks) break;
      const int row = i / L::kChunksPerRow, c = i % L::kChunksPerRow;
      const int panel = c / L::kChunksPerPanelRow, pc = c % L::kChunksPerPanelRow;
      const uint32_t at = dst + panel * L::kPanelBytes + L::swizzled(row, pc);
      if constexpr (G == D) {
        cp_async16(at, src + (size_t)row * D + c * L::kElemsPerChunk);
      } else {
        const bool data = c < kDataChunks;
        cp_async16_zfill(at, src + (size_t)row * G + (data ? c : 0) * L::kElemsPerChunk, data);
      }
    }
  }
}

// Zeroes the pad chunk of every row of `tiles` consecutive padded tiles (int8,
// D = 16) from `dst` on. A slot's pad positions are the same for every tile
// that passes through it and no copy writes them, so once a kernel is enough.
template <typename L>
__device__ __forceinline__ void zero_row_padding(uint32_t dst, int tiles, int tid) {
  if constexpr (L::kRowBytes != L::kDataRowBytes) {
    for (int i = tid; i < tiles * kTileRows; i += kWgThreads)
      asm volatile("st.shared.v4.b32 [%0], {%1,%1,%1,%1};\n" ::"r"(dst + (i / kTileRows) * L::kBytes +
                                                                   L::swizzled(i % kTileRows, 1)),
                   "r"(0)
                   : "memory");
  }
}

// 64 f32 values into shared memory, unswizzled.
__device__ __forceinline__ void load_f32_async(uint32_t dst, const float* __restrict__ src, int tid) {
  if (tid < kTileRows / 4) cp_async16(dst + tid * 16, src + tid * 4);
}

// The 64-bit shared-memory matrix descriptor of wgmma: address, leading and
// stride byte offsets in 16-byte units, swizzle mode in bits 62-63.
template <typename L>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(L::kSbo >> 4) << 32) | (L::kLayoutType << 62);
}

// K-major operand: rows from `row0` on (64 as A, N as B) of a tile, the
// 32-byte chunk `ks` of d (16 16-bit elements, 32 of int8). Swizzled K-major
// layouts ignore the leading offset.
template <int D, int kElemBytes = 2>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int row0, int ks) {
  using L = Tile<D, kElemBytes>;
  const int byte = ks * 32;
  return make_desc<L>(tile + (byte / L::kRowBytes) * L::kPanelBytes + row0 * L::kRowBytes + byte % L::kRowBytes,
                      16);
}

// MN-major B operand (transpose bit set): panel `panel` of a tile, the 16-row
// chunk `kc` of its rows: N = kPanelCols columns of d, K = 16 rows.
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int panel, int kc) {
  using L = Tile<D>;
  return make_desc<L>(tile + panel * L::kPanelBytes + kc * 16 * L::kRowBytes, L::kPanelBytes);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Pins the accumulators in place in the instruction stream: the compiler may
// not move a read or write of them across this point (the MMAs are asynchronous).
template <int kRegs>
__device__ __forceinline__ void fence_regs(float (&d)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for packed A fragments: an MMA in flight still reads them.
template <int kRegs>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[kRegs]) {
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+r"(a[i])::"memory");
}
template <int kRegs>
__device__ __forceinline__ void fence_regs(int (&d)[kRegs]) {  // s32 accumulators
#pragma unroll
  for (int i = 0; i < kRegs; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int kPanels, int kRegs>
__device__ __forceinline__ void fence_regs(float (&d)[kPanels][kRegs]) {
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) fence_regs(d[pn]);
}

#define WC_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WC_D8(d, i) WC_D4(d, i), WC_D4(d, i + 4)
#define WC_D16(d, i) WC_D8(d, i), WC_D8(d, i + 8)
#define WC_D32(d, i) WC_D16(d, i), WC_D16(d, i + 16)
#define WC_R8 "{%0,%1,%2,%3,%4,%5,%6,%7}"
#define WC_R16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define WC_R32                                                                         \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22," \
  "%23,%24,%25,%26,%27,%28,%29,%30,%31}"

// d (64 x N, f32) = or += A (64 x 16) . B (16 x N). `accumulate` = 0 overwrites d.
// _ss: A and B from shared memory, both K-major. _rs: A from registers (four
// packed pairs, the mma.sync A fragment of this warp's 16 rows), B from
// shared memory, MN-major when kTransB = 1.
#define WC_DEFINE_WGMMA(SUFFIX, TYPE)                                                                          \
  __device__ __forceinline__ void wgmma_ss_##SUFFIX(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                  \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " " WC_R32                        \
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                                             \
                 : WC_D32(d, 0)                                                                                \
                 : "l"(a), "l"(b), "r"(accumulate));                                                           \
  }                                                                                                            \
  __device__ __forceinline__ void wgmma_ss_##SUFFIX(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                  \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPE "." TYPE " " WC_R16                        \
                 ", %16, %17, p, 1, 1, 0, 0;\n}\n"                                                             \
                 : WC_D16(d, 0)                                                                                \
                 : "l"(a), "l"(b), "r"(accumulate));                                                           \
  }                                                                                                            \
  template <int kTransB>                                                                                       \
  __device__ __forceinline__ void wgmma_rs_##SUFFIX(float (&d)[32], const uint32_t* a, uint64_t b,             \
                                                    int accumulate) {                                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                  \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPE "." TYPE " " WC_R32                        \
                 ", {%32,%33,%34,%35}, %36, p, 1, 1, %38;\n}\n"                                                \
                 : WC_D32(d, 0)                                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));         \
  }                                                                                                            \
  template <int kTransB>                                                                                       \
  __device__ __forceinline__ void wgmma_rs_##SUFFIX(float (&d)[16], const uint32_t* a, uint64_t b,             \
                                                    int accumulate) {                                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                  \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPE "." TYPE " " WC_R16                        \
                 ", {%16,%17,%18,%19}, %20, p, 1, 1, %22;\n}\n"                                                \
                 : WC_D16(d, 0)                                                                                \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));         \
  }                                                                                                            \
  template <int kTransB>                                                                                       \
  __device__ __forceinline__ void wgmma_rs_##SUFFIX(float (&d)[8], const uint32_t* a, uint64_t b,              \
                                                    int accumulate) {                                          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                                  \
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPE "." TYPE " " WC_R8                         \
                 ", {%8,%9,%10,%11}, %12, p, 1, 1, %14;\n}\n"                                                  \
                 : WC_D8(d, 0)                                                                                 \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(kTransB));         \
  }

WC_DEFINE_WGMMA(bf16, "bf16")
WC_DEFINE_WGMMA(f16, "f16")
#undef WC_DEFINE_WGMMA

// d (64 x 64, s32) = or += A (64 x 32, int8) . B (32 x 64, int8), both from
// shared memory. Integer wgmma takes K-major operands only and has neither
// transpose nor negate immediates, so its operand list ends at the predicate.
#define WC_I4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define WC_I16(d, i) WC_I4(d, i), WC_I4(d, i + 4), WC_I4(d, i + 8), WC_I4(d, i + 12)
__device__ __forceinline__ void wgmma_ss_s8(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WC_R32 ", %32, %33, p;\n}\n"
               : WC_I16(d, 0), WC_I16(d, 16)
               : "l"(a), "l"(b), "r"(accumulate));
}

template <typename T>
struct Wgmma;
template <>
struct Wgmma<__nv_bfloat16> {
  template <int kRegs>
  static __device__ __forceinline__ void ss(float (&d)[kRegs], uint64_t a, uint64_t b, int accumulate) {
    wgmma_ss_bf16(d, a, b, accumulate);
  }
  template <int kTransB, int kRegs>
  static __device__ __forceinline__ void rs(float (&d)[kRegs], const uint32_t* a, uint64_t b, int accumulate) {
    wgmma_rs_bf16<kTransB>(d, a, b, accumulate);
  }
};
template <>
struct Wgmma<__half> {
  template <int kRegs>
  static __device__ __forceinline__ void ss(float (&d)[kRegs], uint64_t a, uint64_t b, int accumulate) {
    wgmma_ss_f16(d, a, b, accumulate);
  }
  template <int kTransB, int kRegs>
  static __device__ __forceinline__ void rs(float (&d)[kRegs], const uint32_t* a, uint64_t b, int accumulate) {
    wgmma_rs_f16<kTransB>(d, a, b, accumulate);
  }
};

// s (64 x 2*kRegs) = A . B^T over all of d: A the 64 rows of tile `a_tile`,
// B rows [b_row0, b_row0 + 2*kRegs) of tile `b_tile`, both K-major. Queues
// D/16 MMAs; the caller fences, commits and waits.
template <typename T, int D, int kRegs>
__device__ __forceinline__ void mma_rows_rows_t(float (&s)[kRegs], uint32_t a_tile, uint32_t b_tile, int b_row0) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    Wgmma<T>::ss(s, desc_kmajor<D>(a_tile, 0, ks), desc_kmajor<D>(b_tile, b_row0, ks), ks > 0);
}

// The same with A from registers: a[4*ks ..] is the A fragment of this warp's
// 16 rows for the 16-deep chunk ks of d; B the first 64 rows of `b_tile`, K-major.
template <typename T, int D>
__device__ __forceinline__ void mma_regs_rows_t(float (&s)[kTileRows / 2], const uint32_t* a, uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) Wgmma<T>::template rs<0>(s, a + 4 * ks, desc_kmajor<D>(b_tile, 0, ks), ks > 0);
}

// s (64 x 64, s32) = A . B^T over all of d in int8: the 64 rows of the int8
// tiles `a_tile` and `b_tile`, K-major. Queues D/32 MMAs (one at D = 16, over
// the zero-padded rows).
template <int D>
__device__ __forceinline__ void mma_rows_rows_t_s8(int (&s)[kTileRows / 2], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < Tile<D, 1>::kKSteps; ++ks)
    wgmma_ss_s8(s, desc_kmajor<D, 1>(a_tile, 0, ks), desc_kmajor<D, 1>(b_tile, 0, ks), ks > 0);
}

// acc[panel] (64 x D) += A (64 x 16*kChunks, register fragments a[4*c ..]) .
// B rows [b_row0, b_row0 + 16*kChunks) of tile `b_tile`, taken as
// loaded (MN-major). With `accumulate` = 0 the first chunk overwrites acc, which
// then needs no zeroing: ptxas serializes every wgmma of a kernel in which
// another instruction writes accumulator registers between a wgmma.fence and
// the wait that retires its MMAs, and a zeroing the compiler sinks to the
// first use lands exactly there.
template <typename T, int D, int kChunks>
__device__ __forceinline__ void mma_regs_tile(float (&acc)[Tile<D>::kPanels][Tile<D>::kAccRegs], const uint32_t* a,
                                              uint32_t b_tile, int b_row0, int accumulate = 1) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int pn = 0; pn < Tile<D>::kPanels; ++pn)
      Wgmma<T>::template rs<1>(acc[pn], a + 4 * c, desc_mnmajor<D>(b_tile, pn, b_row0 / 16 + c),
                               c == 0 ? accumulate : 1);
  }
}

__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// This warp's 16 rows of a 64-row accumulator set (row stride G in global
// memory, its first G of D columns), times mul[0] (row g) and mul[1] (row
// g + 8), cast to T: staged in the swizzled 64-row tile at shared address
// `stage`, then written with 16-byte stores. Only this warp touches its 16
// rows, so a warp barrier suffices.
template <typename T, int D, int G = D>
__device__ __forceinline__ void store_rows(const float (&acc)[Tile<D>::kPanels][Tile<D>::kAccRegs],
                                           const float mul[2], uint32_t stage, T* __restrict__ dst, int warp,
                                           int lane) {
  using L = Tile<D>;
  const int g = lane >> 2, t = lane & 3;
  const int r = warp * 16 + g;
#pragma unroll
  for (int pn = 0; pn < L::kPanels; ++pn) {
#pragma unroll
    for (int j = 0; j < L::kAccRegs / 4; ++j) {
      const uint32_t lo = Mma<T>::pack(acc[pn][4 * j] * mul[0], acc[pn][4 * j + 1] * mul[0]);
      const uint32_t hi = Mma<T>::pack(acc[pn][4 * j + 2] * mul[1], acc[pn][4 * j + 3] * mul[1]);
      const uint32_t base = stage + pn * L::kPanelBytes + 4 * t;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(base + L::swizzled(r, j)), "r"(lo) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(base + L::swizzled(r + 8, j)), "r"(hi) : "memory");
    }
  }
  __syncwarp();
  constexpr int kOutChunks = G / 8;  // 16-byte chunks of an output row
#pragma unroll
  for (int i0 = 0; i0 < 16 * kOutChunks; i0 += 32) {
    const int i = i0 + lane;
    if ((16 * kOutChunks) % 32 != 0 && i >= 16 * kOutChunks) break;
    const int row = warp * 16 + i / kOutChunks, c = i % kOutChunks;
    const int panel = c / L::kChunksPerPanelRow, pc = c % L::kChunksPerPanelRow;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(stage + panel * L::kPanelBytes + L::swizzled(row, pc))
                 : "memory");
    *reinterpret_cast<uint4*>(dst + (size_t)row * G + c * 8) = val;
  }
}

}  // namespace wcflash
