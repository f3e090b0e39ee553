// 3xTF32 building blocks of the f32 flash kernels K1-f32 and K2-f32
// (flash_fwd_f32.cu) and K3-f32 (flash_bwd_f32.cu): f32 operands on the
// tensor cores with about 21 bits of each product kept.
//
// One TF32 pass would round every operand to 10 bits of mantissa. So each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a product
// is formed as lo*hi + hi*lo + hi*hi, accumulated in f32 (the dropped lo*lo
// term is below 2^-22 of it): three TF32 products at 494.7 TFLOP/s in place
// of one f32 FMA at 67.
//
// The tensor cores' f32 accumulation truncates: a long chain of MMAs into one
// accumulator loses bits that FADD of short partial sums keeps (PERF.md
// section 6 has K1-f32's ablation: one chain over all N keys left O 3-7e-6
// of max |O| from the plain version at N = 1024, a chain of eight k-steps
// 1-2e-6). So every product here runs in chains of at most kChain k-steps
// (12 MMAs), each chain's partial sum joined to the running sum by FADD.
//
// Two designs share these pieces:
//   * mma.sync.m16n8k8.tf32, a warp's 16 rows at a time (the first half of
//     this file): K1-f32's narrow kernel (D = 16, 24) and K2-f32's at D = 16
//     and 24. Operands lie in shared memory as f32 rows padded to D + 4
//     floats, so every fragment load is free of bank conflicts; the narrow
//     kernel splits each staged tile once for the block.
//   * wgmma.mma_async m64nNk8 .tf32 on planes split once a block (the second
//     half, after the note there): K1-f32 and K2-f32 at D = 32-192, K3-f32
//     at every head dim (at D = 192 its own rows raw, split as each register
//     fragment loads: flash_bwd_f32.cu's pair design).
//
// mma.sync.m16n8k8 with .tf32 (PTX ISA), lane = 4*g + t:
//   A (16x8):  a0 (row g, col t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//   B (8x8):   b0 (k t, n g)      b1 (k t+4, n g)
//   C (16x8):  c0, c1 (row g, cols 2t, 2t+1)   c2, c3 (row g+8, cols 2t, 2t+1)
// A score tile's C fragment becomes the next product's A fragment without
// leaving registers: a thread holds columns 2t and 2t+1 of each 8-column
// step, which it feeds as the A fragment's columns t and t+4; the B fragment
// then reads rows 2t and 2t+1 of the step (`load_b_rows`), so the reduction
// pairs them up.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace wctf32 {

constexpr int kChain = 4;  // k-steps of one MMA chain before its FADD join

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to the nearest TF32 value (ties away from zero), its low 13 bits zero.
__device__ __forceinline__ uint32_t tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo to about 2^-22 of x: hi its TF32 rounding, lo that of the (exact) rest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// B fragment of a product whose reduction runs along the staged rows (P V:
// B[k][n] = tile[r0 + key(k)][c0 + n], k = t <- row 2t, k = t + 4 <- row
// 2t + 1), each row times its multiplier, split.
__device__ __forceinline__ void load_b_rows(uint32_t (&bh)[2], uint32_t (&bl)[2], const float* tile, int stride,
                                            int r0, int c0, int g, int t, float mul0, float mul1) {
  const float* r = tile + (r0 + 2 * t) * stride + c0 + g;
  split(r[0] * mul0, bh[0], bl[0]);
  split(r[stride] * mul1, bh[1], bl[1]);
}

// A C fragment (rows g, g + 8; columns 2t, 2t + 1) as the A fragment of the next product, split.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(c[0], ah[0], al[0]);
  split(c[2], ah[1], al[1]);
  split(c[1], ah[2], al[2]);
  split(c[3], ah[3], al[3]);
}

// tot += a tile for a warp's 16 rows: a is kNt split A fragments (16 x kNt*8,
// from `c_to_a`), the tile kNt * 8 staged rows D wide, row r of the tile
// times rmul[r / 8][r % 2] when kRowMul (the rows of step j that a thread
// reads are 8j + 2t and 8j + 2t + 1). tot holds the D / 8 C fragments of the
// result; each one's sum over the tile runs in chains of kChain k-steps,
// each joined to tot by FADD.
template <int D, int kNt, bool kRowMul>
__device__ __forceinline__ void product_nn(float (&tot)[D / 8][4], const uint32_t (&ah)[kNt][4],
                                           const uint32_t (&al)[kNt][4], const float* tile, int stride, int g, int t,
                                           const float (&rmul)[kNt][2]) {
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
#pragma unroll
    for (int j0 = 0; j0 < kNt; j0 += kChain) {
      float acc[4] = {};
#pragma unroll
      for (int j = j0; j < j0 + kChain && j < kNt; ++j) {
        uint32_t bh[2], bl[2];
        if constexpr (kRowMul)
          load_b_rows(bh, bl, tile, stride, 8 * j, 8 * s, g, t, rmul[j][0], rmul[j][1]);
        else
          load_b_rows(bh, bl, tile, stride, 8 * j, 8 * s, g, t, 1.f, 1.f);
        mma_3xtf32(acc, ah[j], al[j], bh[0], bh[1], bl[0], bl[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[s][e] += acc[e];
    }
  }
}

// Copies `rows` rows of D floats (contiguous in global memory) into shared
// rows of `stride` floats with 16-byte cp.async, spread over the block's
// threads; the caller commits.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int stride, int tid, int threads) {
  constexpr int kRowChunks = D / 4;
  for (int i = tid; i < rows * kRowChunks; i += threads)
    wcflash::cp_async16(wcflash::smem_u32(dst + i / kRowChunks * stride + i % kRowChunks * 4), src + 4 * i);
}

// ---------------------------------------------------------------------------
// The Hopper design (K1-f32's and K2-f32's wgmma forward, K3-f32's wgmma
// passes): a block is a producer warpgroup and one or two consumer
// warpgroups (`Team`). The producer loads f32 tiles from global memory,
// splits each element once into TF32 hi and lo and stores the two planes in
// shared memory in the layout the wgmma descriptors read; a consumer owns 64
// rows and runs every product as wgmma.mma_async m64nNk8 with .tf32
// operands, three a k-step (lo*hi + hi*lo + hi*hi), on planes that were
// split once for the block.
//
// wgmma takes tf32 operands K-major only (PTX gives the transpose flags to
// f16/bf16 alone), so a product whose reduction runs along the staged rows
// (P V, m K, p^T dO, m^T Q) reads its B operand from planes the producer wrote
// transposed. Its A operand is p or m, straight from the score product's
// accumulators: wgmma's m64 accumulator is, per warp, the m16n8 C layout, and
// its register A operand for tf32 k8 the mma.sync A layout above, so c_to_a
// turns columns 2t, 2t+1 of an 8-column step into the A columns t, t+4. The
// transposed planes store each 8-row group of the reduction dimension in the
// matching order, column_of(r): rows 0, 2, 4, 6 at columns 0-3 and rows 1, 3,
// 5, 7 at columns 4-7.
//
// Every sum still runs in chains of at most kChain k-steps (twelve MMAs), each
// chain in a fresh accumulator (its first MMA overwrites it), joined to the
// running sum by FADD after a wgmma.wait_group.

// A split operand in shared memory: R rows of C tf32 values, the reduction
// along a row (K-major), in panels of 32 columns (128-byte rows, 128-byte
// swizzle) or at C = 16 one panel of 64-byte rows (64-byte swizzle). Planes
// start on 1024-byte boundaries, so offsets swizzle like addresses.
template <int R, int C>
struct Plane {
  static_assert(R % 8 == 0 && (C == 16 || C % 32 == 0), "whole 8-row groups; one 64-byte or 128-byte panels");
  static constexpr int kPanelCols = C < 32 ? C : 32;
  static constexpr int kRowBytes = kPanelCols * 4;
  static constexpr int kPanelBytes = R * kRowBytes;
  static constexpr int kBytes = C / kPanelCols * kPanelBytes;
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor mode: 128- or 64-byte swizzle
  static constexpr int kMask = kRowBytes / 16 - 1;
  // byte offset of element (r, c): bits [7, 7 + log2(kMask + 1)) XORed into the 16-byte chunk index
  static __device__ __forceinline__ uint32_t at(int r, int c) {
    const uint32_t off = r * kRowBytes + c % kPanelCols * 4;
    return c / kPanelCols * kPanelBytes + (off ^ (((off >> 7) & kMask) << 4));
  }
  // wgmma descriptor of rows r0.. (a multiple of 8), k-step ks (columns 8 ks .. 8 ks + 7): a swizzled K-major
  // operand ignores the leading offset; the stride offset is one 8-row group
  static __device__ __forceinline__ uint64_t desc(uint32_t plane, int r0, int ks) {
    const uint32_t addr = plane + 8 * ks / kPanelCols * kPanelBytes + r0 * kRowBytes + 8 * ks % kPanelCols * 4;
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(8 * kRowBytes >> 4) << 32) |
           (kSwizzle << 62);
  }
};

// Column of a transposed plane that holds staged row r (see above).
__device__ __forceinline__ int column_of(int r) { return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2); }

// The split of a D-wide running sum into n-chunks of at most 64 columns: one m64n16/32/64 MMA each.
template <int D>
struct Cols {
  static constexpr int kNw = D < 64 ? D : 64;
  static constexpr int kNc = D / kNw;
};

// Partial-sum registers a thread may hold in flight in `scores`.
constexpr int kPartRegs = 64;

// A block of kC consumer warpgroups (threads 0 .. 128 kC - 1, 64 own rows each) and one producer warpgroup (the
// last). The producer arrives at a FULL barrier once a plane group is stored, the consumers at its EMPTY barrier
// once their MMAs have read it (named barriers; 0 is __syncthreads'). With two consumers the producer gives up
// registers (setmaxnreg) so that each consumer may hold kConsumerRegs: the kernel is compiled for 384 threads,
// at most 168 registers each, and the warpgroups only trade the block's 168 x 384 registers among themselves (a
// budget past them made setmaxnreg.inc wait forever: the first call of a two-consumer kernel never returned).
enum : int { kFullA = 1, kEmptyA = 2, kFullB = 3, kEmptyB = 4 };

template <int kC, int kProducerRegs = 128>
struct Team {
  static_assert(kC == 1 || kC == 2, "one or two consumer warpgroups");
  static constexpr int kThreads = 128 * (kC + 1);
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;  // what ptxas gives each thread: 168 at 384
  static constexpr int kConsumerRegs = (kLaunchRegs * (kC + 1) - kProducerRegs) / kC / 8 * 8;  // 188 at kC = 2
  static __device__ __forceinline__ bool producer() { return threadIdx.x >= 128 * kC; }
  static __device__ __forceinline__ void sync(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
  }
  static __device__ __forceinline__ void arrive(int id) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
  }
  static __device__ __forceinline__ void producer_regs() {
    if constexpr (kC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
  }
  static __device__ __forceinline__ void consumer_regs() {
    if constexpr (kC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  }
};

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// d (64 x N, f32) = or += A (64 x 8, tf32) . B (8 x N, tf32), B from a descriptor; A from a descriptor (_ss) or
// this warp's mma.sync A fragment (_rs). `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WC_R32 ", %32, %33, p, 1, 1;\n}\n"
               : WC_D32(d, 0)
               : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WC_R16 ", %16, %17, p, 1, 1;\n}\n"
               : WC_D16(d, 0)
               : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WC_R32 ", {%32,%33,%34,%35}, %36, p, 1, 1;\n}\n"
               : WC_D32(d, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WC_R16 ", {%16,%17,%18,%19}, %20, p, 1, 1;\n}\n"
               : WC_D16(d, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " WC_R8 ", {%8,%9,%10,%11}, %12, p, 1, 1;\n}\n"
               : WC_D8(d, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// One 3xTF32 k-step: the two small cross terms first, then hi * hi.
template <class A, int kRegs>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[kRegs], const A& ah, const A& al, uint64_t bh, uint64_t bl,
                                             int accumulate) {
  wgmma_tf32(d, al, bh, accumulate);
  wgmma_tf32(d, ah, bl, 1);
  wgmma_tf32(d, ah, bh, 1);
}

template <int kRegs>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[kChain][kRegs]) {
#pragma unroll
  for (int j = 0; j < kChain; ++j) wcflash::fence_regs(a[j]);
}

// kProducts score products at once: out[i] (64 x N) = A_i B_i^T over D, A_i the consumer's 64 own rows (planes
// a[i][0] = hi, a[i][1] = lo, Plane<64, D>), B_i N staged rows (b[i][0], b[i][1], Plane<N, D>). Each D-long sum runs
// in chains of kChain k-steps, each into an accumulator of its own, joined by FADD in order after the wait; as many
// chains are in flight as kPartRegs partial registers a thread allow (at least one of each product).
template <int D, int N, int kProducts>
__device__ __forceinline__ void scores(float (&out)[kProducts][N / 2], const uint32_t (&a)[kProducts][2],
                                       const uint32_t (&b)[kProducts][2]) {
  using PA = Plane<64, D>;
  using PB = Plane<N, D>;
  constexpr int kSteps = D / 8;
  constexpr int kChains = (kSteps + kChain - 1) / kChain;
  constexpr int kFit = kPartRegs / (N / 2) / kProducts;
  constexpr int kGroup = kFit < 1 ? 1 : kFit > kChains ? kChains : kFit;
#pragma unroll
  for (int c0 = 0; c0 < kChains; c0 += kGroup) {
    float part[kProducts][kGroup][N / 2];
#pragma unroll
    for (int i = 0; i < kProducts; ++i) wcflash::fence_regs(part[i]);
    wcflash::wgmma_fence();
#pragma unroll
    for (int i = 0; i < kProducts; ++i)
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
#pragma unroll
        for (int s = (c0 + c) * kChain; s < (c0 + c + 1) * kChain; ++s)
          if (c0 + c < kChains && s < kSteps)
            wgmma_3xtf32(part[i][c], PA::desc(a[i][0], 0, s), PA::desc(a[i][1], 0, s), PB::desc(b[i][0], 0, s),
                         PB::desc(b[i][1], 0, s), s > (c0 + c) * kChain);
    wcflash::wgmma_commit();
    wcflash::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kProducts; ++i) wcflash::fence_regs(part[i]);
#pragma unroll
    for (int i = 0; i < kProducts; ++i)
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c0 + c < kChains)
#pragma unroll
          for (int r = 0; r < N / 2; ++r) out[i][r] = c0 + c == 0 ? part[i][c][r] : out[i][r] + part[i][c][r];
  }
}

// tot (64 x D, kNc n-chunks of kNw columns) += A B over kKs k-steps of 8: A the consumer's split fragments,
// make_a(s, ah, al) making those of k-step s (from an accumulator's columns 8s..8s+7, by c_to_a), B the D rows of
// the transposed planes b_hi, b_lo (Plane<D, 8 kKs>, rows stored at column_of). The sum runs in chains of kChain
// k-steps; each chain's partial, kNg n-chunks at a time, joins tot by FADD.
template <int D, int kKs, int kNg, class MakeA>
__device__ __forceinline__ void accumulate(float (&tot)[Cols<D>::kNc][Cols<D>::kNw / 2], uint32_t b_hi,
                                           uint32_t b_lo, const MakeA& make_a) {
  using PB = Plane<D, 8 * kKs>;
  constexpr int kNw = Cols<D>::kNw, kNc = Cols<D>::kNc;
  static_assert(kKs % kChain == 0 && kNc % kNg == 0, "whole chains and n-chunk groups");
#pragma unroll
  for (int c0 = 0; c0 < kKs; c0 += kChain) {
    uint32_t ah[kChain][4], al[kChain][4];
#pragma unroll
    for (int j = 0; j < kChain; ++j) make_a(c0 + j, ah[j], al[j]);
#pragma unroll
    for (int h0 = 0; h0 < kNc; h0 += kNg) {
      float part[kNg][kNw / 2];
      wcflash::fence_regs(part);
      fence_frags(ah);
      fence_frags(al);
      wcflash::wgmma_fence();
#pragma unroll
      for (int h = 0; h < kNg; ++h)
#pragma unroll
        for (int j = 0; j < kChain; ++j)
          wgmma_3xtf32(part[h], ah[j], al[j], PB::desc(b_hi, (h0 + h) * kNw, c0 + j),
                       PB::desc(b_lo, (h0 + h) * kNw, c0 + j), j > 0);
      wcflash::wgmma_commit();
      wcflash::wgmma_wait<0>();
      wcflash::fence_regs(part);
      fence_frags(ah);  // the MMAs read the fragments until the wait
      fence_frags(al);
#pragma unroll
      for (int h = 0; h < kNg; ++h)
#pragma unroll
        for (int r = 0; r < kNw / 2; ++r) tot[h0 + h][r] += part[h][r];
    }
  }
}

// The producer's share (ptid 0..127) of R rows of C floats at src (row stride C): 16-byte loads, all issued by
// `load` before any is used, then `store` splits each element (times mul) into the planes hi and lo, as the rows
// lie (rows row0.. of Plane<kPlaneR, C>) or, kTransposed, row r at column column_of(r) of Plane<C, R>. Loads walk
// a row's chunks in consecutive threads; transposed, a warp's 32 threads take 32 consecutive rows, so each 4-byte
// store of a warp fills one 128-byte panel row.
template <int R, int C, bool kTransposed, int kPlaneR = R>
struct Fill {
  static constexpr int kC4 = C / 4;  // 16-byte chunks a row
  static constexpr int kPer = R * kC4 / 128;
  static_assert(R * kC4 % 128 == 0 && (!kTransposed || R % 32 == 0), "whole rounds of the producer's threads");
  float4 x[kPer];

  static __device__ __forceinline__ int row(int i) { return kTransposed ? i % R : i / kC4; }
  static __device__ __forceinline__ int chunk(int i) { return kTransposed ? i / R : i % kC4; }
  __device__ __forceinline__ void load(const float* __restrict__ src, int ptid) {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int i = ptid + 128 * it;
      x[it] = __ldg(reinterpret_cast<const float4*>(src + (size_t)row(i) * C + 4 * chunk(i)));
    }
  }
  __device__ __forceinline__ void store(uint32_t hi, uint32_t lo, float mul, int ptid, int row0 = 0) const {
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const int i = ptid + 128 * it, r = row(i), c = 4 * chunk(i);
      uint32_t h[4], l[4];
      split(x[it].x * mul, h[0], l[0]);
      split(x[it].y * mul, h[1], l[1]);
      split(x[it].z * mul, h[2], l[2]);
      split(x[it].w * mul, h[3], l[3]);
      if constexpr (kTransposed) {
        const int col = column_of(r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st_shared(hi + Plane<C, R>::at(c + e, col), h[e]);
          st_shared(lo + Plane<C, R>::at(c + e, col), l[e]);
        }
      } else {
        st_shared4(hi + Plane<kPlaneR, C>::at(row0 + r, c), h[0], h[1], h[2], h[3]);
        st_shared4(lo + Plane<kPlaneR, C>::at(row0 + r, c), l[0], l[1], l[2], l[3]);
      }
    }
  }
};

// The kernel's dynamic shared memory from its first 1024-byte boundary (where planes start), as a shared address
// and as a generic pointer; a kernel asks for 1024 bytes more than its layout.
struct SmemBase {
  uint32_t addr;
  unsigned char* ptr;
  __device__ __forceinline__ explicit SmemBase(unsigned char* raw) {
    addr = (wcflash::smem_u32(raw) + 1023u) & ~1023u;
    ptr = raw + (addr - wcflash::smem_u32(raw));
  }
  __device__ __forceinline__ float* floats(int offset) const { return reinterpret_cast<float*>(ptr + offset); }
};

// A consumer's 64 own rows (row stride D at src), times mul, into the planes hi and lo (Plane<64, D>) by the
// producer: at D >= 128 in two halves of 32 rows, so that the producer holds 32 floats of them at a time.
template <int D>
__device__ __forceinline__ void fill_own(const float* __restrict__ src, uint32_t hi, uint32_t lo, float mul,
                                         int ptid) {
  constexpr int kHalves = D >= 128 ? 2 : 1, kR = 64 / kHalves;
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
    Fill<kR, D, false, 64> x;
    x.load(src + (size_t)h * kR * D, ptid);
    x.store(hi, lo, mul, ptid, h * kR);
  }
}

}  // namespace wctf32
