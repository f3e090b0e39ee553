// 3xTF32 building blocks of the f32 flash kernels K1-f32 (flash_fwd_f32.cu)
// and K3-f32 (flash_bwd_f32.cu): f32 operands on the tensor cores with about
// 21 bits of each product kept.
//
// One TF32 pass would round every operand to 10 bits of mantissa. So each
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a product
// is formed as lo*hi + hi*lo + hi*hi, accumulated in f32 (the dropped lo*lo
// term is below 2^-22 of it): three mma.sync.m16n8k8.tf32 at 494.7 TFLOP/s
// in place of one f32 FMA at 67.
//
// The tensor cores' f32 accumulation truncates: a long chain of MMAs into one
// accumulator loses bits that FADD of short partial sums keeps (PERF.md
// section 6 has K1-f32's ablation: one chain over all N keys left O 3-7e-6
// of max |O| from the plain version at N = 1024, a chain of eight k-steps
// 1-2e-6). So every product here runs in chains of at most kChain k-steps
// (12 MMAs), each chain's partial sum joined to the running sum by FADD.
//
// The operands lie in shared memory as f32 rows padded to D + 4 floats, so
// every fragment load below is free of bank conflicts, and are split as the
// fragment is loaded (the split is 5 integer/float operations an element).
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

// A fragment of columns c0..c0+7 of a warp's 16 rows (row-major, `stride`), times `mul`, split.
__device__ __forceinline__ void load_a(uint32_t (&ah)[4], uint32_t (&al)[4], const float* rows, int stride, int c0,
                                       int g, int t, float mul) {
  const float* r = rows + g * stride + c0 + t;
  split(r[0] * mul, ah[0], al[0]);
  split(r[8 * stride] * mul, ah[1], al[1]);
  split(r[4] * mul, ah[2], al[2]);
  split(r[8 * stride + 4] * mul, ah[3], al[3]);
}

// B fragment of a product whose reduction runs along the staged rows' columns
// (Q K^T: B[k][n] = tile[n0 + n][c0 + k]), split.
__device__ __forceinline__ void load_b_cols(uint32_t (&bh)[2], uint32_t (&bl)[2], const float* tile, int stride,
                                            int n0, int c0, int g, int t) {
  const float* r = tile + (n0 + g) * stride + c0 + t;
  split(r[0], bh[0], bl[0]);
  split(r[4], bh[1], bl[1]);
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

// out = (a_rows * mul) tile^T for a warp's 16 rows against kNt * 8 staged
// rows, both D wide: kNt C fragments. The D-long sums run in chains of
// kChain k-steps joined by FADD.
template <int D, int kNt>
__device__ __forceinline__ void product_nt(float (&out)[kNt][4], const float* a_rows, float mul, const float* tile,
                                           int stride, int g, int t) {
  constexpr int kSteps = D / 8;
#pragma unroll
  for (int c0 = 0; c0 < kSteps; c0 += kChain) {
    float part[kNt][4] = {};
#pragma unroll
    for (int s = c0; s < c0 + kChain && s < kSteps; ++s) {
      uint32_t ah[4], al[4];
      load_a(ah, al, a_rows, stride, 8 * s, g, t, mul);
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        uint32_t bh[2], bl[2];
        load_b_cols(bh, bl, tile, stride, 8 * j, 8 * s, g, t);
        mma_3xtf32(part[j], ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) out[j][e] = c0 == 0 ? part[j][e] : out[j][e] + part[j][e];
  }
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

}  // namespace wctf32
