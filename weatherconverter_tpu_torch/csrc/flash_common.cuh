// Shared pieces of the clamped-softmax flash-attention kernels (K1, K2, K3),
// also used by the probes K4 (probe_exp2_attn.cu) and K7 (probe_qk_dot.cu).
//
// Tiling: one block of 4 warps owns 64 query rows of one (batch*head); each
// warp owns 16 rows and walks the keys in tiles of 64 staged in shared
// memory. The tensor-core product is mma.sync m16n8k16 (bf16/f16 -> f32) or
// m16n8k32 (s8 -> s32); fragment layouts follow the PTX ISA tables:
//   lane = 4*g + t (g = groupID 0..7, t = threadID_in_group 0..3)
//   C/D (16x8, 32-bit):  c0,c1 -> (row g,   cols 2t, 2t+1)
//                        c2,c3 -> (row g+8, cols 2t, 2t+1)
//   A (16x16, 16-bit):   a0 -> (g, 2t..2t+1)   a1 -> (g+8, 2t..2t+1)
//                        a2 -> (g, 2t+8..)     a3 -> (g+8, 2t+8..)
//   B (16x8, 16-bit):    b0 -> (k 2t..2t+1, n g)   b1 -> (k 2t+8.., n g)
// The C layout of two neighbouring 8-column score tiles is exactly the A
// layout of one 16-wide k-chunk, so p goes from the QK^T accumulators to
// the PV product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wcflash {

constexpr int kBlockQ = 64;  // query rows per block: 4 warps x 16
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kPad = 8;  // 16-bit elements of row padding: conflict-free fragment loads
constexpr int kVtStride = kBlockK + kPad;
// Both sides of the exp clamp. Must equal _CLAMP in ops/attention.py.
constexpr float kClamp = 60.f;

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // lo lands in the low 16 bits: the element with the smaller column index
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float c[4], const uint32_t a[4], const uint32_t b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
};

// int8 fragments (m16n8k32, s8 -> s32): a0 (g, 4t..4t+3), a1 (g+8, 4t..),
// a2 (g, 16+4t..), a3 (g+8, 16+4t..); b0 (k 4t..4t+3, n g), b1 (k 16+4t.., n g);
// C as above.
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage V rows [k0, k0 + kBlockK) of one head TRANSPOSED into vt[D][kVtStride],
// so the PV product's B fragments (two consecutive keys at one d) are single
// 32-bit shared-memory loads.
template <typename T, int D>
__device__ __forceinline__ void stage_v_transposed(T* vt, const T* __restrict__ v_head, int k0) {
  constexpr int kVecPerRow = D / 8;  // 16-byte vectors
  for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
    const int row = i / kVecPerRow;
    const int col = (i % kVecPerRow) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(v_head + (size_t)(k0 + row) * D + col);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(col + j) * kVtStride + row] = e[j];
  }
}

// s[nt][*] holds this warp's 16 x kBlockK scores in C layout. Clamp, exponentiate
// in f32 and add the f32 row sums (rows g and g+8) into l[0], l[1].
__device__ __forceinline__ void clamp_exp(float s[kBlockK / 8][4], float l[2]) {
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fminf(fmaxf(s[nt][e], -kClamp), kClamp);
      s[nt][e] = __expf(x);
    }
    l[0] += s[nt][0] + s[nt][1];
    l[1] += s[nt][2] + s[nt][3];
  }
}

// o[nt] (16 x D in C layout) += p (16 x kBlockK, cast to T) @ V tile.
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(float o[D / 8][4], const float p[kBlockK / 8][4],
                                              const T* vt, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kBlockK / 16; ++kc) {
    uint32_t a[4];
    a[0] = Mma<T>::pack(p[2 * kc][0], p[2 * kc][1]);
    a[1] = Mma<T>::pack(p[2 * kc][2], p[2 * kc][3]);
    a[2] = Mma<T>::pack(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    a[3] = Mma<T>::pack(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const T* row = vt + (nt * 8 + g) * kVtStride + kc * 16 + 2 * t;
      const uint32_t b[2] = {ld32(row), ld32(row + 8)};
      Mma<T>::run(o[nt], a, b);
    }
  }
}

// Reduce the row sums over the 4 lanes of a group, then write O / l in T and,
// when l_out is given, l itself (f32, one value per query row).
template <typename T, int D>
__device__ __forceinline__ void write_output(const float o[D / 8][4], float l[2], T* __restrict__ o_rows,
                                             float* __restrict__ l_rows, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(o_rows + g * D + col) = Mma<T>::pack(o[nt][0] / l[0], o[nt][1] / l[0]);
    *reinterpret_cast<uint32_t*>(o_rows + (g + 8) * D + col) =
        Mma<T>::pack(o[nt][2] / l[1], o[nt][3] / l[1]);
  }
  if (l_rows != nullptr && t == 0) {
    l_rows[g] = l[0];
    l_rows[g + 8] = l[1];
  }
}

}  // namespace wcflash
