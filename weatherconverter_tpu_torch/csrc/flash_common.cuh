// Shared pieces of the flash-attention kernels (K1-K4, through
// flash_wgmma.cuh) and of the probe K7 (probe_qk_dot.cu): the element types'
// pack/unpack, the exp clamp, and the mma.sync products that K7 still runs.
//
// mma.sync fragment layouts (PTX ISA tables), one warp owning 16 rows:
//   lane = 4*g + t (g = groupID 0..7, t = threadID_in_group 0..3)
//   C/D (16x8, 32-bit):  c0,c1 -> (row g,   cols 2t, 2t+1)
//                        c2,c3 -> (row g+8, cols 2t, 2t+1)
//   A (16x16, 16-bit):   a0 -> (g, 2t..2t+1)   a1 -> (g+8, 2t..2t+1)
//                        a2 -> (g, 2t+8..)     a3 -> (g+8, 2t+8..)
//   B (16x8, 16-bit):    b0 -> (k 2t..2t+1, n g)   b1 -> (k 2t+8.., n g)
// The A layout is also that of wgmma's register A operand (a warp's 16 rows
// of the warpgroup's 64).
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

}  // namespace wcflash
