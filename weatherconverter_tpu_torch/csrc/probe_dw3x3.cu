// K6: 3x3 depthwise convolution, NHWC, zero padding 1, no bias, a
// micro-probe, bf16/f16, for sm_90a.
//
// Replaces scripts/probe_dw3x3.py `_kernel` (:36, via `dw3x3` :48):
//   out[b, h, w, c] = sum over taps (dh, dw), in that order, of
//                     x[b, h + dh - 1, w + dw - 1, c] * k[dh, dw, c],
// accumulated in f32 (one fmaf a tap) and cast to the input type. The script
// padded W to 136 for the TPU's sublane tiling; here the padding is the zero
// fill of the copies that stage a tile.
//
// The probe's question: what is the floor of the SRGAN residual block's 3x3
// depthwise conv on this card, against what cuDNN takes for it? What bounds
// it: 9 FMAs per element against 2 bytes read and 2 written, so device
// memory: at (8, 128, 128, 64) bf16, 2 x 16.8 MB, ~10 us at 3.35 TB/s. The
// arithmetic is not free beside that: 72 FMAs per 16-byte output vector, and
// every 16-bit value has to be unpacked to f32 on the integer pipe, which
// issues at half the FMA rate. Unpacking input and tap at every use is 144
// such instructions per output vector, ~11 us of the integer pipe: more than
// the memory bound.
//
// The first version took one thread per output vector and issued nine
// 16-byte input loads and nine tap loads through L1 for each store, a grid
// of one image row a block: no reuse inside a block, little in flight a
// thread. It reached a third of the memory rate.
// What the design does about it:
//   * A block owns a tile of 16 x 32 output pixels x 64 channels and stages
//     it with its one-pixel halo (18 x 34 pixels, 1.20x the bytes) in shared
//     memory by 16-byte cp.async; a copy that falls outside the image has
//     source size 0, which fills zeros, so the inner loop has no edge branch.
//   * A thread owns one 16-byte channel vector of one pixel column and walks
//     down the tile's 18 halo rows. It keeps its nine taps unpacked in 72
//     registers (loaded and unpacked once) and three rows of accumulators: a
//     halo row is tap row 0 of one output row, tap row 1 of the one above and
//     tap row 2 of the one above that, so its three vectors are loaded from
//     shared memory and unpacked once for the three outputs they feed (24
//     unpack instructions per output vector, not 144), and every output still
//     adds its taps in the order (dh, dw).
//   * The tile arrives as four cp.async groups of rows; the thread waits for
//     group g only when its walk reaches it, so the arithmetic on the first
//     rows overlaps the copies of the later ones. Two blocks an SM
//     (__launch_bounds__(256, 2), 78 KB of shared memory each).
//   * The summation order and the fused multiply-adds are the first
//     version's, and adding 0 * k changes no bit of an accumulator that
//     starts at +0, so for finite taps the two agree bit for bit.
// Measured at (8, 128, 128, 64) bf16 on an NVIDIA H100 80GB HBM3 at 700 W by
// probes/probe_dw3x3.py: 0.0156 ms (2.15 TB/s; cuDNN's channels-last conv
// 0.0202 ms in the same run). One ablation per idea, each bit-equal to the
// design, timed in the same process and then taken out of the source: the
// first version (no staging) 0.0297 ms; the taps re-read through L1 and
// unpacked at every use 0.0199; one copy group (no overlap of copies and
// arithmetic inside a block) 0.0170; a 4 x 32 tile, four rows a thread
// (1.59x the bytes staged) 0.0204. An earlier form of the design, with the
// taps packed and a sliding 3 x 3 window of packed input vectors, both
// unpacked at every use, took 0.0190-0.0195 ms: the integer pipe bound it,
// not the memory. What is left between 0.0156 ms and the 0.0100 ms of the
// bytes is not measured: a single wave of 256 blocks that start and end
// together, and a few bytes of spill at the 128-register cap that two blocks
// an SM impose.
#include "flash_common.cuh"

namespace wcprobe {
namespace {

using wcflash::Mma;

constexpr int kThreads = 256;
constexpr int kRows = 16;         // output pixel rows a block
constexpr int kTileW = 32;        // output pixel columns a block
constexpr int kBlockVectors = 8;  // 16-byte channel vectors a block: 64 channels
constexpr int kGroups = 4;        // cp.async groups of rows a tile arrives in

template <typename T>
__device__ __forceinline__ void unpack8(float (&f)[8], const uint4& v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 pair = Mma<T>::unpack(words[j]);
    f[2 * j] = pair.x;
    f[2 * j + 1] = pair.y;
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack8(const float (&acc)[8]) {
  uint4 ov;
  ov.x = Mma<T>::pack(acc[0], acc[1]);
  ov.y = Mma<T>::pack(acc[2], acc[3]);
  ov.z = Mma<T>::pack(acc[4], acc[5]);
  ov.w = Mma<T>::pack(acc[6], acc[7]);
  return ov;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; with `valid` false nothing is read and zeros are written
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_pending(int pending) {  // pending in 0..3
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

constexpr int kTileSmemBytes = (kRows + 2) * (kTileW + 2) * kBlockVectors * 16;

// A block: kRows x kTileW output pixels x cvb channel vectors (cvb =
// min(C / 8, 8)), copied in kGroups groups of rows. Shared layout
// [row][column][vector], 16 bytes a vector: a warp reads 512 contiguous
// bytes. blockIdx.x = channel group * column tiles + column tile.
// kCvb is cvb as a constant (8: the index arithmetic of the copies divides by
// constants) or 0 for the runtime value `cvb_rt`.
template <typename T, int kCvb>
__global__ void __launch_bounds__(kThreads, 2)
    probe_dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ taps, T* __restrict__ out, int h, int w, int c,
                       int cvb_rt, int tiles_w) {
  static_assert(kRows % kGroups == 0 && kGroups <= 4, "row groups");
  const int cvb = kCvb ? kCvb : cvb_rt;
  constexpr int kGroupRows = kRows / kGroups;
  constexpr int kHaloW = kTileW + 2;
  extern __shared__ __align__(16) unsigned char tile[];
  const uint32_t tile_s = smem_addr(tile);
  const int tid = threadIdx.x;
  const int w0 = (blockIdx.x % tiles_w) * kTileW, h0 = blockIdx.y * kRows;
  const int chan0 = (blockIdx.x / tiles_w) * cvb * 8;
  const int vecs = min(cvb, (c - chan0) / 8);  // the last channel group may be narrower
  const size_t image = (size_t)blockIdx.z * h * w * c;
  const int row_bytes = kHaloW * cvb * 16;

  // copies: group 0 is halo rows [0, kGroupRows + 2), group g rows [g * kGroupRows + 2, (g + 1) * kGroupRows + 2)
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int first = g == 0 ? 0 : g * kGroupRows + 2, last = (g + 1) * kGroupRows + 2;
    for (int i = first * kHaloW * cvb + tid; i < last * kHaloW * cvb; i += kThreads) {
      const int v = i % cvb, col = (i / cvb) % kHaloW, row = i / (cvb * kHaloW);
      const int hh = h0 + row - 1, ww = w0 + col - 1;
      const bool valid = v < vecs && hh >= 0 && hh < h && ww >= 0 && ww < w;
      const T* src = valid ? x + image + ((size_t)hh * w + ww) * c + chan0 + v * 8 : x;
      cp_async16_zfill(tile_s + i * 16, src, valid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  const bool active = tid / cvb < kTileW && tid % cvb < vecs;  // an idle thread still joins the barriers
  const int col = active ? tid / cvb : 0, v = active ? tid % cvb : 0;
  const int cc = chan0 + v * 8;
  float tap[9][8];
#pragma unroll
  for (int i = 0; i < 9; ++i) unpack8<T>(tap[i], *reinterpret_cast<const uint4*>(taps + i * c + cc));
  const uint32_t mine = tile_s + (col * cvb + v) * 16;  // halo column `col`, row 0
  T* out_col = out + image + ((size_t)h0 * w + w0 + col) * c + cc;
  const bool in_w = active && w0 + col < w;

  // Halo row i (image row h0 - 1 + i) is tap row 0 of output row i, tap row 1 of output row i - 1 and
  // tap row 2 of output row i - 2: taken in the order it arrives, every output adds its nine taps in the
  // order (dh, dw), and a row's three vectors are loaded and unpacked once for the three outputs.
  float acc[3][8];
#pragma unroll
  for (int i = 0; i < kRows + 2; ++i) {
    if (i == 0 || (i >= kGroupRows + 2 && (i - 2) % kGroupRows == 0)) {  // the first halo row of a copy group
      cp_async_wait_pending(kGroups - 1 - (i == 0 ? 0 : (i - 2) / kGroupRows));
      __syncthreads();
    }
    if (i < kRows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i % 3][j] = 0.f;
    }
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      float xf[8];
      unpack8<T>(xf, lds128(mine + i * row_bytes + dw * cvb * 16));
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {  // output row i - dh
        if (i - dh < 0 || i - dh >= kRows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[(i - dh) % 3][j] = fmaf(xf[j], tap[dh * 3 + dw][j], acc[(i - dh) % 3][j]);
      }
    }
    if (i >= 2 && in_w && h0 + i - 2 < h)
      *reinterpret_cast<uint4*>(out_col + (size_t)(i - 2) * w * c) = pack8<T>(acc[(i - 2) % 3]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* taps, void* out, int b, int h, int w, int c, cudaStream_t stream) {
  const int cv = c / 8, cvb = cv < kBlockVectors ? cv : kBlockVectors;
  const int tiles_w = (w + kTileW - 1) / kTileW, tiles_h = (h + kRows - 1) / kRows, groups = (cv + cvb - 1) / cvb;
  if ((long long)tiles_w * groups > 0x7fffffffLL || tiles_h > 65535 || b > 65535) return cudaErrorInvalidValue;
  auto kernel = cvb == kBlockVectors ? probe_dw3x3_kernel<T, kBlockVectors> : probe_dw3x3_kernel<T, 0>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles_w * groups, tiles_h, b), kThreads, kTileSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps), static_cast<T*>(out), h, w, c, cvb, tiles_w);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wcprobe

// x, out: contiguous NHWC (b, h, w, c); taps: contiguous (3, 3, c), tap-major;
// all in bf16 (is_f16 = 0) or f16 (is_f16 = 1), 16-byte aligned; c % 8 == 0.
// Returns the cudaError_t of the launch.
extern "C" int wc_probe_dw3x3(const void* x, const void* taps, void* out, int b, int h, int w, int c, int is_f16,
                              void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 8 != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcprobe::launch<__half>(x, taps, out, b, h, w, c, s)
                : wcprobe::launch<__nv_bfloat16>(x, taps, out, b, h, w, c, s);
}
