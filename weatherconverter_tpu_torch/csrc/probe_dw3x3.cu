// K6: 3x3 depthwise convolution, NHWC, zero padding 1, no bias, a
// micro-probe, bf16/f16, for sm_90a.
//
// Replaces scripts/probe_dw3x3.py `_kernel` (:36, via `dw3x3` :48):
//   out[b, h, w, c] = sum over taps (dh, dw), in that order, of
//                     x[b, h + dh - 1, w + dw - 1, c] * k[dh, dw, c],
// accumulated in f32 and cast to the input type. The script padded W to 136
// for the TPU's sublane tiling; here the kernel masks the edge itself (a tap
// that falls in the zero padding adds exactly nothing, so it is skipped).
//
// The probe's question: what is the floor of the SRGAN residual block's 3x3
// depthwise conv on this card, against what cuDNN takes for it? What bounds
// it: 9 FMAs per element against 2 bytes read and 2 written, so device
// memory: at (8, 128, 128, 64) bf16, 2 x 16.8 MB, ~10 us at 3.35 TB/s.
// What the design does about it: one thread per 8 channels (a 16-byte
// vector) of one output pixel, neighbouring threads on neighbouring vectors,
// so every load and store is coalesced; the nine taps re-read an input
// vector that neighbouring pixels also read, which the L1 and L2 caches
// serve, so device memory sees each byte about once. The grid is (row
// vectors, h, b), so a thread finds its pixel with one 32-bit division.
// It reaches about a third of the HBM bandwidth: a later version would stage
// a 2-D tile with its halo in shared memory (a strip of rows per thread with
// the taps in registers was tried and was slower: 160 registers, one block
// per SM).
#include "flash_common.cuh"

namespace wcprobe {
namespace {

using wcflash::Mma;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    probe_dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ taps, T* __restrict__ out, int b, int h,
                       int w, int c) {
  const int cv = c / 8;  // 16-byte channel vectors per pixel
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= w * cv) return;
  const int wi = i / cv;
  const int c8 = (i - wi * cv) * 8;
  const int hi = blockIdx.y;
  const size_t bi = blockIdx.z;

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
    const int hh = hi + dh - 1;
    if (hh < 0 || hh >= h) continue;
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int ww = wi + dw - 1;
      if (ww < 0 || ww >= w) continue;
      const uint4 xv = *reinterpret_cast<const uint4*>(x + ((bi * h + hh) * w + ww) * c + c8);
      const uint4 kv = *reinterpret_cast<const uint4*>(taps + (dh * 3 + dw) * c + c8);
      const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 xf = Mma<T>::unpack(xs[j]);
        const float2 kf = Mma<T>::unpack(kw[j]);
        acc[2 * j] = fmaf(xf.x, kf.x, acc[2 * j]);
        acc[2 * j + 1] = fmaf(xf.y, kf.y, acc[2 * j + 1]);
      }
    }
  }
  uint4 ov;
  ov.x = Mma<T>::pack(acc[0], acc[1]);
  ov.y = Mma<T>::pack(acc[2], acc[3]);
  ov.z = Mma<T>::pack(acc[4], acc[5]);
  ov.w = Mma<T>::pack(acc[6], acc[7]);
  *reinterpret_cast<uint4*>(out + ((bi * h + hi) * w + wi) * c + c8) = ov;
}

template <typename T>
cudaError_t launch(const void* x, const void* taps, void* out, int b, int h, int w, int c, cudaStream_t stream) {
  if ((long long)w * (c / 8) > 0x7fffffffLL - kThreads || h > 65535 || b > 65535) return cudaErrorInvalidValue;
  const dim3 grid((w * (c / 8) + kThreads - 1) / kThreads, h, b);
  probe_dw3x3_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(taps), static_cast<T*>(out), b, h, w, c);
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
