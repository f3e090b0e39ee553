// K5: the FMA floor of a 9x9 depthwise convolution, a micro-probe, bf16/f16,
// for sm_90a.
//
// Replaces scripts/probe_dw9x9_floor.py `dw_vpu_kernel` (:40, via `run_vpu`
// :50): for every element, 81 sequential f32 multiply-adds of x * w[i], in
// the order i = 0..80, then a cast to the input type. It does a 9x9
// depthwise conv's FMA work with the shifts left out: same operation count,
// same operand sizes, so its time is a floor for any depthwise 9x9 kernel.
// The chain stays a chain: each FMA depends on the one before, and nvcc
// does not reassociate float arithmetic.
//
// What bounds it: at the SRGAN tail's (8, 256, 256, 64), 33.5 M elements x
// 81 = 2.72 G FMAs, ~80 us at the H100's ~67 TFLOP/s of f32 FMA, against
// 134 MB of bf16 traffic, ~40 us at 3.35 TB/s: compute. What the design does
// about it: the 81 weights are a kernel argument, so every FMA takes its
// weight straight from the constant bank and the loop is FMAs alone; each
// thread runs eight independent chains (one 16-byte vector), which hides
// the FMA latency.
#include "flash_common.cuh"

namespace wcprobe {
namespace {

using wcflash::Mma;

constexpr int kThreads = 256;
constexpr int kTaps = 81;

struct Taps {
  float w[kTaps];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    probe_dw_fma81_kernel(const T* __restrict__ x, T* __restrict__ out, long long nvec, const Taps taps) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nvec) return;
  const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
  const uint32_t xs[4] = {raw.x, raw.y, raw.z, raw.w};
  float xf[8], acc[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = Mma<T>::unpack(xs[j]);
    xf[2 * j] = f.x;
    xf[2 * j + 1] = f.y;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(xf[j], taps.w[t], acc[j]);
  }
  uint4 ov;
  ov.x = Mma<T>::pack(acc[0], acc[1]);
  ov.y = Mma<T>::pack(acc[2], acc[3]);
  ov.z = Mma<T>::pack(acc[4], acc[5]);
  ov.w = Mma<T>::pack(acc[6], acc[7]);
  reinterpret_cast<uint4*>(out)[i] = ov;
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long nvec, const Taps& taps, cudaStream_t stream) {
  const long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  probe_dw_fma81_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                                      static_cast<T*>(out), nvec, taps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wcprobe

// x, out: contiguous, n elements (n % 8 == 0) of bf16 (is_f16 = 0) or f16
// (is_f16 = 1), 16-byte aligned; w: 81 f32 weights in HOST memory, copied
// into the launch's arguments. Returns the cudaError_t of the launch.
extern "C" int wc_probe_dw_fma81(const void* x, void* out, long long n, const float* w, int is_f16, void* stream) {
  if (n <= 0 || n % 8 != 0 || w == nullptr) return cudaErrorInvalidValue;
  wcprobe::Taps taps;
  for (int i = 0; i < wcprobe::kTaps; ++i) taps.w[i] = w[i];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcprobe::launch<__half>(x, out, n / 8, taps, s)
                : wcprobe::launch<__nv_bfloat16>(x, out, n / 8, taps, s);
}
