// K4: the exp2 form of the clamped-softmax flash-attention forward, a
// micro-probe, bf16/f16, for sm_90a.
//
// Replaces scripts/micro_attn.py `_exp2_kernel` (:43, via `exp2_attention` :63):
//   q2 = cast_to_T(q * (D^-1/2 * log2 e));   s2 = q2 K^T (f32);
//   p = exp2(min(s2, 60 * log2 e));          O = (cast_to_T(p) V) / l,  l = row sum of p.
// Only the upper side is clamped, as in the script: a row whose scores all
// lie below about -126 in the exp2 domain gives l = 0, as on the TPU.
//
// The probe's question: K1 (flash_fwd.cu) scales every score, clamps it on
// both sides and calls __expf (a multiply by log2 e and ex2.approx). Folding
// the scale and log2 e into q (N/D times fewer multiplies) and calling
// ex2.approx directly takes three instructions off every score. Does that
// pay on this card?
//
// What bounds it: as K1, 4*N^2*D tensor-core FLOPs and N^2 exponentials per
// head against 8*N*D bytes, so compute: the tensor cores at D >= 64, the
// per-score instructions at D = 16/32, where this form should gain most.
// The design is K1's (flash_common.cuh): 64 query rows per block, 64-key
// K/V tiles through shared memory, O and l in f32 with no running max, p
// from the QK^T accumulators to the PV product in registers.
#include "flash_common.cuh"

namespace wcprobe {
namespace {

using namespace wcflash;

constexpr float kClamp2 = 60.f * 1.4426950408889634f;  // 60 * log2(e)

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s[nt][*]: this warp's 16 x kBlockK scores in C layout, in the exp2 domain.
// Clamp from above only, exponentiate, add the f32 row sums into l.
__device__ __forceinline__ void clamp_exp2(float s[kBlockK / 8][4], float l[2]) {
#pragma unroll
  for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = ex2(fminf(s[nt][e], kClamp2));
    l[0] += s[nt][0] + s[nt][1];
    l[1] += s[nt][2] + s[nt][3];
  }
}

// Two q values times the folded scale, rounded back to T (the script's
// astype(q.dtype) before the product).
template <typename T>
__device__ __forceinline__ uint32_t scaled_pair(const T* p, float qscale) {
  const float2 f = Mma<T>::unpack(ld32(p));
  return Mma<T>::pack(f.x * qscale, f.y * qscale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    probe_exp2_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           T* __restrict__ o, int n, float qscale) {
  constexpr int kKStride = D + kPad;
  __shared__ __align__(16) T ks[kBlockK * kKStride];
  __shared__ __align__(16) T vt[D * kVtStride];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const int row0 = blockIdx.x * kBlockQ + warp * 16;

  // This warp's q2 rows as A fragments: read once, scaled, rounded to T.
  uint32_t qa[D / 16][4];
  const T* qw = q + head + (size_t)row0 * D;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qa[kc][0] = scaled_pair(qw + g * D + kc * 16 + 2 * t, qscale);
    qa[kc][1] = scaled_pair(qw + (g + 8) * D + kc * 16 + 2 * t, qscale);
    qa[kc][2] = scaled_pair(qw + g * D + kc * 16 + 8 + 2 * t, qscale);
    qa[kc][3] = scaled_pair(qw + (g + 8) * D + kc * 16 + 8 + 2 * t, qscale);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    constexpr int kVecPerRow = D / 8;
    for (int i = threadIdx.x; i < kBlockK * kVecPerRow; i += kThreads) {
      const int row = i / kVecPerRow;
      const int col = (i % kVecPerRow) * 8;
      *reinterpret_cast<uint4*>(ks + row * kKStride + col) =
          *reinterpret_cast<const uint4*>(k + head + (size_t)(k0 + row) * D + col);
    }
    stage_v_transposed<T, D>(vt, v + head, k0);
    __syncthreads();

    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const T* krow = ks + (nt * 8 + g) * kKStride + 2 * t;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint32_t b[2] = {ld32(krow + kc * 16), ld32(krow + kc * 16 + 8)};
        Mma<T>::run(s[nt], qa[kc], b);
      }
    }
    clamp_exp2(s, l);
    accumulate_pv<T, D>(acc, s, vt, lane);
  }

  write_output<T, D>(acc, l, o + head + (size_t)row0 * D, nullptr, lane);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int n, float qscale,
                   cudaStream_t stream) {
  const dim3 grid(n / kBlockQ, bh);
  probe_exp2_attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), n,
      qscale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                       float qscale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, bh, n, qscale, stream);
    case 32: return launch<T, 32>(q, k, v, o, bh, n, qscale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, n, qscale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, n, qscale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace wcprobe

// q, k, v, o: contiguous (bh, n, d) in bf16 (is_f16 = 0) or f16 (is_f16 = 1);
// qscale = d^-1/2 * log2(e). Returns the cudaError_t of the launch.
extern "C" int wc_probe_exp2_attn(const void* q, const void* k, const void* v, void* o, int bh, int n, int d,
                                  int is_f16, float qscale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kBlockQ != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcprobe::dispatch_d<__half>(q, k, v, o, bh, n, d, qscale, s)
                : wcprobe::dispatch_d<__nv_bfloat16>(q, k, v, o, bh, n, d, qscale, s);
}
