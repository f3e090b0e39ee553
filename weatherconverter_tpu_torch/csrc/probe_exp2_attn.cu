// K4: the exp2 form of the clamped-softmax flash-attention forward, a
// micro-probe, bf16/f16, for sm_90a.
//
// Replaces scripts/micro_attn.py `_exp2_kernel` (:43, via `exp2_attention` :63):
//   q2 = cast_to_T(q * (D^-1/2 * log2 e));   s2 = q2 K^T (f32);
//   p = exp2(min(s2, 60 * log2 e));          O = (cast_to_T(p) V) / l,  l = row sum of p.
// Only the upper side is clamped, as in the script: a row whose scores all
// lie below about -126 in the exp2 domain gives l = 0, as on the TPU.
//
// The probe's question: K1 (flash_fwd.cu) multiplies every score by
// scale * log2 e, clamps it on both sides and calls ex2.approx.ftz, with Q
// read from shared memory by every Q K^T product. This form folds the scale
// into q (N/D times fewer multiplies), clamps from above only, and, since q
// has to be scaled and re-rounded in registers anyway, keeps it there as the
// A operand of Q K^T. Do two instructions fewer a score and a register Q pay
// on this card?
//
// What bounds it: as K1, 4*N^2*D tensor-core FLOPs and N^2 exponentials per
// head against 8*N*D bytes, so compute: the tensor cores at D >= 64 (at
// D = 64 the exponentials cost as much), the per-score instructions at
// D = 16/32, where this form should gain most.
// What the design does about it: K1's (flash_wgmma.cuh, flash_fwd_loop.cuh),
// so that the two differ in the question alone: both products on wgmma, K and
// V tiles of 64 keys through the cp.async ring in swizzled shared memory, V as
// loaded through an MN-major descriptor, the exponentials of tile j+1 over
// the P V of tile j, O out through shared memory with 16-byte stores. Each
// warp reads its 16 rows of Q from global memory once, as the A fragments of
// wgmma with A from registers, so the block has no Q tile in shared memory
// (a K1 block holds one for its whole life) and S = q2 K^T reads only the K
// tile from it. Departures: K1's.
// The answer (an H100 at 700 W, bf16, B*H = 32, probes/time_flash.py, both
// kernels in turns in one process): the form pays where the per-score work
// and the tensor cores weigh alike and is about even elsewhere, 0.3108 ms
// against K1's 0.3308 at (4096, 64) (-6 %), 0.2011 against 0.2037 at
// (4096, 16) (-1 %), 0.0219 against 0.0216 at (1024, 32); at (1024, 128) it
// loses, 0.0509 against 0.0458 (+11 %), where q2 takes 32 more registers a
// thread (192 against 160). Which of the two ideas carries the gain at
// D = 64 this probe does not separate.
#include "flash_fwd_loop.cuh"

namespace wcprobe {
namespace {

using namespace wcflash;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two q values times the folded scale, rounded back to T (the script's
// astype(q.dtype) before the product).
template <typename T>
__device__ __forceinline__ uint32_t scaled_pair(const T* p, float qscale) {
  const float2 f = Mma<T>::unpack(ld32(p));
  return Mma<T>::pack(f.x * qscale, f.y * qscale);
}

template <typename T, int D>
struct Exp2Policy {
  using Score = float;
  static constexpr int kQBytes = 0;
  static constexpr int kKTileBytes = Tile<D>::kBytes;

  const T* k_head;
  uint32_t qa[D / 4];  // this warp's 16 rows of q2: four A-fragment registers for each 16-deep chunk of d

  __device__ __forceinline__ void prologue(uint32_t, uint32_t, int) const {}
  __device__ __forceinline__ void load_k(uint32_t dst, int tile, int tid) const {
    load_tile_async<T, D>(dst, k_head + (size_t)tile * kTileRows * D, tid);
  }
  __device__ __forceinline__ void start(float (&s)[kTileRows / 2], uint32_t, uint32_t k_tile) const {
    mma_regs_rows_t<T, D>(s, qa, k_tile);
  }
  // One score tile in the exp2 domain: clamp from above only, exponentiate,
  // add the f32 row sums into l, pack p as the A fragments of the P V product.
  __device__ __forceinline__ void exp_pack(const float (&s)[kTileRows / 2], float l[2],
                                           uint32_t (&p)[kTileRows / 4]) const {
#pragma unroll
    for (int i = 0; i < kTileRows / 4; ++i) {  // pair i: row g + 8 * (i & 1)
      const float x0 = ex2(fminf(s[2 * i], kClampLog2)), x1 = ex2(fminf(s[2 * i + 1], kClampLog2));
      l[i & 1] += x0 + x1;
      p[i] = Mma<T>::pack(x0, x1);
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads)
    probe_exp2_attn_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                                 T* __restrict__ o, int n, float qscale) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t head = (size_t)blockIdx.y * n * D;
  const size_t row0 = (size_t)blockIdx.x * kTileRows * D;

  Exp2Policy<T, D> policy;
  policy.k_head = k + head;
  const T* qw = q + head + row0 + (size_t)warp * 16 * D;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    policy.qa[4 * kc] = scaled_pair(qw + g * D + kc * 16 + 2 * t, qscale);
    policy.qa[4 * kc + 1] = scaled_pair(qw + (g + 8) * D + kc * 16 + 2 * t, qscale);
    policy.qa[4 * kc + 2] = scaled_pair(qw + g * D + kc * 16 + 8 + 2 * t, qscale);
    policy.qa[4 * kc + 3] = scaled_pair(qw + (g + 8) * D + kc * 16 + 8 + 2 * t, qscale);
  }
  flash_forward_loop<T, D>(policy, v + head, o + head + row0, nullptr, n);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int n, float qscale,
                   cudaStream_t stream) {
  constexpr int smem = fwd_loop_smem_bytes<T, D, Exp2Policy<T, D>>();
  auto kernel = probe_exp2_attn_wgmma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n / kTileRows, bh), kWgThreads, smem, stream>>>(
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
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kTileRows != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_f16 ? wcprobe::dispatch_d<__half>(q, k, v, o, bh, n, d, qscale, s)
                : wcprobe::dispatch_d<__nv_bfloat16>(q, k, v, o, bh, n, d, qscale, s);
}
