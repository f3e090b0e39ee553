// K2: clamped-softmax flash-attention forward with the QK^T product in int8,
// for sm_90a.
//
// Replaces weatherconverter_tpu/ops/attention.py `_flash_kernel_qk_i8` (:125,
// via `_flash_attention_fwd_i8_impl`), its pv_int8=False branch:
//   s = int32(Q8 K8^T) * (qs * ks * D^-1/2);  O = (exp(clip(s, -60, 60)) V) / l,
// Q and K quantized before the kernel (quantize_i8.cu), per tensor or per
// batch row (JAX's function under jax.vmap over requests), V and the PV
// product in bf16/f16, l and O accumulated in f32. Head bh reads
// qk_scale[bh / heads_per_scale]: heads_per_scale is B*H for one scale, H for
// one a row.
//
// What bounds it on the H100: per head 2*N^2*D int8 operations (1,979 TOP/s)
// and 2*N^2*D bf16 FLOPs (989 TFLOP/s), N^2 exponentials (16 a clock an SM),
// against N*D*(1 + 1 + 2 + 2) bytes: compute-bound at every shape of the UNet,
// on the tensor cores only at D = 128, on the exponentials and the
// convert/clamp/pack instructions around them at D <= 64.
// What the design does about it (flash_wgmma.cuh, flash_fwd_loop.cuh):
//   * S = Q8 K8^T is wgmma m64n64k32 s8 -> s32 with both operands from shared
//     memory. Integer wgmma takes K-major operands only; Q8 (64, D) and K8
//     (64, D) are K-major as they lie in global memory, so nothing is
//     transposed. Its s32 accumulators have the f32 layout, so p goes into
//     the P V product (bf16/f16 wgmma, V as loaded through an MN-major
//     descriptor) without leaving registers, as in K1.
//   * K1's schedule and ring (flash_fwd_loop.cuh): K8 and V tiles of 64 keys by
//     cp.async two tiles ahead, the exponentials of tile j+1 over the P V of
//     tile j. An int8 tile has D-byte rows in the 128/64/32-byte swizzle; at
//     D = 16 a row is 16 bytes and a k32 step reads 32, so rows are 32 bytes
//     with a zero half that is written once per ring slot and that no copy
//     touches: half of that one product is padding, a quarter of a K1 step.
//   * Per score: int32 -> f32 times qk_scale * log2 e (read once from the
//     device pointer, so the wrapper never synchronises), the clamp at
//     +-60 * log2 e, ex2.approx.ftz. |s| <= 127 * 127 * 128 < 2^22, so
//     int_as_float(s + 0x4B400000) is exactly 1.5 * 2^23 + s, and one FMA,
//     f * c - 1.5 * 2^23 * c, converts and scales: an integer add and an FMA
//     where cvt.rn.f32.s32 and a multiply would stand. The rounding of the
//     constant term moves every score of a call by the same amount (under
//     2^-12 in the exp2 domain), one common factor of p and l that cancels
//     in O. Measured in turns on an H100 (B*H = 32, probes/time_flash.py): at
//     (4096, 16), where nothing but these instructions binds, 0.2221 ms
//     against 0.2263 ms with cvt (1.9 % faster), even within 0.6 % at the
//     other three shapes; a subtraction and a multiply in place of the FMA
//     (the same bits as cvt) was 4-6 % slower than either. The FMA form is
//     the one kept; the cvt form is no longer built.
// D = 24 (the legacy UNet's attn_up2) and D = 192 (the 256 px UNet's
// 768-channel layers) follow K1's designs at those head dims. At D = 24 the
// int8 rows of 24 bytes are staged on D = 32 tiles in 8-byte cp.async pieces,
// the fourth of each row zero-filled by src-size 0 (a select, no branch), so
// the one k32 step of S adds exactly 0 past d = 24; V and O run K1's D = 24
// path (zero-filled 16-byte tails, columns 24-31 never stored). At D = 192
// the int8 tiles are three 64-byte panels (six k32 steps), V and O K1's three
// 64-column panels: 121 KB of shared memory, one block an SM, 96 O
// accumulators a thread, as in K1. Both take one scale a tensor or a row.
// Departures: as K1's (cp.async by the MMA warps, not TMA; one warpgroup a
// block; S_{j+1} not in flight across iterations). The ring keeps K1's depth
// of three although K8 tiles are half the bytes: at three the block already
// fits three or four times an SM at D <= 64.
// Measured on an H100 (700 W, bf16, B*H = 32, chip_smoke.py phase 2), the
// forward alone beside K1: 0.2914 against 0.3279 ms at (4096, 64), 0.0398
// against 0.0461 at (1024, 128), 0.0217 against 0.0217 at (1024, 32), 0.2192
// against 0.2041 at (4096, 16): ahead where the tensor cores weigh, behind
// where only the per-score instructions do (the conversion is one more).
#include "flash_fwd_loop.cuh"

namespace wcflash {

// D: the tile's width; G: the tensors' head dim (row stride), D unless G = 24.
template <typename T, int D, int G = D>
struct QkI8Policy {
  using Score = int;
  using L8 = Tile<D, 1>;
  static constexpr int kQBytes = L8::kBytes;
  static constexpr int kKTileBytes = L8::kBytes;

  const int8_t* q_rows;  // the block's 64 rows of Q8
  const int8_t* k_head;
  float scale_log2;  // qs * ks * D^-1/2 * log2 e
  float magic_bias;  // -1.5 * 2^23 * scale_log2

  __device__ __forceinline__ void prologue(uint32_t q_s, uint32_t k_ring, int tid) const {
    zero_row_padding<L8>(q_s, 1, tid);
    zero_row_padding<L8>(k_ring, kFwdStages, tid);
    load_tile_async<int8_t, D, G>(q_s, q_rows, tid);
  }
  __device__ __forceinline__ void load_k(uint32_t dst, int tile, int tid) const {
    load_tile_async<int8_t, D, G>(dst, k_head + (size_t)tile * kTileRows * G, tid);
  }
  __device__ __forceinline__ void start(int (&s)[kTileRows / 2], uint32_t q_s, uint32_t k_tile) const {
    mma_rows_rows_t_s8<D>(s, q_s, k_tile);
  }
  __device__ __forceinline__ float to_exp(int s) const {
    const float x = fmaf(__int_as_float(s + 0x4B400000), scale_log2, magic_bias);
    return ex2_ftz(fminf(fmaxf(x, -kClampLog2), kClampLog2));
  }
  // One score tile (this warp's 16 rows x 64 keys): p, its f32 row sums into l,
  // and p packed in pairs as the A fragments of the P V product.
  __device__ __forceinline__ void exp_pack(const int (&s)[kTileRows / 2], float l[2],
                                           uint32_t (&p)[kTileRows / 4]) const {
#pragma unroll
    for (int i = 0; i < kTileRows / 4; ++i) {  // pair i: row g + 8 * (i & 1)
      const float x0 = to_exp(s[2 * i]), x1 = to_exp(s[2 * i + 1]);
      l[i & 1] += x0 + x1;
      p[i] = Mma<T>::pack(x0, x1);
    }
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWgThreads)
    flash_fwd_qk_i8_wgmma_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                                 const T* __restrict__ v, const float* __restrict__ qk_scale,
                                 T* __restrict__ o, int n, int heads_per_scale) {
  const size_t head = (size_t)blockIdx.y * n * G;
  const size_t row0 = (size_t)blockIdx.x * kTileRows * G;
  const float scale_log2 = qk_scale[blockIdx.y / heads_per_scale] * kLog2e;
  QkI8Policy<T, D, G> policy{q8 + head + row0, k8 + head, scale_log2, -12582912.f * scale_log2};
  flash_forward_loop<T, D, QkI8Policy<T, D, G>, G>(policy, v + head, o + head + row0, nullptr, n);
}

template <typename T, int D, int G = D>
cudaError_t launch_i8(const int8_t* q8, const int8_t* k8, const void* v, const float* qk_scale, void* o,
                      int bh, int n, int heads_per_scale, cudaStream_t stream) {
  constexpr int smem = fwd_loop_smem_bytes<T, D, QkI8Policy<T, D, G>>();
  static_assert(smem <= 232448, "a block's shared memory");
  auto kernel = flash_fwd_qk_i8_wgmma_kernel<T, D, G>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n / kTileRows, bh), kWgThreads, smem, stream>>>(q8, k8, static_cast<const T*>(v), qk_scale,
                                                               static_cast<T*>(o), n, heads_per_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_i8(const int8_t* q8, const int8_t* k8, const void* v, const float* qk_scale, void* o,
                        int bh, int n, int d, int hps, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_i8<T, 16>(q8, k8, v, qk_scale, o, bh, n, hps, stream);
    case 24: return launch_i8<T, 32, 24>(q8, k8, v, qk_scale, o, bh, n, hps, stream);
    case 32: return launch_i8<T, 32>(q8, k8, v, qk_scale, o, bh, n, hps, stream);
    case 64: return launch_i8<T, 64>(q8, k8, v, qk_scale, o, bh, n, hps, stream);
    case 128: return launch_i8<T, 128>(q8, k8, v, qk_scale, o, bh, n, hps, stream);
    case 192: return launch_i8<T, 192>(q8, k8, v, qk_scale, o, bh, n, hps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wcflash

// q8, k8: contiguous int8 (bh, n, d); v, o: contiguous (bh, n, d) in bf16
// (is_f16 = 0) or f16 (is_f16 = 1); qk_scale: bh / heads_per_scale f32 on the
// device, qs * ks * d^-1/2 each (heads_per_scale = bh: one scale; = h: one a
// batch row). Returns the cudaError_t of the launch.
extern "C" int wc_flash_fwd_qk_i8(const void* q8, const void* k8, const void* v, const float* qk_scale,
                                  void* o, int bh, int n, int d, int is_f16, int heads_per_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || n % wcflash::kTileRows != 0 || heads_per_scale <= 0 ||
      bh % heads_per_scale != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* q = static_cast<const int8_t*>(q8);
  const int8_t* k = static_cast<const int8_t*>(k8);
  return is_f16 ? wcflash::dispatch_i8<__half>(q, k, v, qk_scale, o, bh, n, d, heads_per_scale, s)
                : wcflash::dispatch_i8<__nv_bfloat16>(q, k, v, qk_scale, o, bh, n, d, heads_per_scale, s);
}
